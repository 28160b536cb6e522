"""The soft-prefix VLM's vision side (LLaVA-1.5): an image becomes soft
prompt tokens for the engine.

Port of ``scalable_hw_agnostic_inference_tpu/models/vlm.py``:
``VisionTowerConfig`` and ``VisionProjector`` as an ``nn.Module``, with
the converters :func:`params_from_jax` (the JAX package's flax tree) and
:func:`state_from_hf` (the HF ``LlavaForConditionalGeneration`` names,
the reference's ``params_from_torch`` at ``:132``, both key layouts).

A CLIP vision tower (class token, learned positions, pre-LN blocks,
quick-GELU) gives its hidden state at ``feature_layer``; CLS is dropped
and a 2-layer exact-GELU projector maps each patch into the language
model's embedding space. The engine prepends the result to the prompt
(``engine.runner.make_prefill``'s ``prefix_len``). The patch embedding
(a stride-``patch`` convolution without bias) is the same sum written as
one matrix product over each patch's pixels, NHWC, patches row-major.

The reference runs every block and keeps ``hidden[feature_layer]``; the
port stops after the block that produces that state (23 of CLIP-L's 24
for LLaVA's ``-2``): the output is the same tensor. The last block's
weights are still held, so that the state maps one to one onto the
reference's tree and the HF checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from .encoder import ACTIVATIONS, Dense, Encoder, LayerNorm, param
from .llama import _to_torch


@dataclasses.dataclass(frozen=True)
class VisionTowerConfig:
    image_size: int = 336          # llava-1.5 (CLIP-L/14-336)
    patch_size: int = 14
    dim: int = 1024
    n_layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    lm_dim: int = 4096             # the language model's embedding width
    ln_eps: float = 1e-5
    act: str = "quick_gelu"        # CLIP's activation
    # HF ``vision_feature_layer``: hidden state -2 is the output of the
    # second-to-last block; CLS dropped ("default" select strategy)
    feature_layer: int = -2

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_blocks(self) -> int:
        """The blocks run to reach ``hidden[feature_layer]``."""
        fl = self.feature_layer
        n = fl if fl >= 0 else self.n_layers + 1 + fl
        if not 0 <= n <= self.n_layers:
            raise ValueError(f"feature_layer {fl} out of range for "
                             f"{self.n_layers} layers")
        return n

    @classmethod
    def tiny(cls, lm_dim: int = 64) -> "VisionTowerConfig":
        return cls(image_size=32, patch_size=8, dim=32, n_layers=2, heads=2,
                   mlp_dim=64, lm_dim=lm_dim)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any], lm_dim: int) -> "VisionTowerConfig":
        """From an HF LLaVA ``config.json`` (a dict whose ``vision_config``
        is a dict, ``transformers``' defaults filled in:
        ``models.convert.llava_configs``)."""
        strategy = hf.get("vision_feature_select_strategy", "default")
        if strategy != "default":
            raise ValueError(
                f"vision_feature_select_strategy={strategy!r} not supported "
                "(only 'default', which drops CLS)")
        layer = hf.get("vision_feature_layer", -2)
        if not isinstance(layer, int):
            raise ValueError(f"vision_feature_layer={layer!r} not supported "
                             f"(one layer index only)")
        v = hf.get("vision_config", hf)
        act = v.get("hidden_act", "quick_gelu")
        if act not in ACTIVATIONS:
            raise ValueError(f"vision_config hidden_act={act!r} not supported "
                             f"(only {', '.join(ACTIVATIONS)})")
        return cls(
            image_size=v["image_size"], patch_size=v["patch_size"],
            dim=v["hidden_size"], n_layers=v["num_hidden_layers"],
            heads=v["num_attention_heads"], mlp_dim=v["intermediate_size"],
            lm_dim=lm_dim, ln_eps=v.get("layer_norm_eps", 1e-5),
            act=act, feature_layer=layer)


class VisionProjector(nn.Module):
    """pixels ``[B, H, W, 3]`` (NHWC, normalized) -> soft prompt tokens
    ``[B, n_patches, lm_dim]`` f32: HF LLaVA's ``get_image_features(...,
    vision_feature_select_strategy="default")``. ``device`` defaults to
    the card; ``"cpu"`` for the CPU."""

    def __init__(self, cfg: VisionTowerConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        c, pd = cfg, param_dtype
        # the convolution's weight in the HF layout [dim, 3, p, p]
        self.patch = nn.Module()
        self.patch.weight = param((c.dim, 3, c.patch_size, c.patch_size), pd,
                                  device)
        self.cls = param((c.dim,), pd, device)
        self.pos = param((c.n_patches + 1, c.dim), pd, device)
        self.pre_ln = LayerNorm(c.dim, c.ln_eps, pd, device)
        self.tower = Encoder(c.n_layers, c.dim, c.heads, c.mlp_dim,
                             act=c.act, ln_eps=c.ln_eps,
                             dtype=dtype, param_dtype=pd, device=device)
        self.proj1 = Dense(c.dim, c.lm_dim, True, pd, device)
        self.proj2 = Dense(c.lm_dim, c.lm_dim, True, pd, device)

    @property
    def device(self) -> torch.device:
        return self.cls.device

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        p = c.patch_size
        B, H, W, C = pixels.shape
        if H != c.image_size or W != c.image_size or C != 3:
            raise ValueError(f"pixels {tuple(pixels.shape)}: the tower takes "
                             f"[B, {c.image_size}, {c.image_size}, 3]")
        x = pixels.to(dt).reshape(B, H // p, p, W // p, p, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, c.n_patches, p * p * C)
        w = self.patch.weight.to(dt).permute(0, 2, 3, 1).reshape(c.dim,
                                                                 p * p * C)
        x = nn.functional.linear(x, w)
        x = torch.cat([self.cls.to(dt).expand(B, 1, c.dim), x], dim=1)
        x = self.pre_ln(x + self.pos.to(dt), dt)
        x = self.tower(x, n_blocks=c.n_blocks)
        x = x[:, 1:]                        # drop CLS
        x = self.proj2(nn.functional.gelu(self.proj1(x)))
        return x.float()


# -- weights -------------------------------------------------------------------

_BLOCK = ("attn.q", "attn.k", "attn.v", "attn.o", "ln1", "ln2", "fc1",
          "fc2")


def weight_shapes(cfg: VisionTowerConfig) -> Dict[str, Tuple[int, ...]]:
    """Every weight of :class:`VisionProjector`'s state dict, with its
    shape."""
    c = cfg
    d = c.dim
    out: Dict[str, Tuple[int, ...]] = {
        "patch.weight": (d, 3, c.patch_size, c.patch_size),
        "cls": (d,), "pos": (c.n_patches + 1, d),
        "pre_ln.weight": (d,), "pre_ln.bias": (d,),
        "proj1.weight": (c.lm_dim, d), "proj1.bias": (c.lm_dim,),
        "proj2.weight": (c.lm_dim, c.lm_dim), "proj2.bias": (c.lm_dim,),
    }
    for i in range(c.n_layers):
        pre = f"tower.layer_{i}"
        for n in ("attn.q", "attn.k", "attn.v", "attn.o"):
            out[f"{pre}.{n}.weight"] = (d, d)
            out[f"{pre}.{n}.bias"] = (d,)
        for n in ("ln1", "ln2"):
            out[f"{pre}.{n}.weight"] = (d,)
            out[f"{pre}.{n}.bias"] = (d,)
        out[f"{pre}.fc1.weight"] = (c.mlp_dim, d)
        out[f"{pre}.fc1.bias"] = (c.mlp_dim,)
        out[f"{pre}.fc2.weight"] = (d, c.mlp_dim)
        out[f"{pre}.fc2.bias"] = (d,)
    return out


def build(cfg: VisionTowerConfig, state: Dict[str, torch.Tensor],
          dtype=torch.bfloat16) -> VisionProjector:
    """The tower and projector around ``state`` (no second copy: built on
    the meta device, the tensors assigned), computing in ``dtype``."""
    vm = VisionProjector(cfg, dtype=dtype, device="meta")
    vm.load_state_dict(state, assign=True, strict=True)
    return vm


def random_params(cfg: VisionTowerConfig, seed: int, std: float = 0.02,
                  dtype=torch.bfloat16, device: DeviceLike = None
                  ) -> Dict[str, torch.Tensor]:
    """Seeded random weights on ``device`` (the card unless the caller
    asks for the CPU): N(0, std) matrices, embeddings and biases, unit
    LayerNorm scales."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in weight_shapes(cfg).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        if name.endswith("weight") and ("ln" in name.split(".")[-2]):
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=gen)
        out[name] = t
    return out


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of ``VisionProjector``
    (numpy leaves) -> this module's state dict: the HWIO patch kernel
    ``[p, p, 3, dim]`` to ``[dim, 3, p, p]``, each ``[in, out]`` dense
    kernel transposed, ``scale`` to ``weight``."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {
        "patch.weight": _to_torch(p["patch"]["kernel"]).permute(
            3, 2, 0, 1).contiguous(),
        "cls": _to_torch(p["cls"]).reshape(-1),
        "pos": _to_torch(p["pos"])[0],
    }

    def dense(stem, leaf):
        sd[f"{stem}.weight"] = _to_torch(leaf["kernel"]).T.contiguous()
        sd[f"{stem}.bias"] = _to_torch(leaf["bias"])

    def ln(stem, leaf):
        sd[f"{stem}.weight"] = _to_torch(leaf["scale"])
        sd[f"{stem}.bias"] = _to_torch(leaf["bias"])

    ln("pre_ln", p["pre_ln"])
    dense("proj1", p["proj1"])
    dense("proj2", p["proj2"])
    for name, b in p["tower"].items():
        pre = f"tower.{name}"
        for n in ("q", "k", "v", "o"):
            dense(f"{pre}.attn.{n}", b["attn"][n])
        dense(f"{pre}.fc1", b["fc1"])
        dense(f"{pre}.fc2", b["fc2"])
        ln(f"{pre}.ln1", b["ln1"])
        ln(f"{pre}.ln2", b["ln2"])
    return sd


def hf_names(cfg: VisionTowerConfig, vt: str = "vision_tower.vision_model",
             mp: str = "multi_modal_projector") -> Dict[str, str]:
    """This module's state name -> the HF LLaVA checkpoint's, under the
    CLIP prefix ``vt`` and the projector prefix ``mp``."""
    out = {
        "patch.weight": f"{vt}.embeddings.patch_embedding.weight",
        "cls": f"{vt}.embeddings.class_embedding",
        "pos": f"{vt}.embeddings.position_embedding.weight",
        # HF CLIP's historical spelling "pre_layrnorm" is the real key
        "pre_ln.weight": f"{vt}.pre_layrnorm.weight",
        "pre_ln.bias": f"{vt}.pre_layrnorm.bias",
    }
    for n in (1, 2):
        for leaf in ("weight", "bias"):
            out[f"proj{n}.{leaf}"] = f"{mp}.linear_{n}.{leaf}"
    hf = {"attn.q": "self_attn.q_proj", "attn.k": "self_attn.k_proj",
          "attn.v": "self_attn.v_proj", "attn.o": "self_attn.out_proj",
          "ln1": "layer_norm1", "ln2": "layer_norm2", "fc1": "mlp.fc1",
          "fc2": "mlp.fc2"}
    for i in range(cfg.n_layers):
        for n in _BLOCK:
            for leaf in ("weight", "bias"):
                out[f"tower.layer_{i}.{n}.{leaf}"] = (
                    f"{vt}.encoder.layers.{i}.{hf[n]}.{leaf}")
    return out


def state_from_hf(get, has, cfg: VisionTowerConfig
                  ) -> Dict[str, torch.Tensor]:
    """The tower and projector state from an HF LLaVA checkpoint:
    ``get(name)`` returns its tensor, ``has(name)`` says whether it is
    there. Both layouts are read, as the reference reads them:
    ``vision_tower.vision_model.*`` with ``multi_modal_projector.*``, or
    the same under ``model.``; ``pre_layrnorm`` or ``pre_layernorm``."""
    vt = "vision_tower.vision_model"
    if not has(f"{vt}.embeddings.class_embedding"):
        vt = "model.vision_tower.vision_model"
    mp = ("multi_modal_projector"
          if has("multi_modal_projector.linear_1.weight")
          else "model.multi_modal_projector")
    shapes = weight_shapes(cfg)
    out = {}
    for name, src in hf_names(cfg, vt, mp).items():
        if not has(src) and "pre_layrnorm" in src:
            src = src.replace("pre_layrnorm", "pre_layernorm")
        if not has(src):
            raise ValueError(f"LLaVA checkpoint has no {src!r} (for {name})")
        t = get(src)
        if t.numel() != math.prod(shapes[name]):
            raise ValueError(f"{src!r} has {t.numel()} values, the config "
                             f"makes {name} {shapes[name]}")
        out[name] = t.reshape(shapes[name])
    return out
