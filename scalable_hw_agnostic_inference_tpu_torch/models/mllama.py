"""Mllama (Llama-3.2-Vision): the tiled vision encoder, the projector,
image tiling and the vision side of the checkpoint.

Port of ``scalable_hw_agnostic_inference_tpu/models/mllama.py``:
``MllamaVisionConfig`` (``:43``), ``MllamaVisionModel`` (``:131``) and
``MllamaProjector`` (``:216``) as ``nn.Module`` classes, ``optimal_canvas``,
``fit_to_canvas`` and ``preprocess_tiled`` (``:240-301``, over an ``[H, W,
3]`` uint8 array instead of a PIL image, resized by
``models.imageio.resize_bilinear``, Pillow's own filter), and the
converters: :func:`vision_params_from_jax` (the JAX package's flax trees)
and :func:`vision_state_from_hf` (the HF checkpoint's names, the
reference's ``vision_params_from_torch`` at ``:326``).

The numerics are the reference's (``:96-213``), which are HF's
``MllamaVisionModel``'s: LayerNorms in fp32, the patch axis padded to a
multiple of 8 (1,601 -> 1,608 at 560 px), the outer-product mask (a pair
of tokens is masked only when BOTH are invalid), hidden state ``i`` the
output of local layer ``i``, intermediates concatenated feature-major, and
the gated global stage. Attention is a plain einsum and softmax with fp32
scores, as the reference computes it outside any kernel: at Llama-3.2-11B-
Vision's size the scores of one layer are ``[16, 6432, 6432]`` f32, 2.65 GB,
transient. The patch embedding (a stride-``patch`` convolution) is the
same sum written as one matrix product over each patch's pixels.

Parameters are held in ``param_dtype`` and cast to the compute ``dtype`` at
use, as flax casts them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from .encoder import Dense as _Linear
from .encoder import LayerNorm as _LayerNorm
from .encoder import param as _param
from .imageio import resize_bilinear
from .llama import _to_torch

#: the additive mask value of a masked pair (the reference's
#: ``jnp.finfo(jnp.float32).min``)
NEG_INF = float(np.finfo(np.float32).min)

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class MllamaVisionConfig:
    image_size: int = 560
    patch_size: int = 14
    dim: int = 1280                 # hidden_size
    n_layers: int = 32              # local transformer
    n_global_layers: int = 8
    heads: int = 16
    mlp_dim: int = 5120             # intermediate_size
    max_num_tiles: int = 4
    max_aspect_ratio_id: int = 8
    intermediate_layers_indices: Tuple[int, ...] = (3, 7, 15, 23, 30)
    norm_eps: float = 1e-5

    def __post_init__(self):
        if not isinstance(self.intermediate_layers_indices, tuple):
            object.__setattr__(self, "intermediate_layers_indices",
                               tuple(self.intermediate_layers_indices))

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def output_dim(self) -> int:
        # the final hidden state and one slice per collected layer
        return self.dim * (1 + len(self.intermediate_layers_indices))

    @property
    def cross_seq_len(self) -> int:
        """Lv: the vision states of a full image, tiles x (patches + 1)."""
        return self.max_num_tiles * (self.n_patches + 1)

    @classmethod
    def tiny(cls) -> "MllamaVisionConfig":
        return cls(image_size=32, patch_size=8, dim=32, n_layers=3,
                   n_global_layers=2, heads=2, mlp_dim=64, max_num_tiles=2,
                   max_aspect_ratio_id=3, intermediate_layers_indices=(1,))

    @classmethod
    def from_hf(cls, v) -> "MllamaVisionConfig":
        """From an HF ``MllamaVisionConfig`` (or its ``config.json`` dict
        as a namespace: ``attention_heads`` or ``num_attention_heads``)."""
        heads = getattr(v, "attention_heads", None)
        if heads is None:
            heads = v.num_attention_heads
        return cls(
            image_size=v.image_size,
            patch_size=v.patch_size,
            dim=v.hidden_size,
            n_layers=v.num_hidden_layers,
            n_global_layers=v.num_global_layers,
            heads=heads,
            mlp_dim=v.intermediate_size,
            max_num_tiles=v.max_num_tiles,
            max_aspect_ratio_id=getattr(
                v, "max_aspect_ratio_id",
                len(v.supported_aspect_ratios)),
            intermediate_layers_indices=tuple(v.intermediate_layers_indices),
            norm_eps=getattr(v, "norm_eps", 1e-5),
        )


class _VisionBlock(nn.Module):
    """Pre-LN encoder block; ``gated`` adds tanh gates on both residuals
    (the global stage)."""

    def __init__(self, cfg: MllamaVisionConfig, gated: bool, dtype,
                 param_dtype, device):
        super().__init__()
        self.cfg, self.dtype, self.gated = cfg, dtype, gated
        d, pd = cfg.dim, param_dtype
        self.ln1 = _LayerNorm(d, cfg.norm_eps, pd, device)
        self.q = _Linear(d, d, False, pd, device)
        self.k = _Linear(d, d, False, pd, device)
        self.v = _Linear(d, d, False, pd, device)
        self.o = _Linear(d, d, False, pd, device)
        self.ln2 = _LayerNorm(d, cfg.norm_eps, pd, device)
        self.fc1 = _Linear(d, cfg.mlp_dim, True, pd, device)
        self.fc2 = _Linear(cfg.mlp_dim, d, True, pd, device)
        if gated:
            self.gate_attn = _param((1,), pd, device, math.pi / 4)
            self.gate_mlp = _param((1,), pd, device, math.pi / 4)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor
                ) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        dh = c.dim // c.heads
        h = self.ln1(x, dt)
        B, L, _ = h.shape
        q = self.q(h).reshape(B, L, c.heads, dh)
        k = self.k(h).reshape(B, L, c.heads, dh)
        v = self.v(h).reshape(B, L, c.heads, dh)
        # fp32 scores (the reference's preferred_element_type), the mask
        # added in place, probabilities cast back before the second product
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        s.div_(math.sqrt(dh)).add_(mask_bias)
        p = torch.softmax(s, dim=-1)
        del s
        p = p.to(v.dtype)
        o = torch.einsum("bhts,bshd->bthd", p, v).reshape(B, L, c.dim)
        del p
        o = self.o(o)
        if self.gated:
            o = torch.tanh(self.gate_attn.to(o.dtype)) * o
        x = x + o
        h = self.ln2(x, dt)
        h = self.fc2(nn.functional.gelu(self.fc1(h)))
        if self.gated:
            h = torch.tanh(self.gate_mlp.to(h.dtype)) * h
        return x + h


class MllamaVisionModel(nn.Module):
    """pixels ``[B, tiles, H, W, 3]`` (NHWC) with aspect ratio ids ``[B]``
    and masks ``[B, tiles]`` -> vision features ``[B, tiles, patches + 1,
    output_dim]``. ``device`` defaults to the card; ``"cpu"`` for the
    CPU."""

    def __init__(self, cfg: MllamaVisionConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        c, pd = cfg, param_dtype
        P1 = c.n_patches + 1
        A = c.max_aspect_ratio_id + 1
        # the convolution's weight in the HF layout [dim, 3, p, p]
        self.patch = nn.Module()
        self.patch.weight = _param((c.dim, 3, c.patch_size, c.patch_size),
                                   pd, device)
        self.pre_tile_emb = _param((A, c.max_num_tiles, c.dim), pd, device)
        self.pre_tile_gate = _param((1,), pd, device)
        self.cls = _param((c.dim,), pd, device)
        self.pos = _param((P1, c.dim), pd, device)
        self.pos_gate = _param((1,), pd, device)
        self.tile_pos_emb = _param((A, c.max_num_tiles, P1, c.dim), pd,
                                   device)
        self.ln_pre = _LayerNorm(c.dim, c.norm_eps, pd, device)
        self.layers = nn.ModuleList(
            _VisionBlock(c, False, dtype, pd, device)
            for _ in range(c.n_layers))
        self.ln_post = _LayerNorm(c.dim, c.norm_eps, pd, device)
        self.post_tile_emb = _param((A, c.max_num_tiles, c.dim), pd, device)
        self.post_tile_gate = _param((1,), pd, device)
        self.globals = nn.ModuleList(
            _VisionBlock(c, True, dtype, pd, device)
            for _ in range(c.n_global_layers))

    @property
    def device(self) -> torch.device:
        return self.cls.device

    def _patches(self, pixels: torch.Tensor) -> torch.Tensor:
        """The stride-``p`` convolution as one product: ``[N, H, W, 3]``
        -> ``[N, (H/p) * (W/p), dim]``, patches row-major."""
        p = self.cfg.patch_size
        N, H, W, C = pixels.shape
        x = pixels.reshape(N, H // p, p, W // p, p, C).permute(
            0, 1, 3, 2, 4, 5).reshape(N, (H // p) * (W // p), p * p * C)
        w = self.patch.weight.to(x.dtype).permute(0, 2, 3, 1).reshape(
            self.cfg.dim, p * p * C)
        return nn.functional.linear(x, w)

    def forward(self, pixels: torch.Tensor, aspect_ratio_ids: torch.Tensor,
                aspect_ratio_mask: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        B, T, H, W, _ = pixels.shape
        P = c.n_patches
        ar = aspect_ratio_ids.long()
        x = self._patches(pixels.reshape(B * T, H, W, 3).to(dt))
        x = x.reshape(B, T, P, c.dim)
        # the pre-tile positional embedding, gated, by aspect ratio
        x = x + (torch.tanh(self.pre_tile_gate.to(dt))
                 * self.pre_tile_emb.to(dt)[ar])[:, :, None, :]
        # a class token per tile
        cls = self.cls.to(dt).expand(B, T, 1, c.dim)
        x = torch.cat([cls, x], dim=2)
        P1 = P + 1
        # the gated position embedding: per patch and per tile
        g = torch.tanh(self.pos_gate.to(dt))
        x = x + (1.0 - g) * self.pos.to(dt)[None, None]
        x = x + g * self.tile_pos_emb.to(dt)[ar]
        x = self.ln_pre(x, dt)
        # the patch axis padded to a multiple of 8 (HF does the same)
        pad = (8 - P1 % 8) % 8
        if pad:
            x = nn.functional.pad(x, (0, 0, 0, pad))
        Pp = P1 + pad
        L = T * Pp
        # a token is invalid when its tile is masked or it is padding; a
        # PAIR is masked only when both its ends are invalid
        inv = (1.0 - aspect_ratio_mask.float())[:, :, None].expand(
            B, T, Pp).clone()
        if pad:
            inv[:, :, -pad:] = 1.0
        inv = inv.reshape(B, L, 1)
        mask_bias = (inv @ inv.transpose(1, 2) * NEG_INF)[:, None]
        x = x.reshape(B, L, c.dim)
        # hidden state i is the OUTPUT of local layer i; only the collected
        # ones are kept
        keep = set(c.intermediate_layers_indices)
        hidden: Dict[int, torch.Tensor] = {}
        for i, layer in enumerate(self.layers):
            x = layer(x, mask_bias)
            if i in keep:
                hidden[i] = x
        x = self.ln_post(x, dt)
        # the post-tile embedding, then the gated global transformer
        x = x.reshape(B, T, Pp, c.dim)
        x = x + (torch.tanh(self.post_tile_gate.to(dt))
                 * self.post_tile_emb.to(dt)[ar])[:, :, None, :]
        x = x.reshape(B, L, c.dim)
        for layer in self.globals:
            x = layer(x, mask_bias)
        del mask_bias
        # strip the padding, concatenate the final and collected features
        x = x.reshape(B, T, Pp, c.dim)[:, :, :P1]
        inter = torch.stack([hidden[i] for i in c.intermediate_layers_indices],
                            dim=-1)                       # [B, L, dim, k]
        inter = inter.reshape(B, T, Pp, -1)[:, :, :P1]
        return torch.cat([x, inter], dim=-1)


class MllamaProjector(nn.Module):
    """Vision features ``[B, T, P1, output_dim]`` -> cross-attention
    states ``[B, T * P1, text_dim]`` (HF's ``multi_modal_projector``)."""

    def __init__(self, cfg: MllamaVisionConfig, text_dim: int,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.dtype = dtype
        self.text_dim = text_dim
        self.proj = _Linear(cfg.output_dim, text_dim, True, param_dtype,
                            device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        B, T, P1, _ = feats.shape
        x = self.proj(feats.to(self.dtype))
        return x.reshape(B, T * P1, self.text_dim)


# -- image preprocessing (HF MllamaImageProcessor's tiling) -------------------


def optimal_canvas(h: int, w: int, supported, tile: int):
    """HF ``get_optimal_tiled_canvas``: the smallest upscale if one exists,
    else the least downscale; ties broken by the least area."""
    grids = np.array(supported)
    canvases = grids * tile
    scales = np.minimum(canvases[:, 0] / h, canvases[:, 1] / w)
    up = scales[scales >= 1]
    sel = np.min(up) if len(up) else np.max(scales[scales < 1])
    cands = canvases[scales == sel]
    areas = cands[:, 0] * cands[:, 1]
    return tuple(int(x) for x in cands[int(np.argmin(areas))])


def fit_to_canvas(h: int, w: int, ch: int, cw: int, tile: int):
    """HF ``get_image_size_fit_to_canvas`` (aspect-preserving)."""
    th = min(max(h, tile), ch)
    tw = min(max(w, tile), cw)
    scale_h, scale_w = th / h, tw / w
    if scale_w < scale_h:
        return min(math.floor(h * scale_w) or 1, th), tw
    return th, min(math.floor(w * scale_h) or 1, tw)


def preprocess_tiled(img: np.ndarray, cfg: MllamaVisionConfig, supported,
                     mean=CLIP_MEAN, std=CLIP_STD):
    """``[H, W, 3]`` uint8 RGB -> (tiles ``[max_num_tiles, ts, ts, 3]``
    f32, normalized, zero-padded, NHWC; aspect ratio id; valid tiles).

    The reference's steps: the canvas, the aspect-preserving resize
    (Pillow's bilinear filter, ``models.imageio.resize_bilinear``),
    rescale, the raw canvas padded with zeros and THEN normalized (padding
    lands at ``-mean / std``), split into row-major tiles, the tile axis
    padded to ``max_num_tiles``.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("preprocess_tiled takes an [H, W, 3] uint8 array")
    ts = cfg.image_size
    h, w = img.shape[:2]
    ch, cw = optimal_canvas(h, w, supported, ts)
    nh, nw = fit_to_canvas(h, w, ch, cw, ts)
    arr = resize_bilinear(img, nh, nw).astype(np.float32) / 255.0
    canvas = np.zeros((ch, cw, 3), np.float32)
    canvas[:nh, :nw] = arr
    canvas = (canvas - np.asarray(mean, np.float32)) / np.asarray(
        std, np.float32)
    th, tw = ch // ts, cw // ts
    tiles = canvas.reshape(th, ts, tw, ts, 3).transpose(0, 2, 1, 3, 4)
    tiles = tiles.reshape(th * tw, ts, ts, 3)
    out = np.zeros((cfg.max_num_tiles, ts, ts, 3), np.float32)
    out[: th * tw] = tiles
    ar_id = [list(map(int, g)) for g in supported].index([th, tw]) + 1
    return out, ar_id, th * tw


def random_image(cfg: MllamaVisionConfig) -> np.ndarray:
    """The ``image_b64: "random"`` image, the reference's contract:
    ``default_rng(0).integers(0, 255, (size, size, 3), uint8)``."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, (cfg.image_size, cfg.image_size, 3),
                        np.uint8)


# -- weights -------------------------------------------------------------------


def vision_weight_shapes(cfg: MllamaVisionConfig, text_dim: int
                         ) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the vision model's state dict (``vision.`` names)
    and the projector's (``proj.``), with their shapes."""
    c = cfg
    P1, A = c.n_patches + 1, c.max_aspect_ratio_id + 1
    d = c.dim
    out: Dict[str, Tuple[int, ...]] = {
        "vision.patch.weight": (d, 3, c.patch_size, c.patch_size),
        "vision.pre_tile_emb": (A, c.max_num_tiles, d),
        "vision.pre_tile_gate": (1,), "vision.cls": (d,),
        "vision.pos": (P1, d), "vision.pos_gate": (1,),
        "vision.tile_pos_emb": (A, c.max_num_tiles, P1, d),
        "vision.ln_pre.weight": (d,), "vision.ln_pre.bias": (d,),
        "vision.ln_post.weight": (d,), "vision.ln_post.bias": (d,),
        "vision.post_tile_emb": (A, c.max_num_tiles, d),
        "vision.post_tile_gate": (1,),
        "proj.proj.weight": (text_dim, c.output_dim),
        "proj.proj.bias": (text_dim,),
    }
    blocks = [f"layers.{i}" for i in range(c.n_layers)] + [
        f"globals.{i}" for i in range(c.n_global_layers)]
    for b in blocks:
        pre = f"vision.{b}"
        for n in ("q", "k", "v", "o"):
            out[f"{pre}.{n}.weight"] = (d, d)
        for n in ("ln1", "ln2"):
            out[f"{pre}.{n}.weight"] = (d,)
            out[f"{pre}.{n}.bias"] = (d,)
        out[f"{pre}.fc1.weight"] = (c.mlp_dim, d)
        out[f"{pre}.fc1.bias"] = (c.mlp_dim,)
        out[f"{pre}.fc2.weight"] = (d, c.mlp_dim)
        out[f"{pre}.fc2.bias"] = (d,)
        if b.startswith("globals"):
            out[f"{pre}.gate_attn"] = (1,)
            out[f"{pre}.gate_mlp"] = (1,)
    return out


def build_vision(cfg: MllamaVisionConfig, text_dim: int,
                 state: Dict[str, torch.Tensor], dtype=torch.bfloat16
                 ) -> Tuple[MllamaVisionModel, MllamaProjector]:
    """The vision model and the projector around ``state`` (no second
    copy: built on the meta device, the tensors assigned)."""
    vis = {k[len("vision."):]: v for k, v in state.items()
           if k.startswith("vision.")}
    proj = {k[len("proj."):]: v for k, v in state.items()
            if k.startswith("proj.")}
    vm = MllamaVisionModel(cfg, dtype=dtype, device="meta")
    vm.load_state_dict(vis, assign=True, strict=True)
    pm = MllamaProjector(cfg, text_dim, dtype=dtype, device="meta")
    pm.load_state_dict(proj, assign=True, strict=True)
    return vm, pm


def random_vision_params(cfg: MllamaVisionConfig, text_dim: int, seed: int,
                         std: float = 0.02, dtype=torch.bfloat16,
                         device: DeviceLike = None
                         ) -> Dict[str, torch.Tensor]:
    """Seeded random vision and projector weights on ``device`` (the card
    unless the caller asks for the CPU): N(0, std) matrices, embeddings and
    biases, unit LayerNorm scales, and every tanh gate drawn from U(0.5,
    1.5), so that the tile and position embeddings and the global stage
    all take part."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in vision_weight_shapes(cfg, text_dim).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if "gate" in leaf:
            t.uniform_(0.5, 1.5, generator=gen)
        elif leaf == "weight" and (".ln" in name):
            t.fill_(1.0)
        else:
            t.normal_(0.0, std, generator=gen)
        out[name] = t
    return out


def _dense_from_jax(stem: str, leaf: Dict[str, Any]
                    ) -> Dict[str, torch.Tensor]:
    out = {f"{stem}.weight": _to_torch(leaf["kernel"]).T.contiguous()}
    if "bias" in leaf:
        out[f"{stem}.bias"] = _to_torch(leaf["bias"])
    return out


def _ln_from_jax(stem: str, leaf: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{stem}.weight": _to_torch(leaf["scale"]),
            f"{stem}.bias": _to_torch(leaf["bias"])}


def vision_params_from_jax(vparams: Dict[str, Any], pparams: Dict[str, Any],
                           cfg: MllamaVisionConfig
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``({"params": vision}, {"params": projector})``
    trees (numpy leaves) -> the combined ``vision.``/``proj.`` state
    dict."""
    v = vparams["params"]
    kern = _to_torch(v["patch"]["kernel"])            # [p, p, 3, dim]
    sd: Dict[str, torch.Tensor] = {
        "vision.patch.weight": kern.permute(3, 2, 0, 1).contiguous()}
    for name in ("cls", "pos", "pos_gate", "tile_pos_emb", "pre_tile_emb",
                 "pre_tile_gate", "post_tile_emb", "post_tile_gate"):
        sd[f"vision.{name}"] = _to_torch(v[name])
    sd.update(_ln_from_jax("vision.ln_pre", v["ln_pre"]))
    sd.update(_ln_from_jax("vision.ln_post", v["ln_post"]))
    blocks = [(f"layer_{i}", f"layers.{i}") for i in range(cfg.n_layers)] + [
        (f"global_{i}", f"globals.{i}") for i in range(cfg.n_global_layers)]
    for src, dst in blocks:
        b = v[src]
        pre = f"vision.{dst}"
        for n in ("q", "k", "v", "o", "fc1", "fc2"):
            sd.update(_dense_from_jax(f"{pre}.{n}", b[n]))
        for n in ("ln1", "ln2"):
            sd.update(_ln_from_jax(f"{pre}.{n}", b[n]))
        for n in ("gate_attn", "gate_mlp"):
            if n in b:
                sd[f"{pre}.{n}"] = _to_torch(b[n]).reshape(1)
    sd.update(_dense_from_jax("proj.proj", pparams["params"]["proj"]))
    return sd


def vision_hf_names(cfg: MllamaVisionConfig, vm: str = "vision_model",
                    mp: str = "multi_modal_projector") -> Dict[str, str]:
    """Port ``vision.``/``proj.`` name -> the HF checkpoint's name, under
    the vision model prefix ``vm`` and the projector prefix ``mp`` (the
    two layouts: ``vision_model`` / ``multi_modal_projector``, or the same
    under ``model.``)."""
    g = f"{vm}.gated_positional_embedding"
    out = {
        "vision.patch.weight": f"{vm}.patch_embedding.weight",
        "vision.cls": f"{vm}.class_embedding",
        "vision.pos": f"{g}.embedding",
        "vision.pos_gate": f"{g}.gate",
        "vision.tile_pos_emb": f"{g}.tile_embedding.weight",
        "vision.pre_tile_emb":
            f"{vm}.pre_tile_positional_embedding.embedding.weight",
        "vision.pre_tile_gate": f"{vm}.pre_tile_positional_embedding.gate",
        "vision.post_tile_emb":
            f"{vm}.post_tile_positional_embedding.embedding.weight",
        "vision.post_tile_gate": f"{vm}.post_tile_positional_embedding.gate",
        "proj.proj.weight": f"{mp}.weight",
        "proj.proj.bias": f"{mp}.bias",
    }
    for n in ("pre", "post"):
        for leaf in ("weight", "bias"):
            out[f"vision.ln_{n}.{leaf}"] = f"{vm}.layernorm_{n}.{leaf}"
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.o_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2",
             "ln1": "input_layernorm", "ln2": "post_attention_layernorm"}
    stacks = [(f"layers.{i}", f"{vm}.transformer.layers.{i}")
              for i in range(cfg.n_layers)] + [
        (f"globals.{i}", f"{vm}.global_transformer.layers.{i}")
        for i in range(cfg.n_global_layers)]
    for dst, src in stacks:
        for n, hf in names.items():
            out[f"vision.{dst}.{n}.weight"] = f"{src}.{hf}.weight"
            if n in ("fc1", "fc2", "ln1", "ln2"):
                out[f"vision.{dst}.{n}.bias"] = f"{src}.{hf}.bias"
        if dst.startswith("globals"):
            out[f"vision.{dst}.gate_attn"] = f"{src}.gate_attn"
            out[f"vision.{dst}.gate_mlp"] = f"{src}.gate_ffn"
    return out


def vision_state_from_hf(get, has, cfg: MllamaVisionConfig, text_dim: int
                         ) -> Dict[str, torch.Tensor]:
    """The vision and projector state dict from an HF mllama checkpoint:
    ``get(name)`` returns its tensor, ``has(name)`` says whether it is
    there (both layouts are read, as the reference's converter reads
    them). The flat HF tile embeddings are reshaped to the port's
    ``[aspect ratios, tiles, (P1,) dim]``."""
    vm = ("model.vision_model" if has("model.vision_model.class_embedding")
          else "vision_model")
    mp = ("model.multi_modal_projector"
          if has("model.multi_modal_projector.weight")
          else "multi_modal_projector")
    shapes = vision_weight_shapes(cfg, text_dim)
    out = {}
    for name, src in vision_hf_names(cfg, vm, mp).items():
        if not has(src):
            raise ValueError(f"mllama checkpoint has no {src!r} (for "
                             f"{name})")
        t = get(src)
        if t.numel() != math.prod(shapes[name]):
            raise ValueError(f"{src!r} has {t.numel()} values, the config "
                             f"makes {name} {shapes[name]}")
        out[name] = t.reshape(shapes[name])
    return out


def encode_image(vision: MllamaVisionModel, projector: MllamaProjector,
                 img: np.ndarray, supported: Sequence[Sequence[int]],
                 mean=CLIP_MEAN, std=CLIP_STD) -> Tuple[torch.Tensor, int]:
    """An ``[H, W, 3]`` uint8 image -> ``(cross_states [Lv, text_dim]
    f32, n_valid)``: the reference's ``encode_image`` (tiling, the vision
    model, the projector); the valid states are the first ``n_tiles *
    (patches + 1)`` rows (tiles lead the flattened layout)."""
    cfg = vision.cfg
    tiles, ar_id, n_tiles = preprocess_tiled(img, cfg, supported, mean, std)
    dev = vision.device
    ar_mask = torch.zeros((1, cfg.max_num_tiles), dtype=torch.int32)
    ar_mask[0, :n_tiles] = 1
    with torch.inference_mode():
        feats = vision(torch.from_numpy(tiles)[None].to(dev),
                       torch.tensor([ar_id], device=dev), ar_mask.to(dev))
        states = projector(feats)[0].float()
    return states, n_tiles * (cfg.n_patches + 1)

