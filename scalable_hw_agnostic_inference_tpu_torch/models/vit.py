"""ViT image classifier: the ``vit`` unit's model.

Port of ``scalable_hw_agnostic_inference_tpu/models/vit.py``
(``ViTConfig``, ``ViTClassifier``, ``params_from_torch``): a
stride-``patch`` convolution over NHWC pixels, the class token, learned
positions, a pre-LN encoder (``models/encoder.py``; attention on B1 on the
card, no lengths), the final LayerNorm and ``head`` on the class row.
Parameters are held in fp32 and cast to the compute dtype at use, as
flax casts them.

:func:`state_from_hf` reads an HF ``ViTForImageClassification``
checkpoint's keys (through ``core/checkpoint.py``, no ``transformers``);
:func:`params_from_jax` carries the JAX package's tree across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from .encoder import (
    Conv2d,
    Dense,
    Encoder,
    LayerNorm,
    hf_block_names,
    param,
    state_from_flax,
    state_from_names,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    dim: int = 768
    n_layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    n_labels: int = 1000
    ln_eps: float = 1e-12
    act: str = "gelu"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, dim=32, n_layers=2, heads=2,
                   mlp_dim=64, n_labels=10)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "ViTConfig":
        """From a ViT ``config.json`` (a dict; ``transformers``'
        ``ViTConfig`` defaults for what it omits)."""
        return cls(
            image_size=hf.get("image_size", 224),
            patch_size=hf.get("patch_size", 16),
            dim=hf.get("hidden_size", 768),
            n_layers=hf.get("num_hidden_layers", 12),
            heads=hf.get("num_attention_heads", 12),
            mlp_dim=hf.get("intermediate_size", 3072),
            n_labels=len(hf.get("id2label") or {}) or 1000,
            ln_eps=hf.get("layer_norm_eps", 1e-12),
            act=hf.get("hidden_act", "gelu"),
        )


def patch_tokens(conv: Conv2d, pixels: torch.Tensor) -> torch.Tensor:
    """NHWC pixels through a stride-``patch`` convolution -> ``[B,
    patches, dim]``, patches row-major (flax's ``Conv`` output reshaped)."""
    x = conv(pixels.permute(0, 3, 1, 2))
    return x.flatten(2).transpose(1, 2)


class ViTClassifier(nn.Module):
    """pixels ``[B, H, W, C]`` (NHWC, normalized) -> logits ``[B,
    n_labels]`` f32. ``device`` defaults to the card; ``"cpu"`` for the
    CPU, ``"meta"`` for no storage (:func:`build`)."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        c, pd = cfg, param_dtype
        self.patch = Conv2d(c.channels, c.dim, c.patch_size, dtype, device,
                            param_dtype=pd, stride=c.patch_size, padding=0)
        self.cls = param((1, 1, c.dim), pd, device)
        self.pos = param((1, c.n_patches + 1, c.dim), pd, device)
        self.encoder = Encoder(c.n_layers, c.dim, c.heads, c.mlp_dim,
                               act=c.act, ln_eps=c.ln_eps, dtype=dtype,
                               param_dtype=pd, device=device)
        self.final_ln = LayerNorm(c.dim, c.ln_eps, pd, device)
        self.head = Dense(c.dim, c.n_labels, True, pd, device)

    @property
    def device(self) -> torch.device:
        return self.cls.device

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        B = pixels.shape[0]
        x = patch_tokens(self.patch, pixels)
        x = torch.cat([self.cls.to(dt).expand(B, 1, c.dim), x], dim=1)
        x = self.encoder(x + self.pos.to(dt))
        x = self.final_ln(x, dt)
        return self.head(x[:, 0]).float()


def build(cfg: ViTConfig, state: Dict[str, torch.Tensor],
          dtype=torch.float32) -> ViTClassifier:
    """The classifier around ``state`` (built on the meta device, the
    tensors assigned: no second copy), computing in ``dtype``."""
    m = ViTClassifier(cfg, dtype=dtype, device="meta")
    m.load_state_dict(state, assign=True, strict=True)
    return m


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of ``ViTClassifier``
    (numpy leaves) -> this module's state dict."""
    return state_from_flax(tree)


#: an HF ViT (and YOLOS) encoder block's names, by this package's
VIT_BLOCK_HF = {"attn.q": "attention.attention.query",
                "attn.k": "attention.attention.key",
                "attn.v": "attention.attention.value",
                "attn.o": "attention.output.dense",
                "ln1": "layernorm_before", "fc1": "intermediate.dense",
                "fc2": "output.dense", "ln2": "layernorm_after"}


def vit_backbone_names(n_layers: int) -> Dict[str, str]:
    """The names an HF ``vit.*`` backbone shares between ViT and YOLOS:
    the class token, positions, the patch convolution, every block and
    the final LayerNorm."""
    emb = "vit.embeddings"
    out = {"cls": f"{emb}.cls_token", "pos": f"{emb}.position_embeddings",
           "patch.weight": f"{emb}.patch_embeddings.projection.weight",
           "patch.bias": f"{emb}.patch_embeddings.projection.bias",
           "final_ln.weight": "vit.layernorm.weight",
           "final_ln.bias": "vit.layernorm.bias"}
    for i in range(n_layers):
        out.update(hf_block_names(f"vit.encoder.layer.{i}",
                                  f"encoder.layer_{i}", VIT_BLOCK_HF))
    return out


def hf_names(cfg: ViTConfig) -> Dict[str, str]:
    """This module's state name -> the HF ``ViTForImageClassification``
    key."""
    out = vit_backbone_names(cfg.n_layers)
    out.update({"head.weight": "classifier.weight",
                "head.bias": "classifier.bias"})
    return out


def state_from_hf(get: Callable[[str], torch.Tensor], keys,
                  cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """The classifier's state from an HF ViT checkpoint: ``get(name)``
    returns a tensor, ``keys`` are the checkpoint's names."""
    return state_from_names(get, keys, hf_names(cfg), "ViT")
