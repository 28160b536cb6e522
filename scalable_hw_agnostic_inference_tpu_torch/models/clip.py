"""CLIP text encoder: SD2.1's conditioning model.

Port of ``scalable_hw_agnostic_inference_tpu/models/clip.py``
(``ClipTextConfig``, ``ClipTextEncoder``, ``params_from_torch``): token
and position embeddings, pre-LN causal blocks (``models/encoder.py``), the
final LayerNorm, and the pooled features at the end-of-text token (the
highest id). SD2.1 runs 23 of OpenCLIP-H's 24 layers with the final LN
over the truncated stack: diffusers' penultimate-layer conditioning.

The encoder computes in fp32, as the reference's does. On the card its
attention runs on B1, which takes bf16: q, k and v are rounded to bf16 at
the call and the output taken back to fp32 (``models/encoder.py``).

Weights: :func:`params_from_jax` (the JAX package's flax tree) and
:func:`state_from_hf` (HF ``CLIPTextModel`` keys, with or without
``text_model.``, truncated to ``n_layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from .encoder import Encoder, LayerNorm, param, state_from_flax


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    max_position: int = 77
    dim: int = 1024
    n_layers: int = 23          # SD2.1 runs 23 of OpenCLIP-H's 24 layers
    heads: int = 16
    mlp_dim: int = 4096
    ln_eps: float = 1e-5
    act: str = "gelu"           # OpenCLIP-H: gelu; CLIP-L (SD1.x): quick_gelu

    @classmethod
    def tiny(cls) -> "ClipTextConfig":
        return cls(vocab_size=128, max_position=16, dim=32, n_layers=2,
                   heads=2, mlp_dim=64)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any],
                penultimate: bool = False) -> "ClipTextConfig":
        """From an HF ``CLIPTextModel`` ``config.json`` (a dict)."""
        n_layers = hf["num_hidden_layers"] - (1 if penultimate else 0)
        return cls(
            vocab_size=hf["vocab_size"],
            max_position=hf["max_position_embeddings"],
            dim=hf["hidden_size"],
            n_layers=n_layers,
            heads=hf["num_attention_heads"],
            mlp_dim=hf["intermediate_size"],
            ln_eps=hf.get("layer_norm_eps", 1e-5),
            act=hf.get("hidden_act", "quick_gelu"),
        )


class ClipTextEncoder(nn.Module):
    """``ids [B, L]`` -> ``(last_hidden_state [B, L, dim] f32, pooled
    [B, dim] f32)``; pooled is the features at the highest id (the
    end-of-text token). ``device`` defaults to the card; ``"cpu"`` for the
    CPU."""

    def __init__(self, cfg: ClipTextConfig, final_ln: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        c, pd = cfg, param_dtype
        self.cfg, self.dtype = cfg, dtype
        self.tok_emb = param((c.vocab_size, c.dim), pd, device)
        self.pos_emb = param((c.max_position, c.dim), pd, device)
        self.encoder = Encoder(c.n_layers, c.dim, c.heads, c.mlp_dim,
                               act=c.act, ln_eps=c.ln_eps, dtype=dtype,
                               param_dtype=pd, device=device, causal=True)
        self.final_ln = LayerNorm(c.dim, c.ln_eps, pd, device) \
            if final_ln else None

    @property
    def device(self) -> torch.device:
        return self.tok_emb.device

    def forward(self, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = ids.to(self.device, torch.int64)
        L = ids.shape[1]
        x = self.tok_emb[ids].float() + self.pos_emb[:L].float()[None]
        x = self.encoder(x.to(self.dtype))
        if self.final_ln is not None:
            x = self.final_ln(x, self.dtype)
        x = x.float()
        eot = ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return x, pooled


def encode_fn(model: ClipTextEncoder) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    """``ids -> last_hidden_state`` under ``torch.inference_mode``: the
    conditioning the pipeline takes."""

    def encode(ids: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(ids)[0]

    return encode


def pooled_fn(model: ClipTextEncoder) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    """``ids -> pooled [B, dim]`` under ``torch.inference_mode``: Flux's
    CLIP conditioning (the features at the end-of-text token, after the
    final LayerNorm)."""

    def pooled(ids: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(ids)[1]

    return pooled


# -- weights -------------------------------------------------------------------

_BLOCK_HF = {"attn.q": "self_attn.q_proj", "attn.k": "self_attn.k_proj",
             "attn.v": "self_attn.v_proj", "attn.o": "self_attn.out_proj",
             "ln1": "layer_norm1", "ln2": "layer_norm2", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2"}


def hf_names(cfg: ClipTextConfig, final_ln: bool = True,
             pre: str = "text_model.") -> Dict[str, str]:
    """This module's state name -> the HF ``CLIPTextModel`` key."""
    out = {"tok_emb": f"{pre}embeddings.token_embedding.weight",
           "pos_emb": f"{pre}embeddings.position_embedding.weight"}
    if final_ln:
        out["final_ln.weight"] = f"{pre}final_layer_norm.weight"
        out["final_ln.bias"] = f"{pre}final_layer_norm.bias"
    for i in range(cfg.n_layers):
        for n, hf in _BLOCK_HF.items():
            for leaf in ("weight", "bias"):
                out[f"encoder.layer_{i}.{n}.{leaf}"] = (
                    f"{pre}encoder.layers.{i}.{hf}.{leaf}")
    return out


def state_from_hf(get: Callable[[str], torch.Tensor],
                  keys, cfg: ClipTextConfig,
                  final_ln: bool = True) -> Dict[str, torch.Tensor]:
    """The encoder's state from HF ``CLIPTextModel`` tensors: ``get(name)``
    returns one, ``keys`` are the checkpoint's names. Both layouts are
    read (``text_model.*`` or bare); layers past ``n_layers`` are not
    read."""
    keys = set(keys)
    pre = "text_model." if any(k.startswith("text_model.") for k in keys) \
        else ""
    out = {}
    for name, src in hf_names(cfg, final_ln, pre).items():
        if src not in keys:
            raise ValueError(f"CLIP text checkpoint has no {src!r} "
                             f"(for {name})")
        out[name] = get(src)
    return out


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of ``ClipTextEncoder``
    (numpy leaves) -> this module's state dict (the embeddings are bare
    parameters here, not ``.weight``)."""
    sd = state_from_flax(tree)
    for name in ("tok_emb", "pos_emb"):
        sd[name] = sd.pop(f"{name}.weight")
    return sd


def build(cfg: ClipTextConfig, state: Dict[str, torch.Tensor],
          final_ln: bool = True, dtype=torch.float32) -> ClipTextEncoder:
    """The encoder around ``state`` (built on the meta device, the tensors
    assigned: no second copy), computing in ``dtype``."""
    m = ClipTextEncoder(cfg, final_ln=final_ln, dtype=dtype, device="meta")
    m.load_state_dict(state, assign=True, strict=True)
    return m
