"""Rotary position embeddings (Llama/Mistral-style half-rotation).

Port of ``scalable_hw_agnostic_inference_tpu/ops/rope.py`` (all of it):
pure functions over ``[B, T, H, D]`` tensors with explicit per-token
positions, so prefill (positions ``0..T``) and paged decode (arbitrary
positions) share one code path.
"""

from __future__ import annotations

import math

import torch


def llama3_scaled_inv_freq(inv_freq: torch.Tensor, scaling) -> torch.Tensor:
    """HF ``rope_type="llama3"`` frequency remap (Llama-3.1+/mllama).

    ``scaling`` = (factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings). Long wavelengths divide by
    ``factor``, short ones pass through, the band between interpolates.
    """
    factor, low, high, orig = scaling
    low_wavelen = orig / low
    high_wavelen = orig / high
    wavelen = 2.0 * math.pi / inv_freq
    scaled = inv_freq / factor
    smooth = (orig / wavelen - low) / (high - low)
    mid = (1 - smooth) * scaled + smooth * inv_freq
    out = torch.where(wavelen > low_wavelen, scaled, inv_freq)
    is_mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return torch.where(is_mid, mid, out)


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0,
                scaling=None):
    """cos/sin tables for ``positions`` -> each ``[..., dim/2]`` (fp32)."""
    if dim % 2:
        raise ValueError(f"rope dim must be even, got {dim}")
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    if scaling is not None:
        inv_freq = llama3_scaled_inv_freq(inv_freq, scaling)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scaling=None) -> torch.Tensor:
    """Rotate ``x`` ``[B, T, H, D]`` by per-token ``positions`` ``[B, T]``;
    the first D/2 lanes pair with the last D/2 (HF Llama convention)."""
    D = x.shape[-1]
    cos, sin = rope_angles(positions, D, theta, scaling)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
