"""Projections and int8 KV-block quantization for the engine runner.

Port of ``scalable_hw_agnostic_inference_tpu/ops/quant.py``: ``quant_matmul``
(``:142``, its plain bf16 branch; int8 weight-only projections come in a
later slice) and the int8 KV-block codec ``quantize_kv_blocks``,
``dequantize_kv_blocks`` and ``requantize_block_tokens`` (``:99-139``),
which the reference leaves to XLA and which stay plain PyTorch here. The
codec's arithmetic is the reference's step for step: an fp32 amax over
the block's token and head-dim axes, a ``1e-8`` floor, ``round`` (half to
even in both frameworks) then ``clip(-127, 127)``. Weights are
``nn.Linear`` weights, ``[out, in]``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quant_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ W^T`` in ``x``'s dtype (the weight is cast to it)."""
    return torch.nn.functional.linear(x, weight.to(x.dtype))


def quantize_kv_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., block_size, Hkv, Dh]`` float KV -> (int8 same shape,
    ``[..., Hkv]`` f32 scale). Symmetric per block x kv head: one head's
    outlier cannot flatten another head's resolution."""
    x32 = x.float()
    amax = x32.abs().amax(dim=(-3, -1))                   # [..., Hkv]
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None, :, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_blocks(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_blocks`: ``[..., Bs, Hkv, Dh]`` int8 +
    ``[..., Hkv]`` f32 scale -> float blocks in ``dtype``."""
    x = q.float() * scale[..., None, :, None].float()
    return x.to(dtype)


def requantize_block_tokens(q_blk: torch.Tensor, scale: torch.Tensor,
                            new_kv: torch.Tensor, pos_in_block: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one fresh token's KV into int8 blocks and re-quantize them.

    ``q_blk`` ``[B, Bs, Hkv, Dh]`` int8 (the gathered target blocks),
    ``scale`` ``[B, Hkv]``, ``new_kv`` ``[B, Hkv, Dh]`` float,
    ``pos_in_block`` ``[B]``. The new scale is the running max of the old
    one and the token's own: a block's scale only grows, so tokens already
    there lose at most half a step of the final scale. Returns the new
    blocks and scales (the inputs are not modified).
    """
    B = q_blk.shape[0]
    x = dequantize_kv_blocks(q_blk, scale, dtype=torch.float32)
    x[torch.arange(B, device=x.device), pos_in_block.long()] = new_kv.float()
    tok_amax = new_kv.float().abs().amax(dim=-1)          # [B, Hkv]
    new_scale = torch.maximum(scale.float(), tok_amax.clamp_min(1e-8) / 127.0)
    q = torch.round(x / new_scale[:, None, :, None]).clamp(-127, 127)
    return q.to(torch.int8), new_scale
