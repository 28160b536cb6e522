"""Multi-head attention with GQA, masking and implementation dispatch.

Port of ``scalable_hw_agnostic_inference_tpu/ops/attention.py``
(``_xla_attention``, ``causal_mask``, ``dot_product_attention``). The
reference asks JAX which platform a computation runs on
(``effective_platform``); here the tensor's own device answers: a CUDA
tensor goes to the B1 kernel (or the call raises), a CPU tensor to the
plain fp32-softmax path. The reference's TPU-measured dispatch
thresholds and its branch into JAX's own TPU flash kernel do not carry over.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda.flash_attention import flash_attention, flash_eligible

NEG_INF = -1e30


def _xla_attention(q, k, v, mask, bias, scale) -> torch.Tensor:
    """Plain path (the reference's XLA path): ``[B,T,H,D] x [B,S,Hkv,D] ->
    [B,T,H,D]``, scores in fp32, probabilities cast to ``v``'s dtype before
    the second product, as the reference does."""
    H, Hkv = q.shape[2], k.shape[2]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)
    return o.to(q.dtype)


def causal_mask(T: int, S: int, offset: int = 0,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``[1,1,T,S]`` boolean mask; query i attends keys j <= i + offset."""
    qi = torch.arange(T, device=device)[:, None] + offset
    kj = torch.arange(S, device=device)[None, :]
    return (qi >= kj)[None, None]


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention.

    Args:
      q: ``[B, T, H, D]``.
      k, v: ``[B, S, Hkv, D]`` with ``H % Hkv == 0``.
      mask: boolean, broadcastable to ``[B, H, T, S]``; True = attend.
      bias: additive, broadcastable to ``[B, H, T, S]``.
      causal: queries sit at key positions ``S - T ... S - 1``.
      scale: defaults to ``1/sqrt(D)``.
      kv_lengths: ``[B]`` valid key count per row. Unlike ``mask`` it keeps
        the flash kernel eligible — bucketed LLM prefill reaches B1 this way.

    On CUDA every call goes to the B1 kernel, and a call the kernel does not
    take (a mask, a bias, a head size outside ``HEAD_DIMS``) raises; on the
    CPU every call takes the plain path.
    """
    B, T, H, D = q.shape
    S = k.shape[1]
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[2]}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cuda":
        if not flash_eligible(q, k, v, mask=mask, bias=bias):
            raise ValueError(
                f"flash attention not eligible for shapes q={tuple(q.shape)} "
                f"k={tuple(k.shape)} (mask={mask is not None}, "
                f"bias={bias is not None}); on CUDA attention runs only "
                f"through the B1 kernel")
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               lengths=kv_lengths)

    if kv_lengths is not None:
        lm = (torch.arange(S, device=q.device)[None, :]
              < kv_lengths.to(device=q.device, dtype=torch.int64)[:, None]
              )[:, None, None, :]
        mask = lm if mask is None else (mask & lm)
    if causal:
        cm = causal_mask(T, S, offset=S - T, device=q.device)
        mask = cm if mask is None else (mask & cm)
    return _xla_attention(q, k, v, mask, bias, scale)
