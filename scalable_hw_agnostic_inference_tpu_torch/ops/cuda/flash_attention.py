"""Flash attention: the B1 kernel's wrapper and its plain PyTorch version.

Port of ``scalable_hw_agnostic_inference_tpu/ops/pallas/flash_attention.py``
(``flash_attention``, ``flash_eligible``). The TPU kernel
becomes ``csrc/flash_attention.cu``; its source note says what bounds it on
the H100 and what its design does about that.

:func:`flash_attention` launches the kernel for a CUDA tensor and raises
for anything the kernel does not take; for a tensor on the CPU it runs
:func:`flash_attention_reference`, which computes the same function in
fp32 (fully masked rows give zeros, as the kernel's do).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

NEG_INF = -1e30

#: head sizes both kernels are instantiated for: every D the gate accepts
HEAD_DIMS = (64, 128, 192, 256)


def flash_eligible(q, k, v, mask=None, bias=None) -> bool:
    """Calls the kernel covers: no mask or bias, ``D`` in
    :data:`HEAD_DIMS` (the reference's ``D % 64 == 0 and D <= 256``),
    ``H % Hkv == 0``. Lengths are not a mask: the kernel takes them. The
    reference's rule that ``T`` divide into Pallas tiles is dropped: the
    kernel masks its ragged query tile."""
    if mask is not None or bias is not None:
        return False
    H, D = q.shape[2], q.shape[3]
    return D in HEAD_DIMS and H % k.shape[2] == 0


def masked_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, live: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """``[B,T,H,D] x [B,S,Hkv,D] -> [B,T,H,D]`` in fp32 with ``live``
    (broadcastable to ``[B,H,T,S]``) marking attended keys. Masked
    probabilities are zeroed explicitly, so a row with no live key gives
    zeros — the kernels' semantics, not a uniform average."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    # the G query heads of a kv head share its K/V: no copy per query head
    qg = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()).reshape(
        B, H, T, -1) * scale
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    p = (p / l.clamp_min(1e-20)).reshape(B, Hkv, G, T, -1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, T, H, D).to(q.dtype)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = False,
                              scale: Optional[float] = None,
                              lengths: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain version of B1: what the kernel computes, in fp32."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    k_pos = torch.arange(S, device=q.device)
    live = torch.ones((B, 1, T, S), dtype=torch.bool, device=q.device)
    if lengths is not None:
        n = lengths.to(device=q.device, dtype=torch.int64).reshape(-1)
        live = live & (k_pos[None, :] < n[:, None])[:, None, None, :]
    if causal:
        q_pos = torch.arange(T, device=q.device) + (S - T)
        live = live & (q_pos[:, None] >= k_pos[None, :])[None, None]
    return masked_softmax_attention(q, k, v, live, scale)


def _check_bf16_cuda(name: str, t: torch.Tensor, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention. q ``[B,T,H,D]``, k/v ``[B,S,Hkv,D]`` -> ``[B,T,H,D]``.

    ``lengths`` ``[B]`` marks the valid key count per row: keys past it are
    masked and their tiles skipped. Causal queries sit at key positions
    ``S - T ... S - 1``. On a CUDA tensor this launches the B1 kernel
    (bf16, ``D`` in :data:`HEAD_DIMS`) or raises; on a CPU tensor it runs
    :func:`flash_attention_reference`.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         lengths=lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bf16_cuda(name, t, q.device)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lens_ptr = None
    if lengths is not None:
        if lengths.numel() != B:
            raise ValueError(f"lengths must have {B} entries, got "
                             f"{tuple(lengths.shape)}")
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
        lens_ptr = lengths.data_ptr()
    out = torch.empty_like(q)
    lib = _build.library()
    flash_attention.launches += 1
    err = lib.shai_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens_ptr, out.data_ptr(),
        B, T, S, H, Hkv, D, float(scale), int(bool(causal)), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    return out


#: kernel launches since the last reset (``chip_smoke.py`` reads it to show
#: the serving path went through the kernel)
flash_attention.launches = 0
