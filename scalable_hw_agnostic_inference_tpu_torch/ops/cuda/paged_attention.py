"""Paged decode attention: the B2 kernel's wrapper and its plain version.

Port of ``scalable_hw_agnostic_inference_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention``). The TPU kernel becomes
``csrc/paged_attention.cu``; its source note says what bounds it on the
H100 and what its design does about that. An int8 pool (``k_scale`` and
``v_scale`` given) goes to B3, ``ops.cuda.ragged_paged_attention``, on the
caller's truncated tables, as the TPU kernel's int8 branch does
(``paged_attention.py:127-132``): B3's counter rises then, not B2's.

:func:`paged_decode_attention` launches the kernel for a CUDA tensor and
raises for anything the kernel does not take; for a tensor on the CPU it
runs :func:`paged_decode_attention_reference`: a dense gather of the table
window plus a length mask, the engine runner's off-accelerator decode path
(``engine/runner.py:696-703,765-770`` of the JAX package).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .flash_attention import (
    HEAD_DIMS,
    _check_bf16_cuda,
    masked_softmax_attention,
)
from .ragged_paged_attention import ragged_paged_attention


def paged_decode_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor,
                                     lengths: torch.Tensor, *,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """The plain version of B2, in fp32: gather ``tables[b, :M]``'s blocks
    into a dense ``[B, M*bs, Hkv, D]`` context and mask keys at or past
    ``lengths[b]`` (a row of length 0 gives zeros, as the kernel's does)."""
    B, H, D = q.shape
    _N, bs, Hkv, _ = k_pool.shape
    M = tables.shape[1]
    L = M * bs
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    tables = tables.to(device=q.device, dtype=torch.int64)
    goff = (tables[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :]).reshape(B, L)
    kctx = k_pool.reshape(-1, Hkv, D)[goff]   # [B, L, Hkv, D]
    vctx = v_pool.reshape(-1, Hkv, D)[goff]
    n = lengths.to(device=q.device, dtype=torch.int64).reshape(B)
    live = (torch.arange(L, device=q.device)[None, :]
            < n[:, None])[:, None, None, :]   # [B, 1, 1, L]
    return masked_softmax_attention(q[:, None], kctx, vctx, live, scale)[:, 0]


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attend each row's query ``[B, H, D]`` over its paged context in the
    pool ``[N, bs, Hkv, D]`` through ``tables [B, M]`` (M may be a truncated
    context bucket); keys at or past ``lengths[b]`` are masked. Returns
    ``[B, H, D]``. On a CUDA tensor this launches the B2 kernel (bf16,
    ``D`` in ``HEAD_DIMS``, at most 32 query heads per kv head) or raises;
    on a CPU tensor it runs :func:`paged_decode_attention_reference`.
    ``k_scale``/``v_scale`` ``[N, Hkv]`` mark an int8 pool, which B3 reads
    (on the CPU, B3's plain version).

    Table entries are trusted to be valid block ids: they are data on the
    device, and checking them would cost a host round trip per call.
    """
    if k_scale is not None:
        return ragged_paged_attention(q, k_pool, v_pool, tables, lengths,
                                      k_scale, v_scale, scale=scale)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    B, H, D = q.shape
    _N, bs, Hkv, Dk = k_pool.shape
    M = tables.shape[1] if tables.dim() == 2 else -1
    if Dk != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tables.shape != (B, M) or lengths.shape != (B,):
        raise ValueError(f"tables must be [{B}, M] and lengths [{B}], got "
                         f"{tuple(tables.shape)} and {tuple(lengths.shape)}")
    if H % Hkv or H // Hkv > 32:
        raise ValueError(f"{H} query heads over {Hkv} kv heads: the kernel "
                         f"takes a whole GQA group of at most 32 per block")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention kernel takes D in "
                         f"{HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _check_bf16_cuda(name, t, q.device)
    for name, t in (("tables", tables), ("lengths", lengths)):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {q.device}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    lib = _build.library()
    paged_decode_attention.launches += 1
    err = lib.shai_paged_decode_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, Hkv, D, bs, M, float(scale),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    return out


#: kernel launches since the last reset (``chip_smoke.py`` reads it to show
#: the serving path went through the kernel)
paged_decode_attention.launches = 0
