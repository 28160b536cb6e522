"""Ragged paged attention: the B3 kernel's wrapper and its plain version.

Port of ``scalable_hw_agnostic_inference_tpu/ops/pallas/
ragged_paged_attention.py`` (``ragged_paged_attention``). The TPU kernel
becomes ``csrc/ragged_paged_attention.cu``; its source note says what
bounds it on the H100 and what its design does about that.

:func:`ragged_paged_attention` launches the kernel for a CUDA tensor and
raises for anything the kernel does not take; for a tensor on the CPU it
runs :func:`ragged_paged_attention_reference`: a gather of each row's table
window, int8 blocks dequantized right after the gather, a length mask and
an fp32 softmax (the gather oracle of ``ops/attention.py:249`` of the JAX
package, with the kernel's zeros for a row of length 0).
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


def ragged_paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor,
                                     lengths: torch.Tensor,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None,
                                     *, scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """The plain version of B3, in fp32: gather ``tables[r]``'s blocks into
    a dense ``[rows, M*bs, Hkv, D]`` context (an int8 pool times its
    per-(block, kv head) scales) and mask keys at or past ``lengths[r]``."""
    rows, H, D = q.shape
    _N, bs, Hkv, _ = k_pool.shape
    M = tables.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    tables = tables.to(device=q.device, dtype=torch.int64)
    kctx = k_pool[tables].float()                 # [rows, M, bs, Hkv, D]
    vctx = v_pool[tables].float()
    if k_scale is not None:
        kctx.mul_(k_scale[tables].float()[:, :, None, :, None])
        vctx.mul_(v_scale[tables].float()[:, :, None, :, None])
    kctx = kctx.reshape(rows, M * bs, Hkv, D)
    vctx = vctx.reshape(rows, M * bs, Hkv, D)
    n = lengths.to(device=q.device, dtype=torch.int64).reshape(rows)
    live = (torch.arange(M * bs, device=q.device)[None, :]
            < n[:, None])[:, None, None, :]       # [rows, 1, 1, L]
    return masked_softmax_attention(q[:, None].float(), kctx, vctx, live,
                                    scale)[:, 0].to(q.dtype)


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attend each row's query ``[rows, H, D]`` over its own paged context
    in the pool ``[N, bs, Hkv, D]`` through ``tables [rows, M]``; keys at or
    past ``lengths[r]`` are masked, and a row's work follows its length,
    not ``M``. ``k_scale``/``v_scale`` ``[N, Hkv]`` mark an int8 pool.
    Returns ``[rows, H, D]``.

    On a CUDA tensor this launches the B3 kernel or raises: q bf16; a bf16
    pool, or an int8 pool with both scales contiguous f32 ``[N, Hkv]``;
    ``D`` in ``HEAD_DIMS``; at most 32 query heads per kv head; contiguous
    int32 tables and lengths. On a CPU tensor it runs
    :func:`ragged_paged_attention_reference`. Table entries are trusted to
    be valid block ids (checking them would cost a host round trip).
    """
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: unsupported device {q.device}")
    rows, H, D = q.shape
    N, bs, Hkv, Dk = k_pool.shape
    M = tables.shape[1] if tables.dim() == 2 else -1
    if Dk != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tables.shape != (rows, M) or lengths.shape != (rows,):
        raise ValueError(f"tables must be [{rows}, M] and lengths [{rows}], "
                         f"got {tuple(tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    if H % Hkv or H // Hkv > 32:
        raise ValueError(f"{H} query heads over {Hkv} kv heads: the kernel "
                         f"takes a whole GQA group of at most 32 per block")
    if D not in HEAD_DIMS:
        raise ValueError(f"ragged_paged_attention kernel takes D in "
                         f"{HEAD_DIMS}, got {D}")
    _check_bf16_cuda("q", q, q.device)
    quantized = k_pool.dtype == torch.int8
    if quantized:
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            if t.device != q.device or not t.is_contiguous() \
                    or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous and 16-byte "
                                 f"aligned on {q.device}")
        if v_pool.dtype != torch.int8:
            raise TypeError(f"v_pool must be int8 like k_pool, got "
                            f"{v_pool.dtype}")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.device != q.device \
                    or t.dtype != torch.float32 or t.shape != (N, Hkv) \
                    or not t.is_contiguous():
                raise ValueError(f"an int8 pool needs {name} as contiguous "
                                 f"float32 [{N}, {Hkv}] on {q.device}")
    else:
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            _check_bf16_cuda(name, t, q.device)
        if k_scale is not None or v_scale is not None:
            raise ValueError("scales are for an int8 pool; this pool is "
                             f"{k_pool.dtype}")
    for name, t in (("tables", tables), ("lengths", lengths)):
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {q.device}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    out = torch.empty_like(q)
    lib = _build.library()
    ragged_paged_attention.launches += 1
    err = lib.shai_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), rows, H, Hkv,
        D, bs, M, int(quantized), float(scale), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ragged_paged_attention")
    return out


#: kernel launches since the last reset (``chip_smoke.py`` reads it to show
#: the serving path went through the kernel)
ragged_paged_attention.launches = 0
