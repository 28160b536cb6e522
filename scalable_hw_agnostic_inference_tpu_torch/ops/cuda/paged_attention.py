"""Paged decode attention: the B2 kernel's wrapper and its plain version.

Port of ``scalable_hw_agnostic_inference_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention``). On Hopper B2 is the decode CTA of B3's walk,
``csrc/ragged_paged_attention.cu``, with one table row per query row on the
caller's truncated tables; that source's note says what bounds it on the
H100 and what its design does about that. A bf16 call launches it through
B3's launcher and raises B2's counter. An int8 pool (``k_scale`` and
``v_scale`` given) goes to B3's wrapper, on the caller's truncated tables,
as the TPU kernel's int8 branch does (``paged_attention.py:127-132``): B3's
counter rises then, not B2's.

:func:`paged_decode_attention` launches the kernel for a CUDA tensor and
raises for anything the kernel does not take; for a tensor on the CPU it
runs :func:`paged_decode_attention_reference`: a dense gather of the table
window plus a length mask, the engine runner's off-accelerator decode path
(``engine/runner.py:696-703,765-770`` of the JAX package).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import masked_softmax_attention
from .ragged_paged_attention import (
    DECODE_MAX_GROUP,
    _launch,
    check_tables,
    ragged_paged_attention,
)


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
    context bucket); keys at or past ``lengths[b]`` are masked, a length
    past ``M * bs`` counts as the whole bucket, and a row of length 0
    returns zeros. Returns ``[B, H, D]``. On a CUDA tensor this launches
    the B2 kernel (bf16, ``D`` in ``HEAD_DIMS``, any block size, at most
    32 query heads per kv head) or raises; on a CPU tensor it runs
    :func:`paged_decode_attention_reference`. ``k_scale``/``v_scale``
    ``[N, Hkv]`` mark an int8 pool, which B3 reads (on the CPU, B3's plain
    version); one of the two without the other raises on every device.

    Table entries are trusted to be valid block ids: they are data on the
    device, and checking them would cost a host round trip per call.
    """
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 pool needs both k_scale and v_scale; got "
                         + ("k_scale" if v_scale is None else "v_scale")
                         + " alone")
    if k_scale is not None:
        return ragged_paged_attention(q, k_pool, v_pool, tables, lengths,
                                      k_scale, v_scale, scale=scale)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool, tables,
                                                lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    B, H, _D = q.shape
    Hkv = k_pool.shape[2]
    check_tables(B, tables, lengths, 1)
    if H % Hkv or H // Hkv > DECODE_MAX_GROUP:
        raise ValueError(f"{H} query heads over {Hkv} kv heads: the kernel "
                         f"takes a GQA group of at most {DECODE_MAX_GROUP}")
    return _launch(paged_decode_attention, q, k_pool, v_pool, tables,
                   lengths, None, None, scale, 1)


#: kernel launches since the last reset (``chip_smoke.py`` reads it to show
#: the serving path went through the kernel)
paged_decode_attention.launches = 0
