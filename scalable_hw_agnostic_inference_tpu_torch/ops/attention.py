"""Multi-head attention with GQA, masking and implementation dispatch.

Port of ``scalable_hw_agnostic_inference_tpu/ops/attention.py``
(``_xla_attention``, ``causal_mask``, ``dot_product_attention``,
``ragged_gather_attention``, ``ragged_paged_attention``,
``mixed_phase_ragged_attention``). The reference
asks JAX which platform a computation runs on (``effective_platform``);
here the tensor's own device answers: a CUDA tensor goes to the B1 or B3
kernel (or the call raises), a CPU tensor to the plain path. The
reference's TPU-measured dispatch thresholds and its branch into JAX's own
TPU flash kernel do not carry over.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda.flash_attention import flash_attention, flash_eligible
from .cuda.ragged_paged_attention import (
    check_tables,
    ragged_paged_attention as _ragged_kernel,
)
from .quant import dequantize_kv_blocks

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


# -- ragged paged attention (gather path + dispatch) -------------------------


def ragged_gather_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    positions: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather path of ragged paged attention: query ``(b, t)`` of ``q
    [B, T, H, D]`` attends pool positions ``<= positions[b, t]`` through
    row ``b``'s table ``tables [B, M]``. A dense gather of the table window
    plus a per-query mask; an int8 pool (``k_scale``/``v_scale``
    ``[N, Hkv]``) dequantizes to ``q``'s dtype right after a block-shaped
    gather. Returns ``[B, T, H, D]``."""
    B, T, H, D = q.shape
    _N, block_size, Hkv, _ = k_pool.shape
    M = tables.shape[1]
    L = M * block_size
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    tables = tables.to(device=q.device, dtype=torch.int64)
    if k_scale is not None:
        kctx = dequantize_kv_blocks(k_pool[tables], k_scale[tables],
                                    dtype=q.dtype).reshape(B, L, Hkv, D)
        vctx = dequantize_kv_blocks(v_pool[tables], v_scale[tables],
                                    dtype=q.dtype).reshape(B, L, Hkv, D)
    else:
        goff = (tables[:, :, None] * block_size
                + torch.arange(block_size, device=q.device)[None, None, :]
                ).reshape(B, L)
        kctx = k_pool.reshape(-1, Hkv, D)[goff]
        vctx = v_pool.reshape(-1, Hkv, D)[goff]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= positions.to(q.device)[:, :, None])[:, None]  # [B, 1, T, L]
    return _xla_attention(q, kctx, vctx, mask, None, scale)


def ragged_paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    rows_per_table: int = 1,
) -> torch.Tensor:
    """Ragged paged attention of one query per row ``[rows, H, D]`` with
    per-row ``lengths``: the B3 kernel on a CUDA tensor, the gather path
    on the CPU. Multi-token callers flatten their queries into rows; with
    ``rows_per_table`` R, ``tables`` is ``[rows / R, M]`` and each run of R
    consecutive rows shares one table row."""
    if q.device.type == "cuda":
        return _ragged_kernel(q, k_pool, v_pool, tables, lengths, k_scale,
                              v_scale, scale=scale,
                              rows_per_table=rows_per_table)
    check_tables(q.shape[0], tables, lengths, rows_per_table)
    if rows_per_table > 1:
        tables = tables.repeat_interleave(rows_per_table, dim=0)
    pos = (lengths.to(torch.int64) - 1)[:, None]
    return ragged_gather_attention(q[:, None], k_pool, v_pool, tables, pos,
                                   k_scale, v_scale, scale=scale)[:, 0]


def mixed_phase_groups(B: int, C: int):
    """B3's row groups of a mixed-phase call: ``B`` decode rows of one,
    each over its own table row, then the ``C`` chunk rows over table row
    ``B``."""
    return tuple((i, 1, i) for i in range(B)) + ((B, C, B),)


def mixed_phase_ragged_attention(
    q_dec: torch.Tensor,
    q_chunk: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables_dec: torch.Tensor,
    c_table: torch.Tensor,
    pos_dec: torch.Tensor,
    c_pos: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
):
    """Mixed-phase ragged attention (``SHAI_FUSED_STEP``): ``B`` decode
    rows ``q_dec [B, H, D]`` over ``tables_dec [B, M]`` and one ``C``-token
    continuation chunk ``q_chunk [C, H, D]`` over ``c_table [1, M]`` in ONE
    call of B3. Every row attends its own cache position and those before
    it (``pos_dec [B]``, ``c_pos [C]``): lengths ``clip(pos + 1, 1,
    M * block_size)``. The rows are ``B + C`` rows of B3 cut into row
    groups: each decode row a group of one over its own table row, the
    chunk one group of ``C`` rows sharing ``c_table``, so the kernel never
    learns which phase a row belongs to and the chunk's queries share each
    K/V tile they load. Returns ``(o_dec [B, H, D], o_chunk [C, H, D])``,
    split at row ``B``. On a CUDA tensor the B3 kernel or a raise; on the
    CPU its plain version over the same groups."""
    B = q_dec.shape[0]
    C = q_chunk.shape[0]
    L = tables_dec.shape[1] * k_pool.shape[1]
    qf = torch.cat([q_dec, q_chunk], dim=0).contiguous()
    tf = torch.cat([tables_dec, c_table], dim=0).to(torch.int32).contiguous()
    lf = (torch.cat([pos_dec, c_pos]).to(torch.int64) + 1).clamp(1, L).to(
        torch.int32)
    of = _ragged_kernel(qf, k_pool, v_pool, tf, lf, k_scale, v_scale,
                        scale=scale, groups=mixed_phase_groups(B, C))
    return of[:B], of[B:]
