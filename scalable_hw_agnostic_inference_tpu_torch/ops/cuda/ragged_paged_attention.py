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

The kernel's decode CTA is also B2's: :func:`_launch` checks, plans and
launches the walk for both wrappers, each counting its own launches.

Row groups (``groups=``, the fused mixed-phase step's layout): the rows are
cut into groups, each a ``(first row, row count, table row)``; a group of
one row takes the decode CTA, a larger group the tile CTA, in ONE launch
(:func:`_launch_groups`) counted as B3's.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import _build
from .flash_attention import (
    HEAD_DIMS,
    _check_bf16_cuda,
    masked_softmax_attention,
)


#: row groups of one launch: ``(first row, row count, table row)`` each, in
#: row order, covering every row once
Groups = Tuple[Tuple[int, int, int], ...]


def ragged_paged_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor,
                                     lengths: torch.Tensor,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None,
                                     *, scale: Optional[float] = None,
                                     rows_per_table: int = 1,
                                     groups: Optional[Groups] = None
                                     ) -> torch.Tensor:
    """The plain version of B3, in fp32: gather each row's table window
    into a dense ``[rows, M*bs, Hkv, D]`` context (an int8 pool times its
    per-(block, kv head) scales) and mask keys at or past ``lengths[r]``.
    ``rows_per_table`` R > 1 first repeats each of the ``[rows / R, M]``
    table rows R times; ``groups`` gives each row its group's table row."""
    rows, H, D = q.shape
    _N, bs, Hkv, _ = k_pool.shape
    if groups is not None:
        tables = tables[[t for _, n, t in groups for _ in range(n)]]
    elif rows_per_table > 1:
        tables = tables.repeat_interleave(rows_per_table, dim=0)
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


#: keys per tile of the kernel's walk (``KT`` in the source)
KEY_TILE = 64
#: product rows (query rows x the query heads of one kv head) per CTA
MAX_PRODUCT_ROWS = 64
#: warps of the decode CTA (``DEC_WARPS``), which takes every launch with
#: ``rows_per_table`` 1 and at most ``DECODE_MAX_GROUP`` query heads per kv
#: head (``DEC_MAX_G``: two m16 tiles of heads)
DECODE_WARPS = 4
DECODE_MAX_GROUP = 32
#: the decode split plan: CTAs aimed at per SM when rows x kv heads would
#: not fill the card, and the fewest key tiles of the window per split
DECODE_CTAS_PER_SM = 2
DECODE_MIN_SPLIT_TILES = 4


@functools.lru_cache(maxsize=256)
def decode_plan(rows: int, n_heads: int, n_kv_heads: int, block_size: int,
                M: int, n_sms: int) -> Tuple[int, int]:
    """``(warps, splits)`` of a decode-CTA launch (one table row per query
    row), from the shapes alone (the lengths are data on the device).

    One CTA of :data:`DECODE_WARPS` warps per (row, kv head) streams that
    row's keys. A grid that fills the card (``n_sms``) is not split;
    otherwise each row's keys are split over enough CTAs that about
    :data:`DECODE_CTAS_PER_SM` land on every SM, each split keeping at
    least :data:`DECODE_MIN_SPLIT_TILES` key tiles of the full window."""
    ctas = rows * n_kv_heads
    if ctas >= n_sms:
        return DECODE_WARPS, 1
    most = max(1, -(-(M * block_size)
                    // (DECODE_MIN_SPLIT_TILES * KEY_TILE)))
    return DECODE_WARPS, min(-(-DECODE_CTAS_PER_SM * n_sms // ctas), most)


@functools.lru_cache(maxsize=256)
def ragged_plan(rows: int, rows_per_table: int, n_heads: int,
                n_kv_heads: int, block_size: int, M: int,
                n_sms: int) -> Tuple[int, int]:
    """``(rows_per_tile, splits)`` for one launch, from the shapes alone
    (the lengths are data on the device).

    ``rows_per_table`` 1 with at most :data:`DECODE_MAX_GROUP` query heads
    per kv head takes the decode CTA: one row a CTA, split by
    :func:`decode_plan`. Otherwise a CTA takes ``rows_per_tile``
    consecutive rows of one table, times the ``G = H / Hkv`` query heads of
    its kv head: up to :data:`MAX_PRODUCT_ROWS` product rows. When the grid
    (tiles x kv heads) is smaller than the card (``n_sms``), each tile's
    keys are split over ``splits`` CTAs so that about 4 land on every SM,
    each split keeping at least 4 key tiles of the full window; a grid that
    fills the card is not split."""
    G = n_heads // n_kv_heads
    R = rows_per_table
    if R == 1 and G <= DECODE_MAX_GROUP:
        return 1, decode_plan(rows, n_heads, n_kv_heads, block_size, M,
                              n_sms)[1]
    rt = 1 if R == 1 else min(R, max(1, MAX_PRODUCT_ROWS // G))
    ctas = (rows // R) * -(-R // rt) * n_kv_heads
    if ctas >= n_sms:
        return rt, 1
    most = max(1, -(-(M * block_size) // (4 * KEY_TILE)))
    return rt, min(-(-4 * n_sms // ctas), most)


#: most row groups one launch takes (``MAX_GROUPS`` in the source: the
#: group table travels by value with the launch)
MAX_GROUPS = 128


@functools.lru_cache(maxsize=256)
def groups_plan(groups: Groups, n_heads: int, n_kv_heads: int,
                block_size: int, M: int, n_sms: int) -> Tuple[int, int]:
    """``(rows_per_tile, decode splits)`` of a row-group launch, from the
    shapes alone. A group of more than one row (or of one, past
    :data:`DECODE_MAX_GROUP` query heads per kv head) takes tile CTAs of
    ``rows_per_tile`` rows, unsplit; the groups of one row take the decode
    CTA, split by :func:`decode_plan` over their own count."""
    G = n_heads // n_kv_heads
    n_dec = sum(1 for _, n, _ in groups if n == 1 and G <= DECODE_MAX_GROUP)
    rt = min(max(n for _, n, _ in groups), max(1, MAX_PRODUCT_ROWS // G))
    splits = (decode_plan(n_dec, n_heads, n_kv_heads, block_size, M,
                          n_sms)[1] if n_dec else 1)
    return rt, splits


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: the split scratch, per (device, stream): a flat fp32 buffer for the
#: partials and int32 zeros, one per (row, kv head), for the decode CTA's
#: in-kernel merge (its last split resets its counter to 0). Both grow to
#: the largest launch; calls on one stream run in order, so each may reuse
#: what the last one wrote and merged. A captured CUDA graph holds the
#: addresses it was captured with, so the engine reserves the scratch of
#: its capture stream for its largest decode key before the first capture
#: (:func:`reserve_split_scratch`), and a capture that would grow it
#: raises (:func:`frozen_scratch`): growing frees the buffer that earlier
#: graphs replay into. All of them replay on one stream, one at a time,
#: and each launch leaves its counters at zero for the next.
_scratch: Dict[Tuple[Optional[int], int],
               Tuple[torch.Tensor, torch.Tensor]] = {}
_frozen = False


@contextlib.contextmanager
def frozen_scratch():
    """Within the block, a launch whose split scratch would have to grow
    raises instead (the engine wraps its graph captures in this)."""
    global _frozen
    was, _frozen = _frozen, True
    try:
        yield
    finally:
        _frozen = was


def _split_scratch(device: torch.device, stream: int, numel: int,
                   n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    part, counters = _scratch.get(key, (None, None))
    grow_part = part is None or part.numel() < numel
    grow_counters = counters is None or counters.numel() < n_counters
    if (grow_part or grow_counters) and _frozen:
        raise RuntimeError(
            f"split scratch of stream {stream:#x} holds "
            f"{0 if part is None else part.numel()} values and "
            f"{0 if counters is None else counters.numel()} counters; this "
            f"launch needs {numel} and {n_counters}: reserve it for the "
            f"largest key before the first capture")
    if grow_part:
        part = torch.empty(numel, dtype=torch.float32, device=device)
    if grow_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _scratch[key] = part, counters
    return part, counters


def split_scratch_size(rows: int, rows_per_table: int, n_heads: int,
                       n_kv_heads: int, head_dim: int, block_size: int,
                       M: int, n_sms: int) -> Tuple[int, int]:
    """``(fp32 values, int32 counters)`` of split scratch one launch of
    these shapes takes (``(0, 0)`` when its plan does not split)."""
    _rt, splits = ragged_plan(rows, rows_per_table, n_heads, n_kv_heads,
                              block_size, M, n_sms)
    if splits == 1:
        return 0, 0
    return (splits * rows * n_heads * (head_dim + 2),
            rows * n_kv_heads)


def groups_scratch_size(groups: Groups, n_heads: int, n_kv_heads: int,
                        head_dim: int, block_size: int, M: int,
                        n_sms: int) -> Tuple[int, int]:
    """``(fp32 values, int32 counters)`` of split scratch one row-group
    launch of these shapes takes (``(0, 0)`` when its decode groups are
    not split)."""
    _rt, splits = groups_plan(tuple(groups), n_heads, n_kv_heads,
                              block_size, M, n_sms)
    if splits == 1:
        return 0, 0
    n = len(groups)
    return splits * n * n_heads * (head_dim + 2), n * n_kv_heads


def reserve_split_scratch(device: torch.device, stream: int, numel: int,
                          n_counters: int) -> None:
    """Grow the split scratch of launches on ``stream`` to at least
    ``numel`` values and ``n_counters`` counters, outside any capture."""
    if numel or n_counters:
        _split_scratch(device, stream, max(numel, 1), max(n_counters, 1))


def check_tables(rows: int, tables: torch.Tensor, lengths: torch.Tensor,
                  rows_per_table: int) -> None:
    """Raise unless ``tables`` is ``[rows / R, M]`` and ``lengths``
    ``[rows]`` for ``R = rows_per_table``."""
    R = rows_per_table
    if R < 1 or rows % R:
        raise ValueError(f"rows_per_table {R} does not divide the {rows} "
                         f"query rows")
    if tables.dim() != 2 or tables.shape[0] != rows // R \
            or lengths.shape != (rows,):
        raise ValueError(f"tables must be [{rows // R}, M] (rows_per_table "
                         f"{R}) and lengths [{rows}], got "
                         f"{tuple(tables.shape)} and {tuple(lengths.shape)}")


def check_groups(rows: int, groups: Groups, tables: torch.Tensor,
                 lengths: torch.Tensor) -> None:
    """Raise unless ``groups`` cover rows ``0 .. rows - 1`` in order, each
    with at least one row and a table row of the 2-D ``tables``, and
    ``lengths`` is ``[rows]``."""
    if tables.dim() != 2 or lengths.shape != (rows,):
        raise ValueError(f"tables must be [n_tables, M] and lengths "
                         f"[{rows}], got {tuple(tables.shape)} and "
                         f"{tuple(lengths.shape)}")
    nxt = 0
    for first, n, t in groups:
        if first != nxt or n < 1 or not 0 <= t < tables.shape[0]:
            raise ValueError(f"row groups {groups} do not cover the {rows} "
                             f"rows in order over {tables.shape[0]} table "
                             f"rows")
        nxt = first + n
    if nxt != rows or not groups:
        raise ValueError(f"row groups {groups} cover {nxt} of {rows} rows")


def _check_launch(name: str, q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, tables: torch.Tensor,
                  lengths: torch.Tensor, k_scale: Optional[torch.Tensor],
                  v_scale: Optional[torch.Tensor]) -> bool:
    """Raise for anything the kernel does not take; return whether the
    pool is int8."""
    rows, H, D = q.shape
    N, bs, Hkv, Dk = k_pool.shape
    dev = q.device
    if Dk != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % Hkv or H // Hkv > MAX_PRODUCT_ROWS:
        raise ValueError(f"{H} query heads over {Hkv} kv heads: the kernel "
                         f"takes a GQA group of at most {MAX_PRODUCT_ROWS}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes D in {HEAD_DIMS}, got {D}")
    if N * bs * Hkv >= 2 ** 31:
        raise ValueError(f"a pool of {N * bs * Hkv} rows of D values: the "
                         f"kernel indexes rows with int32")
    _check_bf16_cuda("q", q, dev)
    quantized = k_pool.dtype == torch.int8
    if quantized:
        for t_name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{t_name} must be contiguous and 16-byte "
                                 f"aligned on {dev}")
        if v_pool.dtype != torch.int8:
            raise TypeError(f"v_pool must be int8 like k_pool, got "
                            f"{v_pool.dtype}")
        for t_name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.device != dev or t.dtype != torch.float32 \
                    or t.shape != (N, Hkv) or not t.is_contiguous():
                raise ValueError(f"an int8 pool needs {t_name} as contiguous "
                                 f"float32 [{N}, {Hkv}] on {dev}")
    else:
        _check_bf16_cuda("k_pool", k_pool, dev)
        _check_bf16_cuda("v_pool", v_pool, dev)
        if k_scale is not None or v_scale is not None:
            raise ValueError("scales are for an int8 pool; this pool is "
                             f"{k_pool.dtype}")
    for t_name, t in (("tables", tables), ("lengths", lengths)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{t_name} must be contiguous int32 on {dev}")
    return quantized


def _launch(counted, q: torch.Tensor, k_pool: torch.Tensor,
            v_pool: torch.Tensor, tables: torch.Tensor,
            lengths: torch.Tensor, k_scale: Optional[torch.Tensor],
            v_scale: Optional[torch.Tensor], scale: Optional[float],
            rows_per_table: int, *, splits: Optional[int] = None,
            merge_in_kernel: bool = True) -> torch.Tensor:
    """Check one CUDA call of the walk (tables already checked against the
    rows), plan it, and launch it on the current stream: the one launcher
    of B2 and B3. ``counted`` is the public wrapper whose call this is; its
    ``launches`` rises by one. ``splits`` overrides the plan, and
    ``merge_in_kernel=False`` merges the decode CTA's splits in a second
    kernel instead of its last split CTA (``chip_smoke.py`` measures both).
    """
    rows, H, D = q.shape
    _N, bs, Hkv, _ = k_pool.shape
    M = tables.shape[1]
    dev = q.device
    quantized = _check_launch(counted.__name__, q, k_pool, v_pool, tables,
                              lengths, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    rt, planned = ragged_plan(rows, rows_per_table, H, Hkv, bs, M,
                              sm_count(dev.index))
    splits = splits or planned
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    part_o = part_ml = counters = None
    if splits > 1:
        # fp32 partials: acc [splits, rows, H, D], then (m, l) per
        # (split, row, head)
        n_o = splits * rows * H * D
        part, cnt = _split_scratch(dev, stream, n_o + splits * rows * H * 2,
                                   rows * Hkv)
        part_o = part.data_ptr()
        part_ml = part_o + 4 * n_o
        if merge_in_kernel:
            counters = cnt.data_ptr()
    lib = _build.library()
    counted.launches += 1
    err = lib.shai_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), part_o,
        part_ml, counters, rows, rows_per_table, rt, H, Hkv, D, bs, M,
        int(quantized), splits, float(scale), dev.index, stream)
    _build.check(err, counted.__name__)
    return out


def _launch_groups(counted, q: torch.Tensor, k_pool: torch.Tensor,
                   v_pool: torch.Tensor, tables: torch.Tensor,
                   lengths: torch.Tensor, k_scale: Optional[torch.Tensor],
                   v_scale: Optional[torch.Tensor], scale: Optional[float],
                   groups: Groups) -> torch.Tensor:
    """Check, plan and launch one row-group call of the walk on the current
    stream (groups already checked against the rows and tables);
    ``counted.launches`` rises by one."""
    rows, H, D = q.shape
    _N, bs, Hkv, _ = k_pool.shape
    M = tables.shape[1]
    dev = q.device
    quantized = _check_launch(counted.__name__, q, k_pool, v_pool, tables,
                              lengths, k_scale, v_scale)
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"{len(groups)} row groups; one launch takes at most "
                         f"{MAX_GROUPS}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    rt, splits = groups_plan(groups, H, Hkv, bs, M, sm_count(dev.index))
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(q)
    part_o = part_ml = counters = None
    if splits > 1:
        # fp32 partials of the decode groups: acc [splits, groups, H, D],
        # then (m, l) per (split, group, head); one counter per (group, kv
        # head) for the in-kernel merge
        n = len(groups)
        n_o = splits * n * H * D
        part, cnt = _split_scratch(dev, stream, n_o + splits * n * H * 2,
                                   n * Hkv)
        part_o = part.data_ptr()
        part_ml = part_o + 4 * n_o
        counters = cnt.data_ptr()
    desc = (ctypes.c_int * (3 * len(groups)))(
        *[x for g in groups for x in g])
    lib = _build.library()
    counted.launches += 1
    err = lib.shai_ragged_paged_attention_groups(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), part_o,
        part_ml, counters, ctypes.addressof(desc), len(groups), rows, rt,
        splits, H, Hkv, D, bs, M, tables.shape[0], int(quantized),
        float(scale), dev.index, stream)
    _build.check(err, counted.__name__)
    return out


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           scale: Optional[float] = None,
                           rows_per_table: int = 1,
                           groups: Optional[Sequence[Sequence[int]]] = None
                           ) -> torch.Tensor:
    """Attend each row's query ``[rows, H, D]`` over its own paged context
    in the pool ``[N, bs, Hkv, D]`` through ``tables``; keys at or past
    ``lengths[r]`` are masked (a length past ``M * bs`` counts as the whole
    window), and a row's work follows its length, not ``M``.
    ``k_scale``/``v_scale`` ``[N, Hkv]`` mark an int8 pool. Returns
    ``[rows, H, D]``.

    ``rows_per_table`` R: ``tables`` is ``[rows / R, M]`` and each run of R
    consecutive rows shares one table row (the continuation's queries of
    one sequence); R = 1 gives each row its own, the TPU kernel's
    contract. ``groups`` instead cuts the rows into row groups
    ``(first row, row count, table row)``, in row order, over
    ``tables [n_tables, M]``: the fused step's decode rows are groups of
    one and its chunk one group (at most :data:`MAX_GROUPS`). A table or
    group layout of the wrong shape raises on every device.

    On a CUDA tensor this launches the B3 kernel or raises: q bf16; a bf16
    pool, or an int8 pool with both scales contiguous f32 ``[N, Hkv]``;
    ``D`` in ``HEAD_DIMS``; any block size; at most
    :data:`MAX_PRODUCT_ROWS` query heads per kv head; contiguous int32
    tables and lengths. On a CPU tensor it runs
    :func:`ragged_paged_attention_reference`. Table entries are trusted to
    be valid block ids (checking them would cost a host round trip).
    """
    if groups is not None:
        if rows_per_table != 1:
            raise ValueError("rows_per_table and groups exclude each other")
        groups = tuple((int(f), int(n), int(t)) for f, n, t in groups)
        check_groups(q.shape[0], groups, tables, lengths)
    else:
        check_tables(q.shape[0], tables, lengths, rows_per_table)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, tables, lengths, k_scale, v_scale, scale=scale,
            rows_per_table=rows_per_table, groups=groups)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: unsupported device {q.device}")
    if groups is not None:
        return _launch_groups(ragged_paged_attention, q, k_pool, v_pool,
                              tables, lengths, k_scale, v_scale, scale,
                              groups)
    return _launch(ragged_paged_attention, q, k_pool, v_pool, tables,
                   lengths, k_scale, v_scale, scale, rows_per_table)


#: kernel launches since the last reset (``chip_smoke.py`` reads it to show
#: the serving path went through the kernel)
ragged_paged_attention.launches = 0
