"""W8A16 projection (B4): the int8 weight-only kernel's wrapper, its plan
and its plain version.

No Pallas counterpart: the JAX package leaves ``quant_matmul``'s int8
product to XLA (``scalable_hw_agnostic_inference_tpu/ops/quant.py:142``),
which converts the int8 tiles in registers at every width. On the card that
fusion is ``csrc/int8_matmul.cu``, one kernel in two instantiations: decode
(at most :data:`DECODE_MAX_ROWS` rows, bound by the weight bytes) and wide
(prefill, chunks and fused windows, bound by the tensor cores past some 300
rows). Its source note says what bounds it on the H100 and what its design
does about that.

:func:`int8_matmul` launches the kernel for a CUDA tensor and raises for
anything the kernel does not take; for a tensor on the CPU it runs
:func:`int8_matmul_reference`, the reference's expression.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import torch

from . import _build
from .ragged_paged_attention import sm_count

#: the widest call the decode instantiation takes (its x slice is 8, 16, 32
#: or 64 rows: a decode step's batch or the sampled rows' ``lm_head``);
#: wider calls take the wide instantiation, 128 x rows a tile
DECODE_MAX_ROWS = 64
WIDE_ROWS = 128
#: k of one tile element, and the weight rows (outputs) of one 64-row tile
#: of a consumer warpgroup; a tile holds two consumer warpgroups' row
#: tiles, one each in the decode instantiation and one or two in the wide
#: one (the kernel's constants)
TILE_K = 128
ROW_TILE = 64
CONSUMERS = 2
#: a CTA count down to this share of the SMs that divides the tiles into
#: whole waves is taken over one per SM (no tile is split then)
WAVE_FILL = 0.8


def int8_matmul_reference(x: torch.Tensor, weight_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(x @ Wq^T) * scale`` in ``x``'s dtype, the
    weight cast to it, the product rounded before the rounded scale
    multiplies it (the reference's ``quant_matmul`` int8 branch)."""
    y = torch.nn.functional.linear(x, weight_q.to(x.dtype))
    return y * scale.to(x.dtype)


def x_rows(M: int) -> int:
    """x rows of one tile (wgmma's N): the instantiation a call of ``M``
    rows takes."""
    for rows in (8, 16, 32, DECODE_MAX_ROWS):
        if M <= rows:
            return rows
    return WIDE_ROWS


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    """One launch's walk over its output tiles (``tile_n`` weight rows by
    ``rows`` x rows, numbered n tile first, then m tile), each of
    ``k_tiles`` k tiles: CTA ``c`` of ``ctas`` takes whole tiles
    round-robin (tile ``u ctas + c`` in full wave ``u``), so a wave's tiles
    share their weight and x rows in L2; then its run ``[c Er / G,
    (c + 1) Er / G)`` of the ``Er`` (tile, k tile) elements of the tiles
    left over, so every CTA's load is within one k tile of every other's.
    The kernel walks the same units (``csrc/int8_matmul.cu`` ``Walk``)."""

    rows: int
    row_tiles: int
    m_tiles: int
    n_tiles: int
    k_tiles: int
    ctas: int

    @property
    def wide(self) -> bool:
        return self.rows > DECODE_MAX_ROWS

    @property
    def tile_n(self) -> int:
        """Weight rows (outputs) of one tile."""
        return CONSUMERS * ROW_TILE * self.row_tiles

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def elements(self) -> int:
        return self.tiles * self.k_tiles

    @property
    def full_waves(self) -> int:
        return self.tiles // self.ctas

    @property
    def remainder(self) -> int:
        """Elements (tile, k tile) of the tiles left after the full waves."""
        return (self.tiles - self.full_waves * self.ctas) * self.k_tiles

    def run(self, cta: int) -> Tuple[int, int]:
        """The CTA's run of remainder elements."""
        E, G = self.remainder, self.ctas
        return cta * E // G, (cta + 1) * E // G

    def cta_of(self, e: int) -> int:
        """The CTA whose run holds remainder element ``e``."""
        return ((e + 1) * self.ctas - 1) // self.remainder

    def _tile(self, tile: int) -> Tuple[int, int]:
        nt, mt = divmod(tile, self.m_tiles)
        return mt, nt

    def units(self, cta: int) -> List[Tuple[int, int, int, int]]:
        """The CTA's work units in order: ``(m tile, n tile, k0, k1)``, a
        k range of one output tile."""
        out = [(*self._tile(u * self.ctas + cta), 0, self.k_tiles)
               for u in range(self.full_waves)]
        base = self.full_waves * self.ctas
        e, hi = self.run(cta)
        while e < hi:
            rt, k0 = divmod(e, self.k_tiles)
            k1 = min(self.k_tiles, hi - rt * self.k_tiles)
            out.append((*self._tile(base + rt), k0, k1))
            e = rt * self.k_tiles + k1
        return out

    def pieces(self, m_tile: int, n_tile: int) -> List[Tuple[int, int]]:
        """``(cta, scratch slot)`` of each piece of an output tile, in the
        order the last piece to arrive adds them (ascending k); one entry,
        slot -1, when the tile is not split. Slot ``2c + 1`` holds the
        piece that starts the tile, ``2c`` any other."""
        tile = n_tile * self.m_tiles + m_tile
        rt = tile - self.full_waves * self.ctas
        if rt < 0:
            return [(tile % self.ctas, -1)]
        lo = self.cta_of(rt * self.k_tiles)
        hi = self.cta_of(rt * self.k_tiles + self.k_tiles - 1)
        if lo == hi:
            return [(lo, -1)]
        return [(c, 2 * c + 1 if c == lo else 2 * c)
                for c in range(lo, hi + 1)]

    @functools.cached_property
    def splits(self) -> bool:
        """Whether some tile's k tiles fall to more than one CTA (then the
        launch needs :attr:`scratch_numel` fp32 of partials)."""
        return any(self.run(c)[0] % self.k_tiles for c in range(self.ctas))

    @property
    def scratch_numel(self) -> int:
        return 2 * self.ctas * self.tile_n * self.rows


@functools.lru_cache(maxsize=4096)
def int8_plan(M: int, N: int, K: int, n_sms: int) -> Int8Plan:
    """The launch of an ``[M, K] x [N, K]^T`` call on a card of ``n_sms``
    SMs. The wide instantiation takes two row tiles a warpgroup (256-row
    tiles: its x tile feeds twice the weight rows) where that still makes a
    tile for every SM, else one. One persistent CTA per SM (the decode
    instantiation streams weight bytes from every SM), or, wide, the
    largest count down to :data:`WAVE_FILL` of them that divides the tiles
    into whole waves (then no tile is split); never more CTAs than
    elements."""
    rows = x_rows(M)
    m_tiles = -(-M // rows)
    k_tiles = -(-K // TILE_K)

    def n_tiles(row_tiles):
        return -(-N // (CONSUMERS * ROW_TILE * row_tiles))

    wide = rows > DECODE_MAX_ROWS
    row_tiles = 2 if wide and m_tiles * n_tiles(2) >= n_sms else 1
    tiles = m_tiles * n_tiles(row_tiles)
    waves = range(n_sms, math.ceil(WAVE_FILL * n_sms) - 1, -1) if wide else ()
    ctas = next((g for g in waves if tiles % g == 0),
                min(n_sms, tiles * k_tiles))
    return Int8Plan(rows, row_tiles, m_tiles, n_tiles(row_tiles), k_tiles,
                    ctas)


#: the split tiles' arrival counters, per (device, stream): int32 zeros, two
#: per CTA (one per consumer warpgroup); every launch leaves them at zero.
#: Calls on one stream run in order; a captured graph holds the counters of
#: its capture stream and replays one at a time on the engine's stream.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _arrival_counters(device: torch.device, stream: int,
                      n_sms: int) -> torch.Tensor:
    key = (device.index, stream)
    counters = _counters.get(key)
    if counters is None:
        counters = torch.zeros(2 * n_sms, dtype=torch.int32, device=device)
        _counters[key] = counters
    return counters


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def int8_matmul(x: torch.Tensor, weight_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``y [M, N] = (x [M, K] @ weight_q [N, K]^T) * scale [N]`` with int8
    weights. On a CUDA tensor this launches the W8A16 kernel (x bf16,
    contiguous and 16-byte aligned like ``weight_q``; ``N % 8 == 0``,
    ``K % 16 == 0``), the decode instantiation up to
    :data:`DECODE_MAX_ROWS` rows and the wide one past them, or raises; on
    a CPU tensor it runs :func:`int8_matmul_reference`."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, weight_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dim() != 2 or weight_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"int8_matmul takes x [M, K], weight_q [N, K], "
                         f"scale [N]; got {tuple(x.shape)}, "
                         f"{tuple(weight_q.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    N = weight_q.shape[0]
    if weight_q.shape[1] != K or scale.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, weight_q "
                         f"{tuple(weight_q.shape)}, scale "
                         f"{tuple(scale.shape)} do not match")
    if M < 1:
        raise ValueError("int8_matmul kernel takes at least one row")
    if N % 8 or K % 16:
        raise ValueError(f"int8_matmul kernel takes N % 8 == 0 and "
                         f"K % 16 == 0, got N={N}, K={K}")
    _check("x", x, x.device, torch.bfloat16)
    _check("weight_q", weight_q, x.device, torch.int8)
    _check("scale", scale, x.device, torch.float32)
    n_sms = sm_count(x.device.index)
    plan = int8_plan(M, N, K, n_sms)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = x.new_empty((M, N))
    part = (x.new_empty((plan.scratch_numel,), dtype=torch.float32)
            if plan.splits else None)
    counters = _arrival_counters(x.device, stream, n_sms)
    lib = _build.library()
    if plan.wide:
        _build.count(int8_matmul, "wide_launches")
    else:
        _build.count(int8_matmul)
    err = lib.shai_int8_matmul(
        x.data_ptr(), weight_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), counters.data_ptr(),
        M, N, K, plan.ctas, plan.row_tiles, x.device.index, stream)
    _build.check(err, "int8_matmul")
    return y


#: launches since the last reset, of the decode instantiation and of the
#: wide one (``chip_smoke.py`` reads both to show which kernel ran)
int8_matmul.launches = 0
int8_matmul.wide_launches = 0
