"""A JPEG decoder equal to PIL's: libjpeg-turbo's output, value for value.

The JAX package opens a request's JPEG with PIL (``serve/units/common.py:
180-200``, ``Image.open(...).convert("RGB")``), which decodes through
libjpeg-turbo with its defaults; the machine with the card has no PIL.
This module reproduces that decode for the streams it reads:

- Huffman-coded baseline and extended sequential (SOF0, SOF1) and
  progressive (SOF2) streams, 8-bit, with restart intervals (DRI). The
  entropy-coded data is unstuffed with numpy, and each symbol is read
  through a 16-bit lookahead table of its Huffman table (one list index a
  symbol, not a walk a bit at a time); the coefficients of progressive
  scans (DC first and refinement, AC first with end-of-band runs, AC
  refinement) follow ``jdphuff.c``;
- grayscale, and three components at any integral sampling factors
  (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...), YCbCr unless an Adobe marker or the
  component ids say RGB (``jdapimin.c``'s rule);
- the accurate integer IDCT (``jidctint.c``'s ``jpeg_idct_islow``: 13-bit
  constants, two passes, its range limit), vectorized over every block of
  a component; libjpeg's "fancy" upsampling (``jdsample.c``: the triangle
  filters ``h2v1``, ``h1v2`` and ``h2v2`` with their rounding biases, edge
  rows and columns replicated; box replication for other ratios and for
  ``h2`` ratios of components at most 2 samples wide); and its
  fixed-point YCbCr -> RGB tables (``jdcolor.c``, 16 fraction bits);
- the EXIF orientation is not applied, as ``Image.open`` does not apply
  it.

Arithmetic-coded, lossless and hierarchical streams, 12-bit samples and
four-component (CMYK, YCCK) images raise :class:`~.imageio.ImageError`
naming what was sent, as do images over ``MAX_JPEG_PIXELS`` (from the
frame header, before any allocation) and corrupt or truncated streams.
The coefficients are held in ``array.array`` (4 bytes each), which numpy
reads in place for the IDCT.
"""

from __future__ import annotations

import array
import struct
from typing import Dict, List, Tuple

import numpy as np

from .imageio import ImageError

#: the largest JPEG read, in pixels (4096 x 4096: a 12-megapixel phone
#: photo, 4032 x 3024, fits). The decode runs in Python on the request
#: thread and shares the GIL with the engine loop, its time and memory
#: growing with the pixels (``PERF.md`` §3 has its time on the card's
#: host), so a frame header past this is refused before any allocation,
#: far below the PNG decoder's limit (``imageio.MAX_IMAGE_PIXELS``)
MAX_JPEG_PIXELS = 4096 * 4096

#: zigzag index -> natural (row-major) index, with libjpeg's 16 guard
#: entries past 63 so that a corrupt run cannot index past the block
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
) + (63,) * 16

#: frame markers that are not read, by what they hold
_REFUSED_SOF = {
    0xC3: "lossless", 0xC5: "hierarchical (differential)",
    0xC6: "hierarchical (differential)", 0xC7: "lossless hierarchical",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical",
    0xCF: "arithmetic-coded lossless hierarchical",
}

#: s -> 2^s - 1 and 2^(s-1): the receive-and-extend masks
_MASK = tuple((1 << s) - 1 for s in range(17))
_HALF = (0,) + tuple(1 << (s - 1) for s in range(1, 17))


def _huffman_lut(counts: bytes, symbols: bytes) -> List[int]:
    """A 16-bit lookahead table: entry ``v`` (the next 16 bits) holds
    ``length << 8 | symbol`` of the code that starts ``v``; 0 where no
    code does."""
    lut = np.zeros(1 << 16, np.int32)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ImageError("bad JPEG: Huffman table over-subscribed")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "bw", "bh", "width", "height",
                 "coef", "qt")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


def _unstuff(data: bytes, start: int) -> Tuple[bytes, List[int], int]:
    """The entropy-coded data of the scan starting at ``start``, byte
    stuffing removed: ``(bytes, byte offsets where each restart interval
    starts, position of the marker that ends the scan)``."""
    arr = np.frombuffer(data, np.uint8)
    ffs = (np.flatnonzero(arr[start:-1] == 0xFF) + start).tolist()
    parts: List[bytes] = []
    segs = [0]
    n = 0
    i = start
    end = len(data)
    for j in ffs:
        if j < i:
            continue
        nxt = data[j + 1]
        if nxt == 0x00:           # a stuffed 0xFF
            parts.append(data[i:j + 1])
            n += j + 1 - i
            i = j + 2
        elif 0xD0 <= nxt <= 0xD7:  # RSTn: the next interval
            parts.append(data[i:j])
            n += j - i
            segs.append(n)
            i = j + 2
        elif nxt == 0xFF:         # a fill byte before a marker
            parts.append(data[i:j])
            n += j - i
            i = j + 1
        else:
            end = j
            break
    else:
        raise ImageError("bad JPEG: truncated (no marker after the scan)")
    parts.append(data[i:end])
    return b"".join(parts), segs, end


def _windows(buf: bytes) -> List[int]:
    """``w[i]``: the 32 bits at byte ``i`` (zeros past the end, as libjpeg
    fills a short stream), so the ``n <= 16`` bits at bit ``p`` are
    ``(w[p >> 3] >> (32 - (p & 7) - n)) & (2^n - 1)``."""
    a = np.frombuffer(buf + bytes(8), np.uint8).astype(np.uint32)
    w = (a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8) | a[3:]
    return w.tolist()


class _Decoder:
    def __init__(self, data: bytes):
        self.data = data
        self.qts: Dict[int, np.ndarray] = {}
        self.dc: Dict[int, List[int]] = {}
        self.ac: Dict[int, List[int]] = {}
        self.comps: List[_Component] = []
        self.progressive = False
        self.restart = 0
        self.jfif = False
        self.adobe = None      # the Adobe marker's transform flag
        self.frame = False

    # -- markers -----------------------------------------------------------

    def run(self) -> np.ndarray:
        d = self.data
        if d[:2] != b"\xff\xd8":
            raise ImageError("not a JPEG file")
        pos = 2
        while True:
            # skip fill bytes; anything else between segments is corrupt
            while pos < len(d) and d[pos] == 0xFF and pos + 1 < len(d) \
                    and d[pos + 1] == 0xFF:
                pos += 1
            if pos + 2 > len(d) or d[pos] != 0xFF:
                raise ImageError("bad JPEG: truncated or corrupt marker "
                                 "stream")
            m = d[pos + 1]
            pos += 2
            if m == 0xD9:                       # EOI
                break
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            if pos + 2 > len(d):
                raise ImageError("bad JPEG: truncated segment")
            n = struct.unpack(">H", d[pos:pos + 2])[0]
            body = d[pos + 2:pos + n]
            if n < 2 or len(body) != n - 2:
                raise ImageError("bad JPEG: truncated segment")
            pos += n
            if m in (0xC0, 0xC1, 0xC2):
                self._sof(m, body)
            elif m in _REFUSED_SOF:
                raise ImageError(f"{_REFUSED_SOF[m]} JPEG images (SOF"
                                 f"{m - 0xC0}) are not supported")
            elif m == 0xCC:
                raise ImageError("arithmetic-coded JPEG images (DAC) are not "
                                 "supported")
            elif m == 0xC4:
                self._dht(body)
            elif m == 0xDB:
                self._dqt(body)
            elif m == 0xDD:
                if len(body) != 2:
                    raise ImageError("bad JPEG: DRI length")
                self.restart = struct.unpack(">H", body)[0]
            elif m == 0xDA:
                pos = self._sos(body, pos)
            elif m == 0xE0 and body[:5] == b"JFIF\x00":
                self.jfif = True
            elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
                self.adobe = body[11]
            elif m == 0xDC:
                raise ImageError("JPEG images with a DNL marker are not "
                                 "supported")
        if not self.frame or any(c.coef is None for c in self.comps):
            raise ImageError("bad JPEG: no frame or no scan")
        return self._output()

    def _sof(self, m: int, b: bytes) -> None:
        if self.frame:
            raise ImageError("bad JPEG: two frames")
        if len(b) < 6:
            raise ImageError("bad JPEG: SOF length")
        prec, h, w, nf = struct.unpack(">BHHB", b[:6])
        if prec != 8:
            raise ImageError(f"{prec}-bit JPEG images are not supported "
                             f"(8-bit only)")
        if nf == 4:
            raise ImageError("CMYK/YCCK (4-component) JPEG images are not "
                             "supported")
        if nf not in (1, 3):
            raise ImageError(f"JPEG images of {nf} components are not "
                             f"supported")
        if h == 0 or w == 0:
            raise ImageError("bad JPEG: empty image")
        if w * h > MAX_JPEG_PIXELS:
            raise ImageError(f"JPEG image of {w}x{h} pixels is over the "
                             f"{MAX_JPEG_PIXELS}-pixel limit for JPEG")
        if len(b) != 6 + 3 * nf:
            raise ImageError("bad JPEG: SOF length")
        self.width, self.height = w, h
        self.progressive = m == 0xC2
        for i in range(nf):
            cid, hv, tq = b[6 + 3 * i:9 + 3 * i]
            hs, vs = hv >> 4, hv & 15
            if not (1 <= hs <= 4 and 1 <= vs <= 4) or tq > 3:
                raise ImageError("bad JPEG: sampling factors or table id")
            self.comps.append(_Component(cid, hs, vs, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise ImageError("JPEG images with non-integral sampling "
                                 "ratios are not supported")
            c.width = -(-w * c.h // self.hmax)
            c.height = -(-h * c.v // self.vmax)
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v
            c.coef = None
        self.frame = True

    def _dht(self, b: bytes) -> None:
        i = 0
        while i < len(b):
            if i + 17 > len(b):
                raise ImageError("bad JPEG: DHT length")
            tc, th = b[i] >> 4, b[i] & 15
            counts = b[i + 1:i + 17]
            total = sum(counts)
            syms = b[i + 17:i + 17 + total]
            if len(syms) != total or tc > 1 or th > 3 or total > 256:
                raise ImageError("bad JPEG: DHT")
            (self.ac if tc else self.dc)[th] = _huffman_lut(counts, syms)
            i += 17 + total

    def _dqt(self, b: bytes) -> None:
        i = 0
        while i < len(b):
            pq, tq = b[i] >> 4, b[i] & 15
            size = 128 if pq else 64
            if i + 1 + size > len(b) or tq > 3 or pq > 1:
                raise ImageError("bad JPEG: DQT")
            vals = np.frombuffer(b[i + 1:i + 1 + size],
                                 ">u2" if pq else np.uint8).astype(np.int64)
            qt = np.zeros(64, np.int64)
            qt[list(ZIGZAG[:64])] = vals
            self.qts[tq] = qt
            i += 1 + size

    # -- scans -------------------------------------------------------------

    def _sos(self, b: bytes, pos: int) -> int:
        if not self.frame:
            raise ImageError("bad JPEG: scan before the frame header")
        ns = b[0]
        if len(b) != 4 + 2 * ns or not 1 <= ns <= 4:
            raise ImageError("bad JPEG: SOS length")
        by_id = {c.cid: c for c in self.comps}
        scan = []
        for i in range(ns):
            cid, t = b[1 + 2 * i:3 + 2 * i]
            if cid not in by_id:
                raise ImageError("bad JPEG: scan names an unknown component")
            scan.append((by_id[cid], t >> 4, t & 15))
        ss, se, a = b[1 + 2 * ns:4 + 2 * ns]
        ah, al = a >> 4, a & 15
        for c, _, _ in scan:
            if c.coef is None:
                # libjpeg latches a component's table at its first scan
                if c.tq not in self.qts:
                    raise ImageError("bad JPEG: missing quantization table")
                c.qt = self.qts[c.tq].copy()
                c.coef = array.array("i", bytes(4 * c.bw * c.bh * 64))
        buf, segs, end = _unstuff(self.data, pos)
        w = _windows(buf)
        units = self._units(scan)
        try:
            if not self.progressive:
                if ss != 0 or se != 63 or ah or al:
                    raise ImageError("bad JPEG: sequential scan parameters")
                self._scan_sequential(scan, units, w, segs)
            elif ss == 0:
                if se != 0:
                    raise ImageError("bad JPEG: progressive DC scan "
                                     "parameters")
                self._scan_dc(scan, units, w, segs, ah, al)
            else:
                if ns != 1 or se < ss or se > 63:
                    raise ImageError("bad JPEG: progressive AC scan "
                                     "parameters")
                self._scan_ac(scan, units, w, segs, ss, se, ah, al)
        except (IndexError, KeyError, OverflowError):
            raise ImageError("bad JPEG: corrupt or truncated scan, or a "
                             "missing Huffman table") from None
        return end

    def _units(self, scan) -> Tuple[List[int], List[List[int]]]:
        """The scan's MCUs in order: ``(which scan component each block of
        an MCU is, each MCU's block coefficient offsets)``: the
        interleaved MCU grid, or one block a unit over the component's own
        blocks."""
        if len(scan) == 1:
            c = scan[0][0]
            bw, bh = -(-c.width // 8), -(-c.height // 8)
            offs = (np.arange(bh)[:, None] * c.bw + np.arange(bw)[None]) * 64
            return [0], offs.reshape(-1, 1).tolist()
        my = np.arange(self.mcuy)[:, None, None]
        mx = np.arange(self.mcux)[None, :, None]
        pattern, cols = [], []
        for si, (c, _, _) in enumerate(scan):
            yy, xx = np.meshgrid(np.arange(c.v), np.arange(c.h),
                                 indexing="ij")
            yy, xx = yy.reshape(1, 1, -1), xx.reshape(1, 1, -1)
            cols.append(((my * c.v + yy) * c.bw + mx * c.h + xx) * 64)
            pattern += [si] * (c.v * c.h)
        offs = np.concatenate(cols, axis=2).reshape(self.mcuy * self.mcux, -1)
        return pattern, offs.tolist()

    def _intervals(self, units, segs):
        """``(each block's (scan component, offset), bit position of a
        restart or None)`` a unit."""
        pattern, offs = units
        ri = self.restart
        for k, unit in enumerate(offs):
            rst = None
            if ri and k and k % ri == 0:
                seg = k // ri
                rst = segs[seg] * 8 if seg < len(segs) else None
            yield zip(pattern, unit), rst

    def _scan_sequential(self, scan, units, w, segs) -> None:
        tabs = [(self.dc[td], self.ac[ta], c.coef) for c, td, ta in scan]
        pred = [0] * len(scan)
        p = 0
        zz, mask, half = ZIGZAG, _MASK, _HALF
        for blocks, rst in self._intervals(units, segs):
            if rst is not None:
                p = rst
                pred = [0] * len(scan)
            for si, base in blocks:
                dl, al, cf = tabs[si]
                e = dl[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e >> 8
                s = e & 0xFF
                if s:
                    r = (w[p >> 3] >> (32 - (p & 7) - s)) & mask[s]
                    p += s
                    if r < half[s]:
                        r -= mask[s]
                    pred[si] += r
                cf[base] = pred[si]
                i = 1
                while i < 64:
                    e = al[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    s = e & 15
                    if s:
                        i += (e >> 4) & 15
                        r = (w[p >> 3] >> (32 - (p & 7) - s)) & mask[s]
                        p += s
                        if r < half[s]:
                            r -= mask[s]
                        cf[base + zz[i]] = r
                        i += 1
                    elif (e & 0xFF) == 0xF0:
                        i += 16
                    else:
                        break

    def _scan_dc(self, scan, units, w, segs, ah, al) -> None:
        cfs = [c.coef for c, _, _ in scan]
        mask, half = _MASK, _HALF
        p = 0
        if ah:       # refinement: one bit a block
            bit = 1 << al
            for blocks, rst in self._intervals(units, segs):
                if rst is not None:
                    p = rst
                for si, base in blocks:
                    if (w[p >> 3] >> (31 - (p & 7))) & 1:
                        cfs[si][base] |= bit
                    p += 1
            return
        dls = [self.dc[td] for _, td, _ in scan]
        pred = [0] * len(scan)
        for blocks, rst in self._intervals(units, segs):
            if rst is not None:
                p = rst
                pred = [0] * len(scan)
            for si, base in blocks:
                e = dls[si][(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += e >> 8
                s = e & 0xFF
                if s:
                    r = (w[p >> 3] >> (32 - (p & 7) - s)) & mask[s]
                    p += s
                    if r < half[s]:
                        r -= mask[s]
                    pred[si] += r
                cfs[si][base] = pred[si] << al

    def _scan_ac(self, scan, units, w, segs, ss, se, ah, al) -> None:
        c, _, ta = scan[0]
        lut, cf = self.ac[ta], c.coef
        zz, mask, half = ZIGZAG, _MASK, _HALF
        p = 0
        eobrun = 0
        p1, m1 = 1 << al, -1 << al
        for blocks, rst in self._intervals(units, segs):
            if rst is not None:
                p = rst
                eobrun = 0
            base = next(blocks)[1]
            if not ah:                      # first pass of the band
                if eobrun:
                    eobrun -= 1
                    continue
                i = ss
                while i <= se:
                    e = lut[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        i += r
                        v = (w[p >> 3] >> (32 - (p & 7) - s)) & mask[s]
                        p += s
                        if v < half[s]:
                            v -= mask[s]
                        cf[base + zz[i]] = v << al
                    elif r == 15:
                        i += 15
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) \
                                & mask[r]
                            p += r
                        eobrun -= 1
                        break
                    i += 1
                continue
            # refinement (jdphuff.c decode_mcu_AC_refine)
            i = ss
            if not eobrun:
                while i <= se:
                    e = lut[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        s = p1 if (w[p >> 3] >> (31 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w[p >> 3] >> (32 - (p & 7) - r)) \
                                & mask[r]
                            p += r
                        break
                    while i <= se:
                        j = base + zz[i]
                        if cf[j]:
                            if (w[p >> 3] >> (31 - (p & 7))) & 1 \
                                    and not cf[j] & p1:
                                cf[j] += p1 if cf[j] >= 0 else m1
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        i += 1
                    if s:
                        cf[base + zz[i]] = s
                    i += 1
            if eobrun:
                while i <= se:
                    j = base + zz[i]
                    if cf[j]:
                        if (w[p >> 3] >> (31 - (p & 7))) & 1 \
                                and not cf[j] & p1:
                            cf[j] += p1 if cf[j] >= 0 else m1
                        p += 1
                    i += 1
                eobrun -= 1

    # -- pixels ------------------------------------------------------------

    def _output(self) -> np.ndarray:
        planes = []
        for c in self.comps:
            coef = np.frombuffer(c.coef, np.intc).reshape(c.bh, c.bw, 64)
            px = idct_islow(coef * c.qt)            # [bh, bw, 8, 8]
            px = px.transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
            planes.append(px[:c.height, :c.width])
        H, W = self.height, self.width
        if len(planes) == 1:
            return np.repeat(planes[0][:, :, None], 3, axis=2)
        full = [upsample(pl, self.hmax // c.h, self.vmax // c.v)[:H, :W]
                for pl, c in zip(planes, self.comps)]
        if self._rgb():
            return np.ascontiguousarray(np.stack(full, axis=2))
        return ycc_to_rgb(*full)

    def _rgb(self) -> bool:
        """libjpeg's colour space guess for three components: JFIF is
        YCbCr; an Adobe marker says by its transform flag; else the
        component ids 'R', 'G', 'B' mean RGB."""
        if self.jfif:
            return False
        if self.adobe is not None:
            return self.adobe == 0
        return [c.cid for c in self.comps] == [82, 71, 66]


# -- the IDCT, upsampling and colour conversion ---------------------------------

_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137,
                            16069, 16819, 20995, 25172)


def _idct_pass(d, shift):
    """One 1-D pass of ``jpeg_idct_islow`` over ``d[0..7]`` (int64
    arrays), descaled by ``shift``."""
    z1 = (d[2] + d[6]) * _F0541
    tmp2 = z1 - d[6] * _F1847
    tmp3 = z1 + d[2] * _F0765
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0 = o0 * _F0298
    o1 = o1 * _F2053
    o2 = o2 * _F3072
    o3 = o3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    rnd = 1 << (shift - 1)
    return [(t10 + o3 + rnd) >> shift, (t11 + o2 + rnd) >> shift,
            (t12 + o1 + rnd) >> shift, (t13 + o0 + rnd) >> shift,
            (t13 - o0 + rnd) >> shift, (t12 - o1 + rnd) >> shift,
            (t11 - o2 + rnd) >> shift, (t10 - o3 + rnd) >> shift]


def _range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by ``x & 1023``: ``x +
    128`` clipped to [0, 255] for ``|x| < 512``, wrapping past it."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(
        i < 512, 255, np.where(i < 896, 0, i - 896))).astype(np.uint8)


_RANGE = _range_table()


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantized coefficients ``[..., 64]`` (natural order) -> samples
    ``[..., 8, 8]`` uint8: columns first (``PASS1_BITS`` kept), then rows,
    then the range limit."""
    blk = coef.reshape(coef.shape[:-1] + (8, 8)).astype(np.int64)
    cols = _idct_pass([blk[..., u, :] for u in range(8)],
                      _CONST_BITS - _PASS1_BITS)          # rows y of ws
    ws = np.stack(cols, axis=-2)                          # [..., y, x]
    rows = _idct_pass([ws[..., :, u] for u in range(8)],
                      _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=-1)                         # [..., y, x]
    return _RANGE[out & 1023]


def _edge(a: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """``a``'s neighbours before and after along ``axis``, the edges
    replicated."""
    n = a.shape[axis]
    prev = np.take(a, np.r_[0, np.arange(n - 1)], axis=axis)
    nxt = np.take(a, np.r_[np.arange(1, n), n - 1], axis=axis)
    return prev, nxt


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """A component plane ``[h, w]`` uint8 upsampled by ``(rh, rv)`` as
    libjpeg's fancy upsampling does it."""
    x = plane.astype(np.int32)
    h, w = x.shape
    if (rh, rv) == (1, 1):
        return plane
    if (rh, rv) == (2, 1) and w > 2:
        left, right = _edge(x, 1)
        return _interleave((3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2,
                           1).astype(np.uint8)
    if (rh, rv) == (1, 2):
        up, down = _edge(x, 0)
        return _interleave((3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2,
                           0).astype(np.uint8)
    if (rh, rv) == (2, 2) and w > 2:
        up, down = _edge(x, 0)
        out = []
        for far in (up, down):
            cs = 3 * x + far
            left, right = _edge(cs, 1)
            out.append(_interleave((3 * cs + left + 8) >> 4,
                                   (3 * cs + right + 7) >> 4, 1))
        return _interleave(out[0], out[1], 0).astype(np.uint8)
    return np.repeat(np.repeat(plane, rv, axis=0), rh, axis=1)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = (t.astype(np.int32) for t in _ycc_tables())


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert`` on uint8 planes (int32: each
    table entry and sum stays far inside it)."""
    out = np.empty(y.shape + (3,), np.uint8)
    y = y.astype(np.int32)
    for ch, term in enumerate((_CR_R[cr], (_CB_G[cb] + _CR_G[cr]) >> 16,
                               _CB_B[cb])):
        np.clip(y + term, 0, 255, out=term)
        out[..., ch] = term
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> ``[H, W, 3]`` uint8 RGB, as PIL's
    ``Image.open(...).convert("RGB")`` gives it (see the module note)."""
    return _Decoder(bytes(data)).run()
