"""Images without PIL: a PNG decoder on ``zlib`` and numpy, Pillow's
bilinear and bicubic resizes, and the dispatch to the JPEG decoder
(``models/jpeg.py``).

No JAX counterpart of its own: the JAX package decodes and resizes images
through PIL (``serve/units/common.py:180-200`` and ``serve/units/vllm.py:
509-521`` open the request's bytes, ``models/mllama.py:283-286`` converts
to RGB and resizes), which the machine with the card does not have. This
module does the same work for the formats it reads:

- :func:`decode_png`: every PNG PIL opens, to an ``[H, W, 3]`` uint8 RGB
  array as PIL's ``Image.open(...).convert("RGB")`` gives it: colour
  types 0 (grey, at 1, 2, 4, 8 and 16 bits), 2 (RGB, 8 and 16), 3
  (palette, 1 to 8 bits, with or without ``tRNS``), 4 (grey + alpha) and
  6 (RGBA), plain or Adam7-interlaced, every filter type (0 None, 1 Sub,
  2 Up, 3 Average, 4 Paeth). Alpha is dropped, not composited; a palette
  expanded; grey replicated, a low-depth grey scaled to 0..255 as PIL's
  ``L;1``, ``L;2`` and ``L;4`` modes scale it; 16-bit colour keeps its
  high byte, and 16-bit grey (PIL's ``I;16``) is clipped to 255 on the
  way to RGB, as PIL clips it. An image of more pixels than Pillow's
  decompression-bomb limit is refused from its header, and the data is
  never inflated past what the header allows;
- :func:`resize_bilinear` and :func:`resize_bicubic`: ``Image.resize((w,
  h), BILINEAR)`` and PIL's default ``Image.resize((w, h))`` (BICUBIC) on
  such an array, value for value. Pillow's resize is a separable
  convolution whose support widens by the scale factor when it downscales
  (a triangle of support 1, or the a = -0.5 cubic of support 2), with
  coefficients rounded to 22-bit fixed point and a horizontal pass rounded
  and clipped to 8 bits before the vertical one;
- :func:`decode_image`: request bytes to RGB, PNG here and JPEG through
  ``models.jpeg``. Other formats (GIF, WebP, BMP) raise
  :class:`ImageError` naming what was sent; the serving unit answers it
  with a 400;
- :func:`encode_png`: an ``[H, W, 3]`` uint8 array to an 8-bit RGB PNG
  (the SD unit's response; the reference writes it with PIL's
  ``Image.fromarray(img).save(buf, format="PNG")``): one IDAT of every
  row under filter type 0, deflated at zlib's level 6 (Pillow's default
  ``compress_level``, :data:`PNG_LEVEL`). The bytes differ from PIL's (which picks a filter
  per row); the pixels read back are the same.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import List, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

#: the zlib level of :func:`encode_png` (Pillow's default compress_level)
PNG_LEVEL = 6

#: the most pixels an image may have: Pillow's ``DecompressionBombError``
#: limit, twice its default ``Image.MAX_IMAGE_PIXELS``
MAX_IMAGE_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)

#: colour type -> channels per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

#: colour type -> the bit depths the PNG specification allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}

#: Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

#: leading bytes of the formats that are refused by name
_OTHER_FORMATS = (
    (b"\xff\xd8\xff", "JPEG"),
    (b"GIF87a", "GIF"),
    (b"GIF89a", "GIF"),
    (b"BM", "BMP"),
)


class ImageError(ValueError):
    """An image this module does not read, or bytes that are no image."""


def sniff_format(data: bytes) -> str:
    """The image format the bytes start with: ``"PNG"``, ``"JPEG"``, one
    of the formats refused by name, or ``"unknown"``."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return "unknown"


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ImageError("bad PNG: truncated chunk")
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ImageError(f"bad PNG: CRC mismatch in {kind!r}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ImageError("bad PNG: no IEND chunk")


def _unfilter_rows(out: np.ndarray, filt: np.ndarray, ftypes: np.ndarray,
                   y0: int, y1: int) -> None:
    """Undo rows ``y0..y1-1`` of filter types None, Sub and Up, a row at a
    time: Sub is a running sum along the row per channel, Up adds the row
    above (uint8 arithmetic wraps mod 256)."""
    for y in range(y0, y1):
        line, ft = filt[y], ftypes[y]
        if ft == 0:
            out[y] = line
        elif ft == 1:
            out[y] = np.cumsum(line, axis=0, dtype=np.int64) & 0xFF
        else:
            out[y] = line + out[y - 1] if y else line


def _skewed(arr: np.ndarray, h: int, W: int) -> np.ndarray:
    """The ``[h + 1, W, bpp]`` view of a ``[W + h + 1, h + 1, bpp]`` array
    that puts pixel ``(y, x)`` at ``[x + y + 1, y]``: each anti-diagonal of
    the image is one contiguous row of ``arr``."""
    bpp = arr.shape[2]
    return np.lib.stride_tricks.as_strided(
        arr.reshape(-1)[(h + 1) * bpp:], shape=(h + 1, W, bpp),
        strides=((h + 2) * bpp, (h + 1) * bpp, 1))


def _unfilter_wave(out: np.ndarray, filt: np.ndarray, ftypes: np.ndarray,
                   y0: int, y1: int) -> None:
    """Undo rows ``y0..y1-1``, of any filter types. An Average or Paeth
    pixel reads its left, upper and upper-left neighbours once they are
    undone, so such a row is a sequential walk; but the pixels of one
    anti-diagonal (``x + y = d``) depend only on the two diagonals before
    it. So the rows, with the undone row above them first, are laid out
    skewed, a diagonal to a contiguous row, and undone a diagonal at a
    time: ``W + rows - 1`` numpy steps, where a walk takes one Python step
    a byte."""
    W, bpp, h = out.shape[1], out.shape[2], y1 - y0
    q = np.zeros((W + h + 1, h + 1, bpp), np.uint8)   # undone
    f = np.zeros_like(q)                               # filtered
    if y0:
        _skewed(q, h, W)[0] = out[y0 - 1]
    _skewed(f, h, W)[1:] = filt[y0:y1]
    # row 1 + y of a diagonal is image row y0 + y; its left neighbour is
    # the same row of the diagonal before, its upper neighbours row y of
    # the one and two diagonals before
    kinds = ftypes[y0:y1, None]
    # each filter type present but Paeth, with its rows: the predictor is
    # Paeth's unless a row's type picks another
    others = [(k, kinds == k) for k in (3, 2, 1, 0) if (kinds == k).any()]
    paeth = bool((kinds == 4).any())
    # (selections multiply by a mask: np.where is some 20x slower here)
    for d in range(2, W + h + 1):
        lo, hi = max(1, d - W), min(h, d - 1) + 1
        a = q[d - 1, lo:hi].astype(np.int16)
        b = q[d - 1, lo - 1:hi - 1].astype(np.int16)
        pred = None
        if paeth:
            c = q[d - 2, lo - 1:hi - 1].astype(np.int16)
            da, db = a - c, b - c
            pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
            # b over c where pb <= pc, then a over that where pa is least
            pred = c + db * (pb <= pc)
            pred += (a - pred) * ((pa <= pb) & (pa <= pc))
        for k, rows in others:
            alt = ((a + b) >> 1, b, a, 0)[3 - k]
            pred = (alt if pred is None
                    else pred + (alt - pred) * rows[lo - 1:hi - 1])
        q[d, lo:hi] = (f[d, lo:hi] + pred) & 0xFF
    out[y0:y1] = _skewed(q, h, W)[1:]


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """``[height, stride]`` uint8 samples from the decompressed scanlines
    (one filter byte, then ``stride`` bytes each), all in numpy. Rows of
    None, Sub and Up are undone a row at a time; the spans that hold
    Average or Paeth rows a diagonal at a time, in bands of at most
    ``max(W, 64)`` rows (so the skewed copy stays within about twice the
    band's bytes). Two such spans merge when fewer rows than the width
    part them, since a span costs ``W - 1`` steps more than its rows."""
    if len(raw) < height * (stride + 1):
        raise ImageError("bad PNG: image data shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    ftypes = rows[:, 0]
    if int(ftypes.max()) > 4:
        raise ImageError(f"bad PNG: unknown filter type {int(ftypes.max())}")
    width = stride // bpp
    filt = rows[:, 1:].reshape(height, width, bpp)
    out = np.empty((height, width, bpp), np.uint8)
    spans: List[List[int]] = []
    for y in np.flatnonzero(ftypes >= 3).tolist():
        if spans and y - spans[-1][1] < width:
            spans[-1][1] = y + 1
        else:
            spans.append([y, y + 1])
    band = max(width, 64)
    y = 0
    for y0, y1 in spans:
        _unfilter_rows(out, filt, ftypes, y, y0)
        for b0 in range(y0, y1, band):
            _unfilter_wave(out, filt, ftypes, b0, min(b0 + band, y1))
        y = y1
    _unfilter_rows(out, filt, ftypes, y, height)
    return out.reshape(height, stride)


def _unpack(rows: np.ndarray, width: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines ``[h, stride]`` -> samples ``[h, width, ch]``
    (uint8, or uint16 at 16 bits); sub-byte samples are unpacked high bits
    first."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, ch)
    if depth == 16:
        return rows.reshape(h, width, ch, 2).astype(np.uint16) @ \
            np.array([256, 1], np.uint16)
    per = 8 // depth
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :width, None]


def _samples(raw: bytes, width: int, height: int, ch: int, depth: int,
             interlace: int) -> np.ndarray:
    """The decompressed stream -> samples ``[height, width, ch]``, each
    Adam7 pass unfiltered on its own and scattered into place."""
    bits = ch * depth
    bpp = max(1, bits // 8)        # the filters' byte distance

    def image(pos: int, w: int, h: int) -> Tuple[np.ndarray, int]:
        stride = -(-w * bits // 8)
        n = h * (stride + 1)
        rows = _unfilter(raw[pos:pos + n], h, stride, bpp)
        return _unpack(rows, w, ch, depth), pos + n

    if not interlace:
        return image(0, width, height)[0]
    out = np.zeros((height, width, ch),
                   np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        px, pos = image(pos, w, h)
        out[y0::dy, x0::dx] = px
    return out


def _raw_size(width: int, height: int, bits: int, interlace: int) -> int:
    """The bytes of decompressed scanlines the header promises."""
    if not interlace:
        return height * (-(-width * bits // 8) + 1)
    n = 0
    for x0, y0, dx, dy in _ADAM7:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w > 0 and h > 0:
            n += h * (-(-w * bits // 8) + 1)
    return n


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``[H, W, 3]`` uint8 RGB (see the module note)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ImageError("not a PNG file")
    header = None
    palette = None
    idat: List[bytes] = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ImageError("bad PNG: IHDR length")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if len(body) % 3 or not body:
                raise ImageError("bad PNG: PLTE length")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ImageError("bad PNG: no IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS:
        raise ImageError(f"bad PNG: colour type {ctype}")
    if depth not in _DEPTHS[ctype]:
        raise ImageError(f"bad PNG: bit depth {depth} for colour type "
                         f"{ctype}")
    if comp or filt or interlace > 1:
        raise ImageError("bad PNG: unknown compression, filter or "
                         "interlace method")
    if width < 1 or height < 1:
        raise ImageError("bad PNG: empty image")
    if width * height > MAX_IMAGE_PIXELS:
        raise ImageError(f"image of {width}x{height} pixels is over the "
                         f"{MAX_IMAGE_PIXELS}-pixel limit (a decompression "
                         f"bomb?)")
    ch = _CHANNELS[ctype]
    need = _raw_size(width, height, ch * depth, interlace)
    try:
        # no more than the header's scanlines, however far the stream
        # would inflate
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ImageError(f"bad PNG: {e}") from None
    if len(raw) < need:
        raise ImageError("bad PNG: image data shorter than its header says")
    px = _samples(raw, width, height, ch, depth, interlace)
    if ctype == 3:
        if palette is None:
            raise ImageError("bad PNG: palette image without PLTE")
        if int(px.max()) >= len(palette):
            raise ImageError("bad PNG: palette index out of range")
        return palette[px[..., 0]]
    if depth == 16:
        # colour keeps the high byte; grey is PIL's I;16, clipped
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(np.uint8)
    elif depth < 8:
        px = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_image(data: bytes) -> np.ndarray:
    """Request image bytes -> ``[H, W, 3]`` uint8 RGB. PNG and JPEG are
    read; any other format raises :class:`ImageError` naming it."""
    fmt = sniff_format(data)
    if fmt == "PNG":
        return decode_png(data)
    if fmt == "JPEG":
        # imported here: models.jpeg imports this module's ImageError
        from .jpeg import decode_jpeg

        return decode_jpeg(data)
    if fmt == "unknown":
        raise ImageError("bad image: neither PNG nor JPEG (unrecognised "
                         "bytes)")
    raise ImageError(f"{fmt} images are not supported (PNG and JPEG only)")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """``[H, W, 3]`` uint8 RGB -> PNG bytes (see the module note)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ImageError(f"encode_png takes [H, W, 3] uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = 0      # filter type None on every row
    rows[:, 1:] = img.reshape(h, 3 * w)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_LEVEL))
            + _chunk(b"IEND", b""))


# -- Pillow's resize -----------------------------------------------------------

#: Pillow's fixed-point precision for 8-bit resampling (``Resample.c``)
_PRECISION_BITS = 32 - 8 - 2


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _cubic(x: float) -> float:
    """Pillow's ``bicubic_filter``: the cubic convolution kernel with a =
    -0.5."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


#: filter name -> (function, support)
_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


def _coefficients(in_size: int, out_size: int, kind: str = "bilinear"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``(bounds [out, 2] (first input, count), kk [out, ksize] int)``:
    Pillow's ``precompute_coeffs`` for the filter ``kind`` over the whole
    input, normalized, then rounded to fixed point as
    ``normalize_coeffs_8bpc`` rounds them."""
    fn, fsupport = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = sum(w)
        for x in range(xmax):
            v = w[x] / total if total != 0.0 else w[x]
            kk[xx, x] = int((-0.5 if v < 0 else 0.5)
                            + v * (1 << _PRECISION_BITS))
        bounds[xx] = (xmin, xmax)
    return bounds, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   kind: str = "bilinear") -> np.ndarray:
    """One pass of Pillow's resample along ``axis`` (1: horizontal, 0:
    vertical) of a ``[H, W, C]`` uint8 array, rounded and clipped to 8
    bits. The sums are int32, as Pillow's are: the weights of an output
    sum to about ``2 ** 22``, so a sum stays under ``255 * 2 ** 22 + 2 **
    21``."""
    bounds, kk = _coefficients(img.shape[axis], out_size, kind)
    shape = list(img.shape)
    shape[axis] = out_size
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    wshape = [1] * img.ndim
    wshape[axis] = out_size
    for x in range(kk.shape[1]):
        live = x < bounds[:, 1]
        idx = np.where(live, bounds[:, 0] + x, 0)
        w = np.where(live, kk[:, x], 0).astype(np.int32).reshape(wshape)
        acc += np.take(img, idx, axis=axis) * w
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, height: int, width: int, kind: str
            ) -> np.ndarray:
    """The horizontal pass first (only when the width changes), then the
    vertical one (only when the height changes), as ``ImagingResample``
    orders them."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_{kind} takes an [H, W, C] uint8 array")
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, 1, kind)
    if height != img.shape[0]:
        out = _resample_axis(out, height, 0, kind)
    return np.ascontiguousarray(out)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[height, width, C]`` uint8, equal to
    Pillow's ``Image.resize((width, height), Image.BILINEAR)``."""
    return _resize(img, height, width, "bilinear")


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[height, width, C]`` uint8, equal to
    Pillow's ``Image.resize((width, height))`` (its default filter,
    ``Image.BICUBIC``)."""
    return _resize(img, height, width, "bicubic")
