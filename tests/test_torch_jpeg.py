"""The port's image decoders and Pillow's bicubic resize against PIL, value
for value, on the CPU.

``models/jpeg.py`` and ``models/imageio.py`` decode without PIL what the
JAX package opens with PIL (``serve/units/common.py:180-200``:
``Image.open(...).convert("RGB")``, then ``resize((w, h))``, bicubic).
Every case holds the port's pixels equal to PIL's (Pillow with
libjpeg-turbo) on the same bytes:

- JPEG written by PIL: baseline, extended (SOF1: 16-bit tables),
  progressive (libjpeg's successive-approximation script), 4:4:4, 4:2:2
  and 4:2:0, grayscale, restart intervals, optimized tables, image sizes
  off the MCU grid down to one pixel;
- JPEG written by ``chip_smoke._jpeg_bytes`` (the images the chip run
  serves): 4:4:0 too, progressive by spectral selection, restarts in
  every scan;
- PNG of every mode PIL opens: grey at 1, 2, 4, 8 and 16 bits, RGB and
  RGBA at 8 and 16, grey + alpha, palette at 1 to 8 bits with and without
  ``tRNS``, each plain and Adam7-interlaced, every filter type;
- the bicubic resize up and down and to the tower's 336 px;
- ``serve.units.common.decode_image`` against the JAX package's, array
  for array, and what is not read: arithmetic-coded, lossless and 12-bit
  JPEG, CMYK, GIF, bytes that are no image or no base64, each a
  ``ImageError`` naming it.
"""

import base64
import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from scalable_hw_agnostic_inference_tpu.serve.units import common as jcommon
from scalable_hw_agnostic_inference_tpu_torch.models import imageio, jpeg
from scalable_hw_agnostic_inference_tpu_torch.serve.units import (
    common as tcommon,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _photo(h: int, w: int, seed: int = 0) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 13),
                    128 + 90 * np.cos(x / 5 - y / 9), (x * 3 + y * 2) % 256],
                   2) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img: np.ndarray, mode: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


PIL_JPEG = [
    {}, {"subsampling": 0}, {"subsampling": 1}, {"subsampling": 2},
    {"quality": 97, "subsampling": 2}, {"quality": 5},
    {"progressive": True}, {"progressive": True, "subsampling": 0},
    {"progressive": True, "subsampling": 1, "quality": 100},
    {"restart_marker_blocks": 3},
    {"progressive": True, "restart_marker_rows": 1},
    {"optimize": True}, {"qtables": [[300] * 64, [400] * 64]},
]


@pytest.mark.parametrize("size", [(37, 53), (64, 64), (17, 9), (1, 1),
                                  (2, 3), (120, 77)])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_pil_jpeg_equals_pil(size, mode):
    img = _photo(*size, seed=size[0])
    for kw in PIL_JPEG:
        data = _pil_jpeg(img, mode, **kw)
        got = jpeg.decode_jpeg(data)
        want = _pil(data)
        assert got.dtype == np.uint8 and got.shape == want.shape, kw
        np.testing.assert_array_equal(got, want, err_msg=str(kw))


@pytest.mark.parametrize("sampling", list(chip_smoke.JPEG_SAMPLING))
def test_chip_smoke_jpeg_equals_pil(sampling):
    rng = np.random.default_rng(1)
    for h, w in ((37, 53), (16, 16), (9, 17), (1, 1), (50, 3)):
        y, x = np.mgrid[0:h, 0:w]
        img = np.clip(np.stack([x * 5, y * 7, (x + y) * 3], 2)
                      + rng.integers(0, 40, (h, w, 3)), 0, 255
                      ).astype(np.uint8)
        for kw in ({}, {"progressive": True}, {"restart": 2},
                   {"progressive": True, "restart": 3},
                   {"extended": True, "quality": 1}):
            data = chip_smoke._jpeg_bytes(img, sampling, **kw)
            np.testing.assert_array_equal(
                imageio.decode_image(data), _pil(data),
                err_msg=f"{sampling} {(h, w)} {kw}")


def test_jpeg_refinement_paths_are_taken():
    """PIL's progressive script refines DC and AC (Ah > 0) and runs
    end-of-band runs past one block: the cases above reach those paths."""
    data = _pil_jpeg(_photo(64, 64), "RGB", progressive=True)
    scans = [data[i + 2:i + 16] for i in range(len(data) - 1)
             if data[i] == 0xFF and data[i + 1] == 0xDA]
    # each scan header: length, Ns, Ns component specs, Ss, Se, Ah|Al
    ah = [sc[5 + 2 * sc[2]] >> 4 for sc in scans]
    assert any(a > 0 for a in ah) and len(scans) >= 6


# -- PNG -------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """``[h, w, ch]`` samples -> ``[h, stride]`` scanline bytes."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.pad(flat, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    return (flat << shifts).sum(axis=2).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, start: int) -> bytes:
    """Each row filtered with types cycling 0..4 from ``start``."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = (y + start) % 5
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out += bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _png(samples, ctype, depth, interlace=0, palette=None, trns=None):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for i, (x0, y0, dx, dy) in enumerate(_ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filtered(_pack(sub, depth), bpp, i)
    else:
        raw = _filtered(_pack(samples, depth), bpp, 0)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = imageio.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _png_cases():
    rng = np.random.default_rng(2)
    h, w = 13, 19
    cases = []
    for depth in (1, 2, 4, 8, 16):
        cases.append((f"grey{depth}", rng.integers(
            0, 1 << depth, (h, w, 1)), 0, depth, None, None))
    cases.append(("grey16-low", rng.integers(0, 600, (h, w, 1)), 0, 16,
                  None, None))
    for depth in (8, 16):
        top = 1 << depth
        cases += [(f"rgb{depth}", rng.integers(0, top, (h, w, 3)), 2, depth,
                   None, None),
                  (f"rgba{depth}", rng.integers(0, top, (h, w, 4)), 6,
                   depth, None, None),
                  (f"la{depth}", rng.integers(0, top, (h, w, 2)), 4, depth,
                   None, None)]
    for depth in (1, 2, 4, 8):
        n = min(1 << depth, 200)
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (h, w, 1))
        cases.append((f"palette{depth}", idx, 3, depth, pal, None))
        cases.append((f"palette{depth}-trns", idx, 3, depth, pal,
                      bytes(rng.integers(0, 256, n).astype(np.uint8))))
    cases.append(("grey8-trns", rng.integers(0, 256, (h, w, 1)), 0, 8, None,
                  b"\x00\x10"))
    return cases


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("case", _png_cases(), ids=lambda c: c[0])
def test_png_modes_equal_pil(case, interlace):
    _, samples, ctype, depth, pal, trns = case
    data = _png(samples, ctype, depth, interlace, pal, trns)
    got = imageio.decode_image(data)
    want = _pil(data)
    np.testing.assert_array_equal(got, want)


def test_interlaced_png_of_tiny_sizes():
    """Adam7 passes that are empty (an image narrower or shorter than a
    pass's first column or row)."""
    rng = np.random.default_rng(3)
    for h, w in ((1, 1), (1, 5), (3, 1), (2, 9)):
        s = rng.integers(0, 256, (h, w, 3))
        data = _png(s, 2, 8, interlace=1)
        np.testing.assert_array_equal(imageio.decode_image(data), _pil(data))


# -- the resize and the request path -------------------------------------------


@pytest.mark.parametrize("shape,size", [
    ((37, 53), (336, 336)), ((400, 301), (336, 336)), ((5, 7), (3, 2)),
    ((336, 336), (336, 336)), ((100, 30), (17, 200)), ((1, 1), (4, 4))])
def test_bicubic_equals_pil(shape, size):
    img = np.random.default_rng(4).integers(0, 256, shape + (3,), np.uint8)
    H, W = size
    want = np.asarray(Image.fromarray(img).resize((W, H)))
    np.testing.assert_array_equal(imageio.resize_bicubic(img, H, W), want)


@pytest.mark.parametrize("kind", ["png", "jpeg", "jpeg-progressive",
                                  "random", "empty"])
def test_decode_image_equals_the_reference(kind):
    img = _photo(45, 61, seed=5)
    if kind == "png":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
    elif kind.startswith("jpeg"):
        b64 = base64.b64encode(_pil_jpeg(
            img, "RGB", progressive=kind.endswith("progressive"))).decode()
    else:
        b64 = "random" if kind == "random" else ""
    payload = {"image_b64": b64}
    want = jcommon.decode_image(payload, 32)
    got = tcommon.decode_image(payload, 32)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcommon.decode_image(payload, 24),
                                  jcommon.decode_image(payload, 24))


def _jpeg_header(marker: int, precision: int = 8, nf: int = 3) -> bytes:
    sof = struct.pack(">BHHB", precision, 8, 8, nf) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(nf))
    return (b"\xff\xd8\xff" + bytes([marker]) + struct.pack(">H", len(sof) + 2)
            + sof + b"\xff\xd9")


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(buf, "JPEG")
    return buf.getvalue()


def _gif() -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (200, 30, 30)).save(buf, "GIF")
    return buf.getvalue()


@pytest.mark.parametrize("make,words", [
    (lambda: _jpeg_header(0xC9), "arithmetic-coded"),
    (lambda: _jpeg_header(0xCA), "arithmetic-coded progressive"),
    (lambda: _jpeg_header(0xC3), "lossless"),
    (lambda: _jpeg_header(0xC1, precision=12), "12-bit JPEG"),
    (_cmyk, "CMYK"),
    (chip_smoke._cmyk_jpeg, "CMYK"),
    (_gif, "GIF images are not supported"),
    (lambda: b"\xff\xd8\xff\xe0" + bytes(64), "bad JPEG"),
    (lambda: _pil_jpeg(_photo(16, 16), "RGB")[:-40], "bad JPEG"),
])
def test_jpeg_not_read_raises(make, words):
    with pytest.raises(imageio.ImageError, match=words):
        imageio.decode_image(make())


def test_bad_base64_and_the_pixel_limit_raise():
    with pytest.raises(imageio.ImageError, match="base64"):
        tcommon.decode_image({"image_b64": "abc"}, 32)
    huge = _jpeg_header(0xC0)
    huge = huge.replace(struct.pack(">HH", 8, 8), struct.pack(">HH", 60000,
                                                              60000))
    with pytest.raises(imageio.ImageError, match="pixel limit"):
        imageio.decode_image(huge)


@pytest.mark.parametrize("size", [(4097, 4096), (4096, 4097), (8192, 8192)])
def test_jpeg_over_its_pixel_cap_is_refused_from_the_frame_header(size):
    """A real small JPEG with a frame header planted past the JPEG cap (but
    under the PNG decoder's limit) is refused before its scan is read, with
    a message that names the cap, through the unit's ``decode_image``."""
    w, h = size
    assert w * h > jpeg.MAX_JPEG_PIXELS and \
        w * h <= imageio.MAX_IMAGE_PIXELS
    data = _pil_jpeg(_photo(16, 16), "RGB")
    sof = data.index(b"\xff\xc0")
    at = sof + 5        # marker, length, precision, then height, width
    assert struct.unpack(">HH", data[at:at + 4]) == (16, 16)
    data = data[:at] + struct.pack(">HH", h, w) + data[at + 4:]
    payload = {"image_b64": base64.b64encode(data).decode()}
    with pytest.raises(imageio.ImageError,
                       match=f"{w}x{h} pixels is over the "
                             f"{jpeg.MAX_JPEG_PIXELS}-pixel limit for JPEG"):
        tcommon.decode_image(payload, 32)
