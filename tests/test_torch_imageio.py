"""The port's PIL-free image path against PIL and the JAX package, on the
CPU.

- ``decode_png`` equals ``PIL.Image.open(...).convert("RGB")`` on PNGs of
  colour types 0, 2, 3, 4 and 6 written here with every row filter
  (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth, cycling per row) at odd sizes,
  and on PNGs PIL writes itself (its own filter choice);
- ``resize_bilinear`` equals ``Image.resize(..., BILINEAR)`` value for
  value, upscaling and downscaling (where Pillow's filter widens);
- ``preprocess_tiled`` on a uint8 array against the JAX package's on the
  PIL image for 1, 2 and 4 tiles and a downscale, at the tiny tile and at
  Llama-3.2-11B-Vision's 560: tiles within one uint8 level before
  normalisation (``LEVEL``), equal ``ar_id`` and tile count;
- runs of Average and Paeth rows of every length, beside the other
  filters, equal PIL too;
- an image over Pillow's decompression-bomb limit is refused from its
  header, and a stream that would inflate far past its header is inflated
  no further;
- what is not read raises ``ImageError`` naming it: a CMYK JPEG, GIF, a
  PNG of a bit depth its colour type does not allow or of an unknown
  interlace method, bytes that are no image, a corrupted chunk (JPEG,
  16-bit and interlaced PNG are read since the soft-prefix slice:
  ``tests/test_torch_jpeg.py``).
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from scalable_hw_agnostic_inference_tpu.models import mllama as jmllama
from scalable_hw_agnostic_inference_tpu_torch.models import imageio
from scalable_hw_agnostic_inference_tpu_torch.models import mllama as tmllama

#: one uint8 level, in the units of a normalized tile: |diff| * std * 255
LEVEL = 1.0 + 1e-3

#: colour type -> channels per pixel
COLOUR = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ftype: int, cur: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray(len(cur))
    for i, x in enumerate(cur):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _write_png(px: np.ndarray, ctype: int, palette=None, depth: int = 8,
               interlace: int = 0, filters=(0, 1, 2, 3, 4)) -> bytes:
    """``px`` ``[H, W, channels]`` uint8 as a PNG whose rows cycle through
    ``filters`` (by default the five filter types)."""
    h, w, ch = px.shape
    rows = bytearray()
    prev = bytes(w * ch)
    for y in range(h):
        cur = px[y].tobytes()
        ftype = filters[y % len(filters)]
        rows += bytes([ftype]) + _filter_row(ftype, cur, prev, ch)
        prev = cur
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(bytes(rows))) + _chunk(
        b"IEND", b"")


@pytest.mark.parametrize("ctype", sorted(COLOUR))
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (31, 9)])
def test_png_every_filter_equals_pil(ctype, size):
    rng = np.random.default_rng(ctype * 100 + size[0])
    h, w = size
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (11, 3), np.uint8)
        px = rng.integers(0, 11, (h, w, 1), np.uint8)
    else:
        px = rng.integers(0, 256, (h, w, COLOUR[ctype]), np.uint8)
    data = _write_png(px, ctype, palette)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = imageio.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype", [0, 2, 6])
@pytest.mark.parametrize("filters", [(4,), (3,), (3, 4), (1, 4, 4, 2, 3, 0)])
@pytest.mark.parametrize("size", [(9, 1), (6, 23), (17, 12)])
def test_png_filter_runs_equal_pil(ctype, filters, size):
    """Runs of Average and Paeth rows (undone a diagonal at a time) of
    every length, between and beside runs of the other filters."""
    rng = np.random.default_rng(ctype + 10 * len(filters) + size[1])
    px = rng.integers(0, 256, size + (COLOUR[ctype],), np.uint8)
    data = _write_png(px, ctype, filters=filters)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(imageio.decode_png(data), want)


def test_png_over_the_pixel_limit_is_refused_from_its_header():
    """Pillow's decompression-bomb limit, read from IHDR before any data is
    inflated: a 20,000 x 20,000 header over a few bytes of data."""
    w = h = 20000
    assert w * h > imageio.MAX_IMAGE_PIXELS
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(64)))
            + _chunk(b"IEND", b""))
    with pytest.raises(imageio.ImageError, match="pixel limit"):
        imageio.decode_image(data)


def test_png_stream_is_inflated_no_further_than_its_header():
    """A 16 x 16 header over 16 MiB of zeros deflated to some 16 KiB: the
    decoder inflates the header's 16 x 49 bytes and no more."""
    import tracemalloc

    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 16, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(16 << 20), 9))
            + _chunk(b"IEND", b""))
    assert len(data) < (64 << 10)
    tracemalloc.start()
    try:
        got = imageio.decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, np.zeros((16, 16, 3), np.uint8))
    assert peak < (1 << 20), peak


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_written_by_pil(mode):
    rng = np.random.default_rng(7)
    # a smooth image, so that PIL's own filter choice varies by row
    y, x = np.mgrid[0:45, 0:67]
    base = np.stack([x * 3, y * 5, (x + y) * 2], -1) % 256
    arr = (base + rng.integers(0, 4, base.shape)).astype(np.uint8)
    img = Image.fromarray(arr)
    img = (img.convert("P", palette=Image.ADAPTIVE) if mode == "P"
           else img.convert(mode))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(imageio.decode_image(buf.getvalue()), want)


@pytest.mark.parametrize("shape", [(40, 70, 32, 56), (300, 200, 560, 373),
                                   (1000, 1200, 467, 560), (33, 47, 33, 20),
                                   (8, 9, 56, 60), (50, 30, 50, 30)])
def test_resize_bilinear_equals_pillow(shape):
    h, w, nh, nw = shape
    arr = np.random.default_rng(h).integers(0, 256, (h, w, 3), np.uint8)
    want = np.asarray(Image.fromarray(arr).resize((nw, nh), Image.BILINEAR))
    np.testing.assert_array_equal(imageio.resize_bilinear(arr, nh, nw), want)


TINY = tmllama.MllamaVisionConfig.tiny()
TINY4 = tmllama.MllamaVisionConfig(**dict(
    vars(TINY), max_num_tiles=4, max_aspect_ratio_id=4))
TINY4_RATIOS = [[1, 1], [1, 2], [2, 1], [2, 2]]
FULL = tmllama.MllamaVisionConfig()
FULL_RATIOS = [[1, 1], [1, 2], [1, 3], [1, 4], [2, 1], [2, 2], [3, 1],
               [4, 1]]


@pytest.mark.parametrize("cfg,ratios,hw,tiles", [
    (TINY4, TINY4_RATIOS, (20, 25), 1),       # one tile, upscaled
    (TINY4, TINY4_RATIOS, (20, 50), 2),       # 1 x 2
    (TINY4, TINY4_RATIOS, (61, 58), 4),       # 2 x 2
    (TINY4, TINY4_RATIOS, (200, 150), 4),     # a downscale
    (FULL, FULL_RATIOS, (1120, 1120), 4),     # 2 x 2 at 560, no resize
    (FULL, FULL_RATIOS, (1300, 900), 4),      # a downscale at 560
    (FULL, FULL_RATIOS, (300, 500), 1),       # one upscaled tile at 560
])
def test_preprocess_tiled_equals_reference(cfg, ratios, hw, tiles):
    rng = np.random.default_rng(hw[0])
    arr = rng.integers(0, 256, hw + (3,), np.uint8)
    jcfg = jmllama.MllamaVisionConfig(**vars(cfg))
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    want, w_ar, w_n = jmllama.preprocess_tiled(Image.fromarray(arr), jcfg,
                                               ratios, mean=mean, std=std)
    got, g_ar, g_n = tmllama.preprocess_tiled(arr, cfg, ratios, mean=mean,
                                              std=std)
    assert (g_ar, g_n) == (w_ar, w_n) and g_n == tiles
    assert got.shape == want.shape and got.dtype == np.float32
    levels = np.abs(got - want) * np.asarray(std, np.float32) * 255.0
    assert levels.max() <= LEVEL


def test_random_image_is_the_reference_contract():
    rng = np.random.default_rng(0)
    want = rng.integers(0, 255, (560, 560, 3), np.uint8)
    np.testing.assert_array_equal(tmllama.random_image(FULL), want)


def _jpeg() -> bytes:
    buf = io.BytesIO()
    Image.new("CMYK", (16, 16), (200, 30, 30, 9)).save(buf, format="JPEG")
    return buf.getvalue()


def _gif() -> bytes:
    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (200, 30, 30)).save(buf, format="GIF")
    return buf.getvalue()


def _png16() -> bytes:
    """An RGB PNG of 4-bit samples, a depth colour type 2 does not allow."""
    return _write_png(np.zeros((4, 4, 3), np.uint8), 2, depth=4)


def _corrupt() -> bytes:
    data = bytearray(_write_png(np.zeros((3, 3, 3), np.uint8), 2))
    data[40] ^= 0xFF     # inside IDAT: the chunk's CRC no longer holds
    return bytes(data)


@pytest.mark.parametrize("make,words", [
    (_jpeg, "CMYK/YCCK .4-component. JPEG images are not supported"),
    (_gif, "GIF images are not supported"),
    (_png16, "bit depth 4 for colour type 2"),
    (lambda: _write_png(np.zeros((4, 4, 3), np.uint8), 2, interlace=2),
     "interlace method"),
    (lambda: b"not an image at all", "neither PNG nor JPEG"),
    (_corrupt, "CRC"),
])
def test_what_is_not_read_raises(make, words):
    with pytest.raises(imageio.ImageError, match=words):
        imageio.decode_image(make())
