"""Binary frame codec for KV block transport (``GET /kv/blocks``).

Copy of ``scalable_hw_agnostic_inference_tpu/kvnet/frames.py``, byte for
byte on the wire: a JAX pod decodes the port's frames and the port
decodes a JAX pod's. One frame per block entry, byte-exact by
construction: array payloads are raw ``tobytes()`` and decode via
``frombuffer`` with the original dtype and shape -- a bf16 block or an
int8 block with its f32 scale rows crosses the wire bit-identical.

Wire format (all little-endian)::

    stream  := frame*
    frame   := u64 body_len | u32 crc32(body) | body
    body    := magic "KVNF" | u8 version | i64 hash | u8 n_arrays | array*
    array   := u8 dtype_len | dtype_name | u8 ndim | u32 dims[ndim]
               | u64 data_len | data

numpy has no bfloat16, and the reference reaches it through ``ml_dtypes``,
which the port does not use. The port holds bf16 blocks as 16-bit words
in :data:`BF16`, an int16 dtype whose metadata carries the wire name
``bfloat16``; the encoder writes that name (:func:`wire_name`), so the
frames say ``bfloat16`` as a JAX pod's do, and the decoder maps a
``bfloat16`` frame to :data:`BF16` whether or not ``ml_dtypes`` is
importable.

Decoding is strict: a truncated stream, a bad magic/version, a CRC
mismatch, an over-limit dimension count, or a payload whose length does
not equal ``prod(dims) * itemsize`` all raise :class:`FrameError` -- the
client treats any decode failure as a transport failure and degrades to
recompute (it never publishes a half-parsed block into the tier).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

MAGIC = b"KVNF"
VERSION = 1

#: sanity bounds a hostile/corrupt stream is rejected against
MAX_NDIM = 8
MAX_DTYPE_CHARS = 16
MAX_BODY_BYTES = 1 << 31

_PREFIX = struct.Struct("<QI")      # body_len, crc32
_HEAD = struct.Struct("<4sBqB")     # magic, version, hash, n_arrays


class FrameError(ValueError):
    """Malformed / truncated / corrupt frame stream."""


#: bfloat16 as the port holds it: raw 16-bit words in an int16 dtype whose
#: metadata names the wire dtype (the metadata rides views, slices, copies
#: and ``frombuffer``; it is dropped by ``np.stack``, after which the tier
#: views its storage back through this dtype)
BF16 = np.dtype("<i2", metadata={"wire": "bfloat16"})


def wire_name(dt: np.dtype) -> str:
    """The dtype name a frame carries: ``bfloat16`` for :data:`BF16` (and
    for an ``ml_dtypes`` bfloat16 array), else numpy's own name."""
    dt = np.dtype(dt)
    return (dt.metadata or {}).get("wire", dt.name)


def _np_dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        return BF16
    return np.dtype(name)


def encode_frames(entries: Sequence[Tuple]) -> bytes:
    """Encode ``(hash, *arrays)`` entries — the exact tuples
    ``HostKVTier.get_run`` returns — into one frame stream."""
    out = []
    for ent in entries:
        h, arrays = int(ent[0]), ent[1:]
        parts = [_HEAD.pack(MAGIC, VERSION, h, len(arrays))]
        for a in arrays:
            a = np.ascontiguousarray(a)
            name = wire_name(a.dtype).encode("ascii")
            if len(name) > MAX_DTYPE_CHARS or a.ndim > MAX_NDIM:
                raise FrameError(
                    f"unencodable array (dtype {a.dtype}, ndim {a.ndim})")
            parts.append(struct.pack("<B", len(name)) + name)
            parts.append(struct.pack("<B", a.ndim)
                         + struct.pack(f"<{a.ndim}I", *a.shape))
            data = a.tobytes()
            parts.append(struct.pack("<Q", len(data)))
            parts.append(data)
        body = b"".join(parts)
        out.append(_PREFIX.pack(len(body), zlib.crc32(body)))
        out.append(body)
    return b"".join(out)


def _parse_body(body: bytes) -> Tuple:
    if len(body) < _HEAD.size:
        raise FrameError("frame body shorter than its header")
    magic, version, h, n_arrays = _HEAD.unpack_from(body, 0)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if version != VERSION:
        raise FrameError(f"unsupported frame version {version}")
    off = _HEAD.size
    arrays = []
    for _ in range(n_arrays):
        if off + 1 > len(body):
            raise FrameError("truncated array header")
        (dlen,) = struct.unpack_from("<B", body, off)
        off += 1
        if dlen > MAX_DTYPE_CHARS or off + dlen + 1 > len(body):
            raise FrameError("truncated / over-long dtype name")
        try:
            dt = _np_dtype(body[off:off + dlen].decode("ascii"))
        except (TypeError, UnicodeDecodeError) as e:
            raise FrameError(f"unknown array dtype: {e}")
        off += dlen
        (ndim,) = struct.unpack_from("<B", body, off)
        off += 1
        if ndim > MAX_NDIM or off + 4 * ndim + 8 > len(body):
            raise FrameError("truncated / over-limit dims")
        dims = struct.unpack_from(f"<{ndim}I", body, off)
        off += 4 * ndim
        (data_len,) = struct.unpack_from("<Q", body, off)
        off += 8
        want = int(np.prod(dims, dtype=np.int64)) * dt.itemsize if ndim \
            else dt.itemsize
        if data_len != want:
            raise FrameError(
                f"payload length {data_len} != shape {dims} x {dt}")
        if off + data_len > len(body):
            raise FrameError("truncated array payload")
        arrays.append(np.frombuffer(
            body[off:off + data_len], dt).reshape(dims).copy())
        off += data_len
    if off != len(body):
        raise FrameError(f"{len(body) - off} trailing bytes in frame body")
    return (h, *arrays)


def decode_frames(data: bytes) -> List[Tuple]:
    """Decode a frame stream back into ``(hash, *arrays)`` entries.
    Raises :class:`FrameError` on ANY malformation — partial results are
    never returned (a short read must not publish a half-run)."""
    out: List[Tuple] = []
    off = 0
    view = memoryview(data)
    while off < len(data):
        if off + _PREFIX.size > len(data):
            raise FrameError("truncated frame length prefix")
        body_len, crc = _PREFIX.unpack_from(view, off)
        off += _PREFIX.size
        if body_len > MAX_BODY_BYTES:
            raise FrameError(f"frame body length {body_len} over limit")
        if off + body_len > len(data):
            raise FrameError("truncated frame body")
        body = bytes(view[off:off + body_len])
        if zlib.crc32(body) != crc:
            raise FrameError("frame CRC mismatch")
        out.append(_parse_body(body))
        off += body_len
    return out
