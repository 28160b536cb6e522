"""Shared per-unit helpers: SSE detokenization and request images.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/serve/units/common.py``
(``SseTextAssembler``, ``:43``; ``decode_image``, ``:180``). The tokenizer
helpers come with the units that use them.
"""

from __future__ import annotations

import base64
import binascii
from typing import Any, Dict

import numpy as np

from ...models import imageio


def decode_image(payload: Dict[str, Any], size: int) -> np.ndarray:
    """A request's ``image_b64`` (base64 PNG or JPEG, or ``"random"``) ->
    normalized NHWC ``[1, size, size, 3]`` f32, the reference's
    ``decode_image``: ``"random"`` (or none) is ``default_rng(0)``'s
    standard normals, unnormalized; an image is decoded to RGB as PIL's
    ``open(...).convert("RGB")`` gives it, resized as PIL's default
    ``resize((size, size))`` does (bicubic), scaled to [0, 1] and
    normalized by HF CLIP's 0.5/0.5, all through ``models.imageio``.
    Bytes that are no base64, or no image it reads, raise
    ``imageio.ImageError``."""
    b64 = payload.get("image_b64", "")
    if not b64 or b64 == "random":
        rng = np.random.default_rng(0)
        return rng.standard_normal((1, size, size, 3)).astype(np.float32)
    try:
        # not validated, as the reference decodes it: characters outside
        # the alphabet (line breaks) are skipped
        data = base64.b64decode(str(b64))
    except (binascii.Error, ValueError) as e:
        raise imageio.ImageError(f"not base64 ({e})") from None
    img = imageio.resize_bicubic(imageio.decode_image(data), size, size)
    return ((img.astype(np.float32) / 255.0 - 0.5) / 0.5)[None]


class SseTextAssembler:
    """Incremental detokenization for SSE token streams.

    Three properties the naive decode-everything loop lacks:

    - **bounded re-decode**: only the held (unflushed) token window is
      re-decoded per token, compacting at whitespace boundaries — O(n·W),
      not O(n²), and lock hold time stays constant;
    - **stop sequences never leak**: text ending with a proper prefix of a
      stop string is held back until the next token disambiguates, so a stop
      spanning a token boundary is truncated exactly like the non-streaming
      path;
    - **partial-UTF-8 holdback with end flush**: trailing U+FFFD is held (it
      may be half a multi-byte sequence) but ``finish()`` flushes it, since
      a model can legitimately end on undecodable bytes.
    """

    # forced compaction bound: newline boundaries are the safe reset points
    # (a mid-sequence suffix re-decode can drop a sentencepiece leading
    # space), so only force a reset once the window grows well past any
    # reasonable line length
    COMPACT_AT = 128

    def __init__(self, decode_fn, stops=()):
        self.decode = decode_fn
        self.stops = [s for s in stops if s]
        self.held: list = []
        self.sent = 0          # chars of the held window already emitted
        self.stopped = False

    def _holdback(self, h: str) -> int:
        """Chars at the end of ``h`` that must not be emitted yet."""
        safe = len(h)
        while safe > 0 and h[safe - 1] == "�":
            safe -= 1
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, safe), 0, -1):
                if h[:safe].endswith(s[:k]):
                    hold = max(hold, k)
                    break
        return safe - hold

    def push(self, tok: int) -> str:
        """Feed one token; return the text delta now safe to emit."""
        if self.stopped:
            return ""
        self.held.append(int(tok))
        h = self.decode(self.held)
        for s in self.stops:
            cut = h.find(s)
            if cut >= 0:
                self.stopped = True
                delta = h[self.sent:cut] if cut > self.sent else ""
                self.sent = len(h)
                return delta
        safe = self._holdback(h)
        delta = h[self.sent:safe] if safe > self.sent else ""
        self.sent = safe
        if self.sent == len(h) and h:
            if h.endswith("\n"):
                self.held = []
                self.sent = 0
            elif len(self.held) >= self.COMPACT_AT:
                # forced mid-line compaction keeps ONE overlap token: the
                # next window then decodes with a preceding-token context,
                # so sentencepiece leading-space normalization cannot drop
                # a space at the seam. sent re-anchors to the
                # overlap token's solo decode — the new window's coordinate
                # system.
                self.held = self.held[-1:]
                self.sent = len(self.decode(self.held))
        return delta

    def finish(self) -> str:
        """End of stream: flush anything the holdbacks retained."""
        if self.stopped or not self.held:
            return ""
        h = self.decode(self.held)
        delta = h[self.sent:]
        self.sent = len(h)
        return delta
