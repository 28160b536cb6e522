"""Byte-level tokenizer for the offline and geometry tiers.

Port of ``scalable_hw_agnostic_inference_tpu/models/generate.py:97``
``ByteTokenizer``. The dense-cache ``make_generate`` path comes with the
dense-cache LLM units in a later slice.
"""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """ids: 0 = PAD, 1 = BOS, 2 = EOS, byte b -> 3 + b. Round-trips any
    UTF-8 text without a vocab file."""

    pad_id, bos_id, eos_id = 0, 1, 2
    vocab_size = 259

    def encode(self, text: str, max_len: int) -> tuple:
        raw = [self.bos_id] + [3 + b for b in text.encode("utf-8")][: max_len - 1]
        n = len(raw)
        ids = np.zeros((max_len,), np.int32)
        ids[:n] = raw
        return ids, n

    def decode(self, ids) -> str:
        # ids beyond the byte range (a model vocab may be larger) are dropped
        data = bytes(int(i) - 3 for i in ids if 3 <= int(i) < 3 + 256)
        return data.decode("utf-8", errors="replace")
