"""Prompt-affinity digests: the warm-prefix advertisement of a pod.

Copy of ``scalable_hw_agnostic_inference_tpu/kvtier/affinity.py``. The
prefix cache and the host tier are keyed by token-block chain hashes,
which a router without a tokenizer cannot compute; the shared proxy is a
digest of the prompt's leading characters. Two prompts whose leading
blocks of tokens match share their leading text, so a digest over a
block-sized character window is a sound (slightly over-eager, never
token-wrong) warmth signal. A pod digests every prompt it serves and
advertises a bounded LRU of recent digests under ``/stats`` ->
``kvtier.affinity``; the digest must be the JAX package's bit for bit, so
that one router reads both kinds of pod.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List

#: characters of leading prompt text the digest commits to — roughly one
#: KV block's worth of tokens for typical tokenizers (block_size 16-64
#: tokens x ~4 chars/token); a shared digest implies shared leading blocks
AFFINITY_CHARS = 256
#: hex chars kept per digest (64 bits — collision-safe for a routing hint)
AFFINITY_HEX = 16


def prompt_affinity(text: str, n_chars: int = AFFINITY_CHARS) -> str:
    """Stable digest of the prompt's leading ``n_chars`` characters."""
    head = text[:n_chars].encode("utf-8", errors="replace")
    return hashlib.sha1(head).hexdigest()[:AFFINITY_HEX]


class AffinityTracker:
    """Bounded LRU set of recently served prompt digests (thread-safe:
    every serving-lane thread notes into it; the /stats scrape reads)."""

    def __init__(self, max_entries: int = 128):
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._digests: "OrderedDict[str, None]" = OrderedDict()

    def note(self, digest: str) -> None:
        with self._lock:
            self._digests.pop(digest, None)
            self._digests[digest] = None
            while len(self._digests) > self.max_entries:
                self._digests.popitem(last=False)

    def snapshot(self) -> List[str]:
        """Most-recent-last list of advertised digests."""
        with self._lock:
            return list(self._digests)
