"""Static-shape bucketing: requests pad up to the nearest registered bucket.

Port of ``scalable_hw_agnostic_inference_tpu/core/bucketing.py``
(``pow2_buckets``, ``BucketRegistry``). PyTorch runs eagerly and needs no
recompile guard, but the engine keeps the reference's bucketed prefill and
decode shapes so that both packages run the same shapes, and the kernels
the same launch geometry.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List


def pow2_buckets(lo: int, hi: int) -> List[int]:
    """Powers of two covering [lo, hi], inclusive of a final ``hi``
    bucket."""
    out = []
    b = 1
    while b < lo:
        b *= 2
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


class BucketRegistry:
    """Sorted shape buckets for one dynamic dimension (e.g. sequence length)."""

    def __init__(self, buckets: Iterable[int]):
        bs = sorted(set(int(b) for b in buckets))
        if not bs or bs[0] < 1:
            raise ValueError(f"invalid buckets {bs}")
        self.buckets: List[int] = bs

    @property
    def max(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n. Raises if n exceeds the largest bucket."""
        if n > self.max:
            raise ValueError(f"length {n} exceeds max bucket {self.max}")
        i = bisect.bisect_left(self.buckets, max(n, 1))
        return self.buckets[i]
