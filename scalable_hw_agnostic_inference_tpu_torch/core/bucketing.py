"""Static-shape bucketing: requests pad up to the nearest registered bucket.

Port of ``scalable_hw_agnostic_inference_tpu/core/bucketing.py``
(``BucketRegistry``). PyTorch runs eagerly and needs no
recompile guard, but the engine keeps the reference's bucketed prefill and
decode shapes so that both packages run the same shapes, and the kernels
the same launch geometry.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List


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
