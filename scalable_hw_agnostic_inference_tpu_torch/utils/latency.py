"""Latency percentile collection for the engine's TTFT/TPOT instruments.

Port of ``scalable_hw_agnostic_inference_tpu/utils/latency.py``
(``LatencyCollector``): a thread-safe reservoir (Vitter's Algorithm R over
a seeded private stream) with percentile readout.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

PERCENTILES = (0, 50, 90, 95, 99, 100)


class LatencyCollector:
    def __init__(self, max_samples: int = 100_000,
                 seed: Optional[int] = 0x5EED):
        self._lock = threading.Lock()
        self._samples: List[float] = []
        self._max_samples = max_samples
        self._total = 0
        self._rng = random.Random(seed)

    def record(self, latency_s: float) -> None:
        with self._lock:
            self._total += 1
            if len(self._samples) < self._max_samples:
                self._samples.append(latency_s)
            else:
                j = self._rng.randrange(self._total)
                if j < self._max_samples:
                    self._samples[j] = latency_s

    @property
    def count(self) -> int:
        with self._lock:
            return self._total

    @staticmethod
    def _interp(data: List[float], p: float) -> float:
        if not data:
            return 0.0
        if p <= 0:
            return data[0]
        if p >= 100:
            return data[-1]
        rank = (p / 100.0) * (len(data) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(data) - 1)
        frac = rank - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    def report(self) -> Dict[str, float]:
        with self._lock:
            data = sorted(self._samples)
        return {f"p{p}": self._interp(data, p) for p in PERCENTILES}
