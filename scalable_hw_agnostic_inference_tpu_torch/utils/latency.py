"""Latency percentile collection and benchmark reports.

Port of ``scalable_hw_agnostic_inference_tpu/utils/latency.py``
(``LatencyCollector``: a thread-safe reservoir, Vitter's Algorithm R over
a seeded private stream, with percentile readout) and of
``serve/latency.py`` (``run_benchmark`` and ``BenchmarkReport``, the
functions behind ``POST /benchmark`` and ``GET /load/{n}/infer/{m}``; the
report keeps the reference's p0/p50/p90/p95/p99/p100 and throughput
shape).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

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


@dataclass
class BenchmarkReport:
    """Result of ``run_benchmark``: percentiles + throughput."""

    n_runs: int
    total_s: float
    latency_percentiles: Dict[str, float]
    throughput_rps: float
    extra: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        d = {
            "n_runs": self.n_runs,
            "total_time_s": round(self.total_s, 4),
            "throughput_rps": round(self.throughput_rps, 4),
        }
        d.update({k: round(v, 4) for k, v in self.latency_percentiles.items()})
        d.update(self.extra)
        return d


def run_benchmark(
    fn: Callable[[], object],
    n_runs: int,
    collector: Optional[LatencyCollector] = None,
    on_sample: Optional[Callable[[float], None]] = None,
) -> BenchmarkReport:
    """Call ``fn`` ``n_runs`` times, measuring per-call latency.

    ``on_sample`` receives each individual latency (the serving runtime feeds
    the metrics publisher with it so counters and histograms stay in lockstep).
    The serving runtime exposes this via ``POST /benchmark`` and
    ``GET /load/{n}/infer/{m}``, matching the reference's built-in
    measurement instrument (reference ``app/run-sd.py:157-175``).
    """
    local = LatencyCollector()
    t0 = time.perf_counter()
    for _ in range(n_runs):
        t1 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t1
        local.record(dt)
        if collector is not None:
            collector.record(dt)
        if on_sample is not None:
            on_sample(dt)
    total = time.perf_counter() - t0
    return BenchmarkReport(
        n_runs=n_runs,
        total_s=total,
        latency_percentiles=local.report(),
        throughput_rps=(n_runs / total) if total > 0 else 0.0,
    )
