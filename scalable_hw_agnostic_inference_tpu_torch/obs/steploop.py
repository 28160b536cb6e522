"""Engine step telemetry: the counters and the histogram the async decode
pipeline feeds.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/obs/steploop.py``: the
reference's names for what the engine and ``/stats`` read here —
``StepTelemetry.count_recompile`` (``:184``), ``count_flush`` with
``pipeline_flushes`` and ``flush_reasons`` (``:188``), ``warmed_executables``
and the ``step_gap`` histogram over :data:`STEP_GAP_BUCKETS` (``:39``,
``:145``), on the reference's ``BucketHistogram``. The per-step records,
the latency histograms, the tenant attribution and the conformance feeds
come with the slices that read them. Stdlib only.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Sequence, Tuple

#: inter-step device gap (seconds): host time between fetching one decode
#: step's results and enqueueing the next decode dispatch. The async
#: pipeline dispatches ahead of the fetch, so steady steps observe
#: (clamped) zero; lock-step observes the full marshal and bookkeeping gap
#: every step.
STEP_GAP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                    0.025, 0.05, 0.1, 0.5)


class BucketHistogram:
    """Thread-safe fixed-bucket histogram (cumulative bucket counts, sum
    and count, Prometheus-shaped)."""

    def __init__(self, bounds: Sequence[float]):
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def snapshot(self) -> Dict[str, Any]:
        """``{"buckets": [(le, cumulative_count), ..., ("+Inf", n)],
        "sum": float, "count": int}``: one locked copy."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        return {"buckets": out + [("+Inf", n)], "sum": total, "count": n}


class StepTelemetry:
    """One engine's pipeline instruments. The engine loop thread writes,
    ``/stats`` reads; every method is thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.step_gap = BucketHistogram(STEP_GAP_BUCKETS)
        self.recompiles = 0          # executables built after warmup
        self.warmed_executables = 0  # closed-set size at readiness
        # async decode pipeline flushes: the in-flight lookahead step was
        # retired early because an event changed the batch composition or
        # the control flow; each one is a serialization point the steady
        # path avoids
        self.pipeline_flushes = 0
        self._flush_reasons: Dict[str, int] = {}

    def count_recompile(self, kind: str = "") -> None:
        with self._lock:
            self.recompiles += 1

    def count_flush(self, reason: str = "") -> None:
        with self._lock:
            self.pipeline_flushes += 1
            if reason:
                self._flush_reasons[reason] = (
                    self._flush_reasons.get(reason, 0) + 1)

    def flush_reasons(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._flush_reasons)
