"""Engine step telemetry: the counters, gauges and histograms the engine
feeds and ``/stats`` and ``/metrics`` read.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/obs/steploop.py``,
with the reference's names: the TTFT, TPOT, queue-wait and step-gap
histograms over the reference's buckets (``:39``), ``BucketHistogram``,
and on ``StepTelemetry`` ``count_recompile``, ``count_flush`` with
``pipeline_flushes`` and ``flush_reasons`` (whose reasons include
``deadline``), ``count_preemption``, ``count_pad`` (pad-waste accounting
by phase), ``record_step`` (the last step's occupancy and KV gauges),
``warmed_executables``, ``snapshot`` and ``histograms``, which
``serve/metrics.py`` exports. The per-step record ring, the tenant
attribution and the conformance feeds come with the slices that read
them. Stdlib only.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Sequence, Tuple

#: explicit histogram bounds (seconds). TTFT includes queue time, so its
#: range reaches minutes; TPOT is per-token decode pace (milliseconds).
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0, 60.0)
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0)
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                      5.0, 10.0, 30.0, 60.0)
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
    """One engine's step-loop instruments. The engine loop thread writes,
    ``/stats`` and ``/metrics`` read; every method is thread-safe."""

    def __init__(self, total_blocks: int = 0) -> None:
        self._lock = threading.Lock()
        self.total_blocks = total_blocks
        self.ttft = BucketHistogram(TTFT_BUCKETS)
        self.tpot = BucketHistogram(TPOT_BUCKETS)
        self.queue_wait = BucketHistogram(QUEUE_WAIT_BUCKETS)
        self.step_gap = BucketHistogram(STEP_GAP_BUCKETS)
        self.steps = 0
        self.preemptions = 0
        self.recompiles = 0          # executables built after warmup
        self.requests_finished = 0
        self.warmed_executables = 0  # closed-set size at readiness
        # async decode pipeline flushes: the in-flight lookahead step was
        # retired early because an event changed the batch composition or
        # the control flow; each one is a serialization point the steady
        # path avoids
        self.pipeline_flushes = 0
        self._flush_reasons: Dict[str, int] = {}
        # pad-waste accounting: per dispatch, the token slots the call
        # walked for real context against shape padding, in total and by
        # phase (prefill, chunk, decode)
        self.pad_tokens = 0
        self.real_tokens = 0
        self.pad_by_phase: Dict[str, int] = {}
        self.real_by_phase: Dict[str, int] = {}
        # last-step gauges (scraped between steps)
        self._gauges: Dict[str, float] = {}

    def count_preemption(self) -> None:
        with self._lock:
            self.preemptions += 1

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

    def count_pad(self, real: int, padded: int, phase: str = "") -> None:
        """One dispatch's token-slot accounting: ``real`` context or prompt
        tokens the shapes carried against ``padded`` slots walked only
        because of bucket or batch padding."""
        with self._lock:
            self.real_tokens += max(0, real)
            self.pad_tokens += max(0, padded)
            if phase:
                self.real_by_phase[phase] = (
                    self.real_by_phase.get(phase, 0) + max(0, real))
                self.pad_by_phase[phase] = (
                    self.pad_by_phase.get(phase, 0) + max(0, padded))

    def record_step(self, *, n_running: int, n_waiting: int,
                    n_chunking: int, blocks_free: int,
                    finished: int = 0) -> None:
        """One engine ``step()`` completed: count it and its finished
        requests, and replace the occupancy and KV gauges."""
        total = self.total_blocks or 1
        used = max(0, total - blocks_free)
        with self._lock:
            self.steps += 1
            self.requests_finished += finished
            # no prefix cache yet: every used block is held by a live
            # sequence, so utilization and occupancy agree
            self._gauges = {
                "running": float(n_running),
                "waiting": float(n_waiting),
                "chunking": float(n_chunking),
                "kv_utilization": round(used / total, 4),
                "kv_occupancy": round(used / total, 4),
                "kv_blocks_free": float(blocks_free),
            }

    def snapshot(self) -> Dict[str, Any]:
        """Flat cumulative snapshot: the source of the ``/metrics`` gauge
        and counter families."""
        with self._lock:
            out: Dict[str, Any] = {
                "steps": self.steps,
                "preemptions": self.preemptions,
                "recompiles": self.recompiles,
                "requests_finished": self.requests_finished,
                "warmed_executables": self.warmed_executables,
                "kv_blocks_total": self.total_blocks,
                "pipeline_flushes": self.pipeline_flushes,
                "pad_tokens": self.pad_tokens,
                "real_tokens": self.real_tokens,
            }
            walked = self.pad_tokens + self.real_tokens
            out["pad_fraction"] = (round(self.pad_tokens / walked, 4)
                                   if walked else 0.0)
            out["pad_by_phase"] = {
                p: {"real": self.real_by_phase.get(p, 0),
                    "pad": self.pad_by_phase.get(p, 0)}
                for p in set(self.real_by_phase) | set(self.pad_by_phase)}
            out.update(self._gauges)
        for name, h in (("ttft", self.ttft), ("tpot", self.tpot),
                        ("queue_wait", self.queue_wait),
                        ("step_gap", self.step_gap)):
            out[f"{name}_count"] = h.count
        return out

    def histograms(self) -> Dict[str, Dict[str, Any]]:
        """Named histogram snapshots for the Prometheus exposition."""
        return {"ttft_seconds": self.ttft.snapshot(),
                "tpot_seconds": self.tpot.snapshot(),
                "queue_wait_seconds": self.queue_wait.snapshot(),
                "step_gap_seconds": self.step_gap.snapshot()}
