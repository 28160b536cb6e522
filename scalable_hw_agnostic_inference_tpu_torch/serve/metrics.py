"""Metric publication: the ``/metrics`` page the autoscaler scrapes.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/serve/metrics.py``
(``MetricsPublisher``, ``EngineTelemetryCollector``) that writes the
Prometheus text exposition (format 0.0.4) with the standard library:
``prometheus_client`` is not a dependency of the port. The families keep the reference's names, types,
label names and histogram buckets:

- ``shai_requests_total`` (counter; ``app``, ``nodepool``, ``pod``) and
  ``shai_request_latency_seconds`` (histogram; ``app``, ``nodepool``):
  the KEDA scaling signal, one observation per served request;
- :data:`ENGINE_HISTOGRAMS`, :data:`ENGINE_GAUGES`,
  :data:`ENGINE_COUNTERS` and :data:`PAD_PHASE_COUNTERS` off the engine's
  ``obs.steploop.StepTelemetry`` (label ``app``; the pad counters also
  ``phase``).

The families of features the port does not have yet (speculative
decoding, the KV tier and network, migration, the SLO, HBM and perf
conformance gauges, tenants, idempotency, shedding) and the unit's
``shai_service_*`` gauges are left out. A counter family's samples carry
the ``_total`` suffix, as ``prometheus_client`` writes them; the
JSON-line push path comes in a later slice.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..obs.steploop import BucketHistogram

#: the exposition's content type (what ``prometheus_client`` serves)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 0.9, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0)

#: engine histogram families <- ``StepTelemetry.histograms()`` keys
ENGINE_HISTOGRAMS = {
    "ttft_seconds": ("shai_ttft_seconds",
                     "Time to first token (queue wait included)"),
    "tpot_seconds": ("shai_tpot_seconds",
                     "Per-output-token decode pace after the first token"),
    "queue_wait_seconds": ("shai_queue_wait_seconds",
                           "Submit-to-admission wait in the engine queue"),
    "step_gap_seconds": ("shai_engine_step_gap_seconds",
                         "Inter-step device gap: host time between a decode "
                         "readback and the next dispatch (0 when the async "
                         "pipeline dispatched ahead of the readback)"),
}
#: engine gauge families <- ``StepTelemetry.snapshot()`` keys (exported
#: when the key is present)
ENGINE_GAUGES = {
    "running": ("shai_engine_running", "Sequences decoding right now"),
    "waiting": ("shai_engine_waiting", "Requests in the admission queue"),
    "chunking": ("shai_engine_chunking", "Slots mid chunked-prefill"),
    "kv_utilization": ("shai_engine_kv_utilization",
                       "KV page pool fraction held by live sequences"),
    "kv_occupancy": ("shai_engine_kv_occupancy",
                     "KV page pool fraction allocated"),
    "kv_blocks_free": ("shai_engine_kv_blocks_free", "Free KV pool blocks"),
    "pad_fraction": ("shai_engine_pad_fraction",
                     "Fraction of dispatched token slots that were shape "
                     "padding (bucket windows past live tokens + batch pad "
                     "rows)"),
}
#: engine counter families <- ``StepTelemetry.snapshot()`` keys
ENGINE_COUNTERS = {
    "steps": ("shai_engine_steps", "Engine steps executed"),
    "preemptions": ("shai_engine_preemptions",
                    "Recompute-preemptions (KV pool pressure)"),
    "recompiles": ("shai_engine_recompiles",
                   "Executables built after warmup"),
    "requests_finished": ("shai_engine_requests_finished",
                          "Requests finished by the engine"),
    "pipeline_flushes": ("shai_engine_pipeline_flushes",
                         "Async-decode lookahead steps retired early by a "
                         "composition/control-flow event"),
}
#: pad and real token counters with a ``phase`` label (prefill, chunk,
#: decode); an unphased remainder goes under phase="", so the rows sum to
#: the engine's totals
PAD_PHASE_COUNTERS = {
    "pad_tokens": ("shai_engine_pad_tokens",
                   "Padded (wasted) token slots dispatched, cumulative",
                   "pad"),
    "real_tokens": ("shai_engine_real_tokens",
                    "Real context/prompt token slots dispatched, "
                    "cumulative", "real"),
}

Labels = Tuple[Tuple[str, str], ...]


def _num(v: float) -> str:
    """A sample value or bound as ``prometheus_client`` writes it."""
    v = float(v)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(v)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _sample(name: str, labels: Labels, value: float) -> str:
    if labels:
        inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels)
        return f"{name}{{{inner}}} {_num(value)}"
    return f"{name} {_num(value)}"


class Exposition:
    """Builds one text-format page, family by family."""

    def __init__(self) -> None:
        self.lines: List[str] = []

    def _head(self, name: str, kind: str, doc: str) -> None:
        doc = doc.replace("\\", r"\\").replace("\n", r"\n")
        self.lines += [f"# HELP {name} {doc}", f"# TYPE {name} {kind}"]

    def gauge(self, name: str, doc: str,
              samples: Iterable[Tuple[Labels, float]]) -> None:
        self._head(name, "gauge", doc)
        self.lines += [_sample(name, lb, v) for lb, v in samples]

    def counter(self, name: str, doc: str,
                samples: Iterable[Tuple[Labels, float]]) -> None:
        """``name`` without the ``_total`` suffix, which the samples and
        the TYPE line carry."""
        total = name + "_total"
        self._head(total, "counter", doc)
        self.lines += [_sample(total, lb, v) for lb, v in samples]

    def histogram(self, name: str, doc: str,
                  samples: Iterable[Tuple[Labels, Dict[str, Any]]]) -> None:
        """``samples``: ``(labels, BucketHistogram.snapshot())`` pairs."""
        self._head(name, "histogram", doc)
        for lb, snap in samples:
            for le, n in snap["buckets"]:
                le_s = "+Inf" if le == "+Inf" else _num(le)
                self.lines.append(_sample(f"{name}_bucket",
                                          lb + (("le", le_s),), n))
            self.lines.append(_sample(f"{name}_count", lb, snap["count"]))
            self.lines.append(_sample(f"{name}_sum", lb, snap["sum"]))

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def engine_families(out: Exposition, tele, app: str) -> None:
    """The engine telemetry families (the reference's
    ``EngineTelemetryCollector.collect``, trimmed)."""
    snap = tele.snapshot()
    lb = (("app", app),)
    for key, (name, doc) in ENGINE_GAUGES.items():
        if key in snap:
            out.gauge(name, doc, [(lb, snap[key])])
    for key, (name, doc) in ENGINE_COUNTERS.items():
        out.counter(name, doc, [(lb, snap.get(key, 0))])
    phases = snap.get("pad_by_phase") or {}
    for key, (name, doc, col) in PAD_PHASE_COUNTERS.items():
        total = float(snap.get(key, 0))
        rows = [((("app", app), ("phase", p)), float(phases[p].get(col, 0)))
                for p in sorted(phases)]
        rest = total - sum(v for _, v in rows)
        if rest or not phases:
            rows.append(((("app", app), ("phase", "")), rest))
        out.counter(name, doc, rows)
    hists = tele.histograms()
    for key, (name, doc) in ENGINE_HISTOGRAMS.items():
        if key in hists:
            out.histogram(name, doc, [(lb, hists[key])])


class MetricsPublisher:
    """The request counter and latency histogram of one serving pod, and
    the page that exports them with the engine's families."""

    def __init__(self, app: str, nodepool: str, pod_name: str = ""):
        self.app = app
        self.nodepool = nodepool
        self.pod_name = pod_name
        self._lock = threading.Lock()
        self._served = 0
        self._latency = BucketHistogram(LATENCY_BUCKETS)

    @property
    def served(self) -> int:
        with self._lock:
            return self._served

    def publish(self, latency_s: float, count: int = 1) -> None:
        """Record ``count`` served requests at ``latency_s`` seconds each
        (one latency observation)."""
        with self._lock:
            self._served += count
        self._latency.observe(latency_s)

    def render(self, engine_telemetry: Optional[Callable[[], Any]] = None
               ) -> str:
        """The exposition page. ``engine_telemetry`` returns the engine's
        ``StepTelemetry`` (or None before the engine exists)."""
        out = Exposition()
        out.counter("shai_requests", "Served requests (the KEDA scaling "
                    "signal)", [((("app", self.app),
                                  ("nodepool", self.nodepool),
                                  ("pod", self.pod_name)), self.served)])
        out.histogram("shai_request_latency_seconds", "Per-request latency",
                      [((("app", self.app), ("nodepool", self.nodepool)),
                        self._latency.snapshot())])
        tele = engine_telemetry() if engine_telemetry is not None else None
        if tele is not None:
            engine_families(out, tele, self.app)
        return out.text()
