"""Metric publication: the ``/metrics`` page the autoscaler scrapes, and
the JSON-line push twin on stdout.

Port of ``scalable_hw_agnostic_inference_tpu/serve/metrics.py``
(``MetricsPublisher``, ``EngineTelemetryCollector``,
``IdempotencyCollector``) that writes the Prometheus text exposition
(format 0.0.4) with the standard library: ``prometheus_client`` is not a
dependency of the port. The families keep the reference's names, types,
label names and histogram buckets:

- ``shai_requests_total`` (counter; ``app``, ``nodepool``, ``pod``) and
  ``shai_request_latency_seconds`` (histogram; ``app``, ``nodepool``):
  the KEDA scaling signal, one observation per served request;
- ``shai_shed_total`` (counter; ``app``, ``nodepool``, ``reason``,
  ``tenant``): requests the admission gate or the drain refused;
- :data:`ENGINE_HISTOGRAMS`, :data:`ENGINE_GAUGES`,
  :data:`ENGINE_COUNTERS` and :data:`PAD_PHASE_COUNTERS` off the engine's
  ``obs.steploop.StepTelemetry`` (label ``app``; the pad counters also
  ``phase``), and its conformance instruments' flat snapshots under the
  :data:`CONFORMANCE_PREFIXES` (``shai_slo_*``, ``shai_hbm_*``,
  ``shai_perf_*``);
- the per-tenant families (label ``tenant``): ``shai_tenant_requests_total``,
  ``shai_tenant_waiting``, ``shai_tenant_running`` and
  ``shai_tenant_ttft_seconds`` off the engine once a tenant tag was seen,
  and ``shai_tenant_tokens_total``, ``shai_tenant_inflight`` and
  ``shai_tenant_budget_balance`` off the budget ledger;
- the idempotency cache's ``shai_idemp_*`` counters and entries gauge;
- ``shai_service_<key>`` gauges off the unit's ``extra_stats``.

The sources are attached as providers resolved at every scrape (the app
attaches them before the engine exists). A counter family's samples carry
the ``_total`` suffix, as ``prometheus_client`` writes them.
:meth:`MetricsPublisher.start_exporter` serves the same page on its own
port from a stdlib HTTP server. ``publish_spec`` (speculative decoding)
comes with that slice.
"""

from __future__ import annotations

import http.server
import json
import logging
import math
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..obs.steploop import BucketHistogram

log = logging.getLogger(__name__)

#: the JSON-line push path's namespace (the reference's CloudWatch one)
METRIC_NAMESPACE = "hw-agnostic-infer"

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

#: conformance instruments riding the engine telemetry: attribute, the
#: gauge prefix its flat numeric snapshot exports under, and the HELP text
CONFORMANCE_PREFIXES = (
    ("slo", "shai_slo_", "SLO burn-rate engine gauge"),
    ("hbm", "shai_hbm_", "Live HBM ledger gauge"),
    ("sentinel", "shai_perf_", "Perf-model sentinel gauge"),
)
#: per-tenant attribution off the engine telemetry (bounded label set)
TENANT_COUNTERS = {
    "requests": ("shai_tenant_requests",
                 "Requests submitted to the engine, per tenant"),
}
TENANT_GAUGES = {
    "waiting": ("shai_tenant_waiting",
                "Engine queue depth held by this tenant (last step)"),
    "running": ("shai_tenant_running",
                "Decoding slots held by this tenant (last step)"),
}
TENANT_TTFT = ("shai_tenant_ttft_seconds",
               "Time to first token per tenant (queue wait included)")
#: the idempotency cache's counter keys -> families (``_total`` added)
IDEMP_COUNTERS = {
    "replayed_total": ("shai_idemp_replayed",
                       "keyed duplicates answered from the completion "
                       "cache (no re-execution, no second charge)"),
    "joined_total": ("shai_idemp_joined",
                     "keyed duplicates that joined an in-flight "
                     "execution"),
    "misses_total": ("shai_idemp_misses",
                     "new idempotency keys (executions claimed)"),
    "evicted_total": ("shai_idemp_evicted",
                      "entries dropped by the bound or the TTL sweep"),
    "lookup_errors_total": ("shai_idemp_lookup_errors",
                            "lookups degraded to a miss (at-least-once "
                            "fallback)"),
}
IDEMP_ENTRIES = ("shai_idemp_entries",
                 "live completion-cache entries (bounded by "
                 "SHAI_IDEMP_CACHE)")

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


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def engine_families(out: Exposition, tele, app: str) -> None:
    """The engine telemetry families (the reference's
    ``EngineTelemetryCollector.collect``, without the tiers the port does
    not have yet)."""
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
    # conformance: each instrument's flat numeric snapshot, one gauge per
    # key; a tier without a given instrument exports nothing for it
    for attr, prefix, doc in CONFORMANCE_PREFIXES:
        obj = getattr(tele, attr, None)
        if obj is None:
            continue
        for k, v in obj.snapshot().items():
            if _numeric(v):
                out.gauge(f"{prefix}{k}", doc, [(lb, v)])
    # per-tenant: present only once a tenant tag (or SHAI_QOS) was seen
    tsnap = tele.tenant_snapshot()
    if tsnap:
        rows = sorted(tsnap.items())
        for key, (name, doc) in TENANT_COUNTERS.items():
            out.counter(name, doc, [((("app", app), ("tenant", t)),
                                     float(ent.get(key, 0)))
                                    for t, ent in rows])
        for key, (name, doc) in TENANT_GAUGES.items():
            out.gauge(name, doc, [((("app", app), ("tenant", t)),
                                   float(ent.get(key, 0)))
                                  for t, ent in rows])
        out.histogram(TENANT_TTFT[0], TENANT_TTFT[1], [
            ((("app", app), ("tenant", t)), hs)
            for t, hs in sorted(tele.tenant_histograms().items())])


def idempotency_families(out: Exposition, snap: Dict[str, float],
                         app: str) -> None:
    """The idempotency cache's families (``IdempotencyCollector``)."""
    lb = (("app", app),)
    for key, (name, doc) in IDEMP_COUNTERS.items():
        out.counter(name, doc, [(lb, float(snap.get(key, 0)))])
    out.gauge(IDEMP_ENTRIES[0], IDEMP_ENTRIES[1],
              [(lb, float(snap.get("entries", 0)))])


def ledger_families(out: Exposition, snap: Dict[str, Dict[str, float]],
                    app: str) -> None:
    """The tenant budget ledger's families (bounded by the ledger, which
    collapses overflow tenants into ``other``); none while it is empty."""
    if not snap:
        return
    rows = sorted(snap.items())
    out.counter("shai_tenant_tokens",
                "Tokens charged against the tenant budget (prompt + "
                "generated; 1/request for token-less services)",
                [((("app", app), ("tenant", t)), float(e.get("tokens", 0)))
                 for t, e in rows])
    out.gauge("shai_tenant_inflight", "Requests in flight per tenant",
              [((("app", app), ("tenant", t)), float(e.get("inflight", 0)))
               for t, e in rows])
    out.gauge("shai_tenant_budget_balance",
              "Live token-bucket balance (negative = in debt, admission "
              "refused until refill)",
              [((("app", app), ("tenant", t)), float(e["budget_balance"]))
               for t, e in rows if "budget_balance" in e])


class MetricsPublisher:
    """The request counter, latency histogram and shed counter of one
    serving pod, the page that exports them with the attached sources'
    families, and the JSON-line push path (one line per served request,
    per shed, and per engine step count on ``publish_engine``)."""

    def __init__(self, app: str, nodepool: str, pod_name: str = "",
                 emit_json: bool = True, stream=None):
        self.app = app
        self.nodepool = nodepool
        self.pod_name = pod_name
        self.emit_json = emit_json
        self._stream = stream or sys.stdout
        self._lock = threading.Lock()
        self._served = 0
        self._latency = BucketHistogram(LATENCY_BUCKETS)
        self._shed: Dict[Tuple[str, str], int] = {}
        self._engine_last_steps = -1
        # scrape-time providers (zero-argument callables; None = absent)
        self._engine: Optional[Callable[[], Any]] = None
        self._idem: Optional[Callable[[], Any]] = None
        self._ledger: Optional[Callable[[], Any]] = None
        self._service: Optional[Callable[[], Dict[str, Any]]] = None
        self._exporter: Optional[http.server.ThreadingHTTPServer] = None

    @property
    def served(self) -> int:
        with self._lock:
            return self._served

    def _push(self, data: Dict[str, Any]) -> None:
        print(json.dumps({"ns": METRIC_NAMESPACE,
                          "ts": round(time.time(), 3),
                          "pod": self.pod_name, "data": data}),
              file=self._stream, flush=True)

    def publish(self, latency_s: float, count: int = 1) -> None:
        """Record ``count`` served requests at ``latency_s`` seconds each
        (one latency observation), and push one JSON line: the
        reference's three CloudWatch signals under ``data``."""
        with self._lock:
            self._served += count
        self._latency.observe(latency_s)
        if self.emit_json:
            data = {f"{self.app}-counter": count}
            data.setdefault(self.nodepool, count)
            data[f"{self.app}-latency"] = round(latency_s, 4)
            self._push(data)

    def count_shed(self, reason: str, tenant: str = "") -> None:
        """One request refused under ``reason``: ``shai_shed_total`` and a
        JSON line. ``tenant`` arrives bounded (the ledger's label); empty
        reads as ``default``."""
        key = (reason, tenant or "default")
        with self._lock:
            self._shed[key] = self._shed.get(key, 0) + 1
        if self.emit_json:
            self._push({f"{self.app}-shed-{reason}": 1})

    def publish_engine(self, tele: Any) -> None:
        """Push one JSON line of the engine's flat snapshot, deduplicated
        on the step counter (a burst of requests inside one step pushes
        one line)."""
        if not self.emit_json:
            return
        with self._lock:
            if tele.steps == self._engine_last_steps:
                return
            self._engine_last_steps = tele.steps
            snapshot = tele.snapshot()
            self._push({f"{self.app}-engine-{k}": v
                        for k, v in snapshot.items() if _numeric(v)})

    def attach_engine_telemetry(self, provider: Callable[[], Any]) -> None:
        """The engine's ``StepTelemetry`` (or None before it exists)."""
        self._engine = provider

    def attach_idempotency(self, provider: Callable[[], Any]) -> None:
        """The pod's ``IdempotencyCache``."""
        self._idem = provider

    def attach_tenant_ledger(self, provider: Callable[[], Any]) -> None:
        """The pod's ``TenantLedger``."""
        self._ledger = provider

    def attach_service_stats(self, provider: Callable[[], Dict[str, Any]]
                             ) -> None:
        """The unit's ``extra_stats`` (``shai_service_<key>`` gauges)."""
        self._service = provider

    def render(self) -> str:
        """The exposition page, every attached source read now."""
        out = Exposition()
        out.counter("shai_requests", "Served requests (the KEDA scaling "
                    "signal)", [((("app", self.app),
                                  ("nodepool", self.nodepool),
                                  ("pod", self.pod_name)), self.served)])
        out.histogram("shai_request_latency_seconds", "Per-request latency",
                      [((("app", self.app), ("nodepool", self.nodepool)),
                        self._latency.snapshot())])
        with self._lock:
            shed = sorted(self._shed.items())
        out.counter("shai_shed", "Requests shed by the admission gate / "
                    "drain", [((("app", self.app),
                                ("nodepool", self.nodepool),
                                ("reason", reason), ("tenant", tenant)), n)
                              for (reason, tenant), n in shed])
        tele = self._engine() if self._engine is not None else None
        if tele is not None:
            engine_families(out, tele, self.app)
        cache = self._idem() if self._idem is not None else None
        if cache is not None:
            idempotency_families(out, cache.snapshot(), self.app)
        ledger = self._ledger() if self._ledger is not None else None
        if ledger is not None:
            ledger_families(out, ledger.snapshot(), self.app)
        if self._service is not None:
            for k, v in self._service().items():
                if _numeric(v):
                    out.gauge(f"shai_service_{k}", f"service gauge {k}",
                              [((("app", self.app),), v)])
        return out.text()

    def start_exporter(self, port: int) -> int:
        """Serve :meth:`render` on ``port`` (``GET /metrics``) from a
        stdlib HTTP server on a daemon thread; returns the bound port."""
        pub = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = pub.render().encode()
                self.send_response(200)
                self.send_header("content-type", CONTENT_TYPE)
                self.send_header("content-length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not news
                pass

        srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        srv.daemon_threads = True
        self._exporter = srv
        threading.Thread(target=srv.serve_forever, name="metrics-exporter",
                         daemon=True).start()
        return srv.server_address[1]

    def stop_exporter(self) -> None:
        if self._exporter is not None:
            self._exporter.shutdown()
            self._exporter.server_close()
            self._exporter = None
