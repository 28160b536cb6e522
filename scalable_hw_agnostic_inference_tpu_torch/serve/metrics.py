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
- ``shai_spec_{drafted,accepted,committed}_total`` (counters; ``app``,
  ``nodepool``, ``pod``): speculative decoding's cumulative counters,
  advanced by :meth:`MetricsPublisher.publish_spec` after each served
  ``/generate`` (the families are on every page, their samples from the
  first advance on, as ``prometheus_client`` writes a labelled counter),
  and the ``shai_spec_acceptance_rate`` gauge among the engine gauges;
- :data:`ENGINE_HISTOGRAMS`, :data:`ENGINE_GAUGES`,
  :data:`ENGINE_COUNTERS` and :data:`PAD_PHASE_COUNTERS` off the engine's
  ``obs.steploop.StepTelemetry`` (label ``app``; the pad counters also
  ``phase``), and its conformance instruments' flat snapshots under the
  :data:`CONFORMANCE_PREFIXES` (``shai_slo_*``, ``shai_hbm_*``,
  ``shai_perf_*``), and on an engine with a host KV tier the
  :data:`KVTIER_COUNTERS`, :data:`KVTIER_GAUGES` and
  :data:`KVNET_COUNTERS` (``shai_kvtier_*``, ``shai_kvnet_*``); the
  :data:`MIGRATE_COUNTERS` (``shai_migrate_*``) on every engine, and the
  :data:`KVFABRIC_COUNTERS` (``shai_kvfabric_*``) on an engine with the
  fabric armed;
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
port from a stdlib HTTP server.
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
                       "KV page pool fraction held by LIVE sequences "
                       "(evictable prefix-cache blocks excluded — they "
                       "reclaim on demand)"),
    "kv_occupancy": ("shai_engine_kv_occupancy",
                     "KV page pool fraction allocated, cached blocks "
                     "included"),
    "kv_blocks_free": ("shai_engine_kv_blocks_free", "Free KV pool blocks"),
    "spec_acceptance_rate": ("shai_spec_acceptance_rate",
                             "Speculative draft acceptance rate"),
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
#: the speculative counters ``publish_spec`` advances (``shai_spec_<kind>``)
SPEC_KINDS = ("drafted", "accepted", "committed")

#: pad and real token counters with a ``phase`` label (prefill, chunk,
#: decode, verify); an unphased remainder goes under phase="", so the rows
#: sum to the engine's totals
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
#: host KV tier (``kvtier.pool.HostKVTier.snapshot`` keys -> families):
#: counters (``_total`` added) and occupancy gauges
KVTIER_COUNTERS = {
    "hits": ("shai_kvtier_hits",
             "Host KV tier: prefix blocks found resident"),
    "misses": ("shai_kvtier_misses",
               "Host KV tier: prefix walks that stopped short"),
    "evictions": ("shai_kvtier_evictions",
                  "Host KV tier: blocks LRU-evicted from the host pool"),
    "stores": ("shai_kvtier_stores",
               "Host KV tier: blocks demoted into the host pool"),
    "restored": ("shai_kvtier_restored",
                 "Host KV tier: blocks swapped back into the device pool"),
    "bytes": ("shai_kvtier_bytes",
              "Host KV tier: cumulative bytes copied into the host pool"),
    "errors": ("shai_kvtier_errors",
               "Host KV tier: failures degraded to recompute"),
    "dropped": ("shai_kvtier_dropped",
                "Host KV tier: demotions dropped (queue full / no capacity)"),
}
KVTIER_GAUGES = {
    "used_bytes": ("shai_kvtier_used_bytes",
                   "Host KV tier: bytes resident in the host pool"),
    "capacity_bytes": ("shai_kvtier_capacity_bytes",
                       "Host KV tier: configured capacity "
                       "(SHAI_KVTIER_BYTES)"),
    "entries": ("shai_kvtier_entries", "Host KV tier: resident blocks"),
    "utilization": ("shai_kvtier_utilization",
                    "Host KV tier: used/capacity fraction"),
    "hit_rate": ("shai_kvtier_hit_rate",
                 "Host KV tier: hits / (hits + misses)"),
}
#: network KV transport (``kvnet.client.KvNetStats.snapshot`` keys): the
#: block flow both ways, transport bytes, and the degrade signal
KVNET_COUNTERS = {
    "fetched": ("shai_kvnet_fetched",
                "kvnet: KV blocks pulled from peer pods into the host "
                "tier"),
    "served": ("shai_kvnet_served",
               "kvnet: host-tier KV blocks served to peers over "
               "/kv/blocks"),
    "bytes": ("shai_kvnet_bytes",
              "kvnet: frame bytes moved through this pod's transport "
              "(served out + fetched in)"),
    "errors": ("shai_kvnet_errors",
               "kvnet: transport failures (connect/read/corrupt frames)"),
    "fallbacks": ("shai_kvnet_fallbacks",
                  "kvnet: fetches degraded to local recompute (open "
                  "breaker, transport failure, rejected frames)"),
}
#: live migration (``kvnet.migrate.MigrateStats.snapshot`` keys): the
#: drain ladder's happy path (shipped, received, resumed), its
#: degradations, and the storm guard's back-pressure
MIGRATE_COUNTERS = {
    "shipped": ("shai_migrate_shipped",
                "migrate: in-flight requests shipped to a peer at drain"),
    "received": ("shai_migrate_received",
                 "migrate: migration envelopes accepted from peers"),
    "resumed": ("shai_migrate_resumed",
                "migrate: migrated sequences re-admitted and completed "
                "on this pod"),
    "failed": ("shai_migrate_failed",
               "migrate: ship attempts that never landed on a peer"),
    "fallbacks": ("shai_migrate_fallbacks",
                  "migrate: ladder degradations (no peer, refused "
                  "restore, unencodable blocks) — each one recomputed "
                  "instead of failing"),
    "busy": ("shai_migrate_peer_busy",
             "migrate: 429 answers from saturated peers (inbox full or "
             "at SHAI_MIGRATE_MAX_INBOUND) — back-pressure the shipper "
             "routed around, never a failure"),
}
#: the KV fabric (``kvnet.directory.KvFabricStats.snapshot`` keys): rising
#: stale_holders = the directory's TTL outlives the pools; rising
#: remote_misses with flat stale_holders = holders unreachable
KVFABRIC_COUNTERS = {
    "probes": ("shai_kvfabric_probes",
               "KV fabric: peer-probe admissions attempted (the ladder's "
               "third rung)"),
    "remote_hits": ("shai_kvfabric_remote_hits",
                    "KV fabric: probes that landed a remote KV run"),
    "remote_misses": ("shai_kvfabric_remote_misses",
                      "KV fabric: probes that came up empty and "
                      "recomputed"),
    "replications": ("shai_kvfabric_replications",
                     "KV fabric: hot-prefix runs pulled by background "
                     "replication (/kv/pull)"),
    "directory_size": ("shai_kvfabric_directory_size",
                       "KV fabric: chain heads in this pod's local "
                       "directory"),
    "stale_holders": ("shai_kvfabric_stale_holders",
                      "KV fabric: holders that answered but no longer "
                      "held the advertised run"),
}
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
    ``EngineTelemetryCollector.collect``; the migration and KV fabric
    families come with those modules)."""
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
    # the network KV transport and the host tier: present only on an
    # engine with a tier
    kvn = getattr(tele, "kvnet", None)
    if kvn is not None:
        snap = kvn.snapshot()
        for key, (name, doc) in KVNET_COUNTERS.items():
            out.counter(name, doc, [(lb, float(snap.get(key, 0)))])
    # live migration on every engine; the fabric only where it is armed
    for attr, table in (("migrate", MIGRATE_COUNTERS),
                        ("kvfabric", KVFABRIC_COUNTERS)):
        obj = getattr(tele, attr, None)
        if obj is not None:
            snap = obj.snapshot()
            for key, (name, doc) in table.items():
                out.counter(name, doc, [(lb, float(snap.get(key, 0)))])
    kvt = getattr(tele, "kvtier", None)
    if kvt is not None:
        snap = kvt.snapshot()
        for key, (name, doc) in KVTIER_COUNTERS.items():
            out.counter(name, doc, [(lb, float(snap.get(key, 0)))])
        for key, (name, doc) in KVTIER_GAUGES.items():
            if key in snap:
                out.gauge(name, doc, [(lb, float(snap[key]))])


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
    """The request counter, latency histogram, shed counter and
    speculative counters of one serving pod, the page that exports them
    with the attached sources' families, and the JSON-line push path (one
    line per served request, per shed, per speculative advance on
    ``publish_spec`` and per engine step count on ``publish_engine``)."""

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
        # speculative counters: the last cumulative snapshot published, and
        # the exported totals (None until the first advance: no samples)
        self._spec_last = {k: 0 for k in SPEC_KINDS}
        self._spec_total: Optional[Dict[str, int]] = None
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

    def publish_spec(self, drafted: int, accepted: int,
                     committed: int) -> None:
        """Record the engine's CUMULATIVE speculative counters (its
        ``SpecStats`` totals): the ``shai_spec_*_total`` counters advance by
        the delta since the last call, and the JSON push path emits the
        cumulative snapshot and the acceptance rate. An unchanged snapshot
        does nothing, so the request path forwards the totals after every
        request. The delta and the push are taken under one lock, so
        concurrent publishers never push totals out of order."""
        with self._lock:
            cur = {"drafted": drafted, "accepted": accepted,
                   "committed": committed}
            delta = {k: max(0, cur[k] - self._spec_last[k]) for k in cur}
            self._spec_last = cur
            if not any(delta.values()):
                return
            if self._spec_total is None:
                self._spec_total = {k: 0 for k in SPEC_KINDS}
            for k, d in delta.items():
                self._spec_total[k] += d
            if self.emit_json:
                data = {f"{self.app}-spec-{k}": v for k, v in cur.items()}
                data[f"{self.app}-spec-acceptance"] = (
                    round(accepted / drafted, 4) if drafted else 0.0)
                self._push(data)

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
        with self._lock:
            spec = None if self._spec_total is None else dict(
                self._spec_total)
        for kind in SPEC_KINDS:
            out.counter(f"shai_spec_{kind}",
                        f"Speculative decoding: {kind} tokens",
                        [] if spec is None else
                        [((("app", self.app), ("nodepool", self.nodepool),
                           ("pod", self.pod_name)), spec[kind])])
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
