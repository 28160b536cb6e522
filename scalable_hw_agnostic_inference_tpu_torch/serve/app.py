"""The serving runtime: one app factory for every model unit.

Port of ``scalable_hw_agnostic_inference_tpu/serve/app.py``
(``ModelService``, ``create_app``, ``serve_forever``) with the pod's
operating layer. The uniform surface:

- ``GET  /``                      self-describing config (redacted)
- ``GET  /health``                liveness: 503 while the unit reports a
  wedged engine (the step watchdog), so Kubernetes restarts the pod
- ``GET  /readiness``             503 until loaded and warm, and ``draining``
  once a drain began; also ``GET /health/ready``
- ``POST /benchmark``             ``{"n_runs": N}`` -> percentile report
- ``GET  /load/{n}/infer/{m}``    n rounds of m inferences, published
- ``GET  /serve``                 an HTML console over the infer route
- ``GET  /stats``                 latency report, in-flight counts, shed and
  idempotency counters, the unit's gauges, the engine snapshot and its
  conformance sections, the per-tenant QoS view
- ``GET  /metrics``               Prometheus text (``serve/metrics.py``)
- ``GET  /debug/conformance``     the HBM ledger, SLO burn and perf sentinel
  with one verdict
- ``GET  /debug/faults``          the fault schedule; ``POST`` replaces it,
  armed only by ``SHAI_FAULTS_ENDPOINT=1``
- ``GET  /debug/flight``          the flight recorder's request timelines and
  the engine's recent step records
- ``GET  /trace/{trace_id}``      this pod's spans of one trace
- ``GET  /profile``, ``POST /profile/{seconds}``  ``torch.profiler``
- ``GET  /kv/blocks?hashes=``     this pod's host-tier KV blocks by chain
  hash, as binary frames (``kvnet.frames``): the leading resident run
- ``GET  /kv/digests[?head=]``    the host tier's chain-head advertisement,
  or one run's hashes
- ``POST /kv/pull``               ``{"source", "head"}``: pull one advertised
  run from a peer into this pod's tier (the fabric's replication; 404 with
  the fabric off)
- ``POST /kv/protect``            ``{"heads", "ttl_s"}``: defer the tier's
  eviction of those runs
- ``POST /kv/migrate``            one ``KVMG`` envelope (``kvnet.migrate``):
  restore its run and bank its manifest for a ``{"resume": <handle>}``
  replay; 429 with ``Retry-After`` while the inbox is saturated, 503 while
  draining
- the unit's infer route (``POST /generate`` for the vllm unit) and its
  ``extra_routes`` (the OpenAI routes)

Every request to the infer route or a non-GET extra route passes the
admission gate (``resilience.admission``: the tenant budget ledger, the
``MAX_INFLIGHT`` cap, the lane backlog and the engine's queue and KV
gauges against ``ADMIT_MAX_QUEUE``/``ADMIT_MAX_KV``; 429 with
``Retry-After``, 503 while draining) before it parks a lane thread, and
carries a deadline (``X-SHAI-Deadline-Ms`` or ``DEADLINE_MS``) and a QoS
tag (``X-SHAI-Tenant``, ``X-SHAI-Priority``) on contextvars the model
lane's call runs under. A keyed infer request (``X-SHAI-Idempotency-Key``)
replays or joins an earlier execution of its key instead of running twice.
A streamed response holds its in-flight slot until the stream drains.
SIGTERM (``serve_forever``) begins the drain: readiness flips, new work
sheds with 503, in-flight requests finish within ``DRAIN_BUDGET_S``; with
migration armed (``SHAI_MIGRATE*``) the wait stops
``SHAI_MIGRATE_RESERVE_S`` short of the budget and what still runs is
shipped to a peer (the migrate phase), then the wait resumes; the unit
drains its engine loop, and the server stops. A pod whose host tier
still banks KV a peer may pull (``pending_handoff``: a prefill-role pod,
or a migration whose peer must still pull blocks) keeps ``/kv/blocks``
serving until the budget ends. Model work runs on a thread pool (the "model lane"),
so the event loop keeps answering probes during a load or a long
request.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import trace as obs_trace
from ..obs.flight import FlightRecorder
from ..orchestrate.capacity_checker import OverloadThresholds
from ..resilience import deadline as rz_deadline
from ..resilience import faults as rz_faults
from ..resilience import idempotency as rz_idemp
from ..resilience import qos as rz_qos
from ..resilience.admission import AdmissionGate
from ..resilience.drain import DrainController
from ..utils.env import ServeConfig, env_float, env_int
from ..utils.latency import LatencyCollector, run_benchmark
from .asgi import App, HTTPError, Request, Response, StreamingResponse
from .metrics import CONTENT_TYPE, MetricsPublisher

log = logging.getLogger(__name__)


class ModelService:
    """One model behind the uniform runtime. Lifecycle: ``load()`` ->
    ``warmup()`` (one synthetic inference, the readiness gate) ->
    ``infer(payload)`` per request."""

    task: str = "generic"
    infer_route: str = "/infer"
    #: requests allowed in ``infer`` at once; engine-backed services raise
    #: it to their slot count (their infer only enqueues into the engine)
    concurrency: int = 1
    #: the multi-rank contract (``serve.multihost``): True only where
    #: EVERY path to the device (warmup, infer, extra routes) goes through
    #: ``mirror_methods``, so the follower ranks mirror each call and join
    #: its collectives; ``serve_multihost`` refuses any other service
    supports_multihost: bool = False
    mirror_methods: Tuple[str, ...] = ("infer",)
    #: the knob that lays the unit out over the tp ranks of one host
    #: (``MESH_SPEC`` or ``SUBMESH``; ``supports_multihost`` implies
    #: ``MESH_SPEC``), under the same mirror contract; None: one device
    ranks_over: Optional[str] = None
    #: the group this process runs the service's rank in, given by
    #: ``serve.multihost`` before ``load()`` (None: one device)
    group = None

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg

    def load(self) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def warmup(self) -> None:
        self.infer(self.example_payload())

    def example_payload(self) -> Dict[str, Any]:
        return {}

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    def extra_routes(self) -> List[Tuple[str, Tuple[str, ...], Callable]]:
        """Additional ``(pattern, methods, handler(request, **params))``
        routes."""
        return []

    def ready_error(self) -> Optional[str]:
        """Non-None fails /readiness with the reason (e.g. a dead engine
        loop), so the LB stops routing into guaranteed 500s."""
        return None

    def liveness_error(self) -> Optional[str]:
        """Non-None fails ``/health`` (the liveness probe), so Kubernetes
        restarts the pod: wedged-beyond-recovery states only (the engine
        step watchdog)."""
        return None

    def drain(self, budget_s: float) -> None:
        """Finish in-flight work within ``budget_s`` seconds and stop
        accepting more (the SIGTERM path); engine-backed services drain
        their engine loop here."""
        return None

    def extra_stats(self) -> Dict[str, float]:
        """Numeric service-level gauges: ``/stats`` and the
        ``shai_service_<key>`` gauges on ``/metrics``."""
        return {}

    def engine_telemetry(self):
        """The engine's ``obs.steploop.StepTelemetry`` (None for services
        without an engine, or before it is built)."""
        return None

    def spec_counters(self) -> Optional[Dict[str, int]]:
        """Cumulative speculative-decoding counters (``{"drafted",
        "accepted", "committed"}``) for
        :meth:`~.metrics.MetricsPublisher.publish_spec`, or None when the
        service has no speculative engine. The ``/generate`` path forwards
        them after each served inference."""
        return None

    def affinity_digests(self) -> Optional[List[str]]:
        """Recently served prompt-affinity digests (``kvtier.affinity``),
        advertised under ``/stats`` -> ``kvtier.affinity``; None = no
        advertisement (no engine, or no prefix cache)."""
        return None

    #: disaggregated serving role (kvnet), advertised on ``/stats``;
    #: engine-backed services set it from ``kvnet.resolve_role``
    role: str = "both"

    def kv_tier(self):
        """The host KV block pool (``kvtier.pool.HostKVTier``) behind
        ``GET /kv/blocks``, or None (the route then 404s and peers
        recompute)."""
        return None

    def kvnet_stats(self):
        """The pod's ``kvnet.client.KvNetStats`` (``shai_kvnet_*``), shared
        by ``/kv/blocks`` and the decode-role pull; None without a tier."""
        return None

    # -- KV fabric (kvnet.directory) ---------------------------------------

    def affinity_heads(self) -> Optional[Dict[str, int]]:
        """Bounded affinity-digest -> chain-head map (``/stats`` ->
        ``kvtier.aff_heads``) for a fleet directory; None = no fabric
        participation."""
        return None

    def fabric_pull(self, source: str, head: int) -> Optional[int]:
        """Background replication (``POST /kv/pull``): resolve the run's
        hashes through ``source``'s ``/kv/digests?head=`` and fetch it into
        the local tier. Returns the blocks landed, or None when this pod
        has no fabric (the route then 404s)."""
        return None

    # -- live migration (kvnet.migrate) ------------------------------------

    def wants_migration(self) -> bool:
        """True when the drain runs a migrate phase before the budget ends
        (an engine-backed service with migration armed). Default False:
        the wait-then-stop drain."""
        return False

    def migrate_inflight(self) -> int:
        """Ship every request still running near the drain budget's end to
        a peer (the engine snapshots each one; its waiter ships the
        manifest and returns or streams the ``migrated`` handoff).
        Returns how many requests entered migration."""
        return 0

    def accept_migration(self, manifest, entries):
        """Accept one MIGRATE envelope (``POST /kv/migrate``): restore the
        run into the local tier and bank the manifest for its replay.
        Returns the ack, or None when this pod takes no migrations (the
        route 404s). Raises ``kvnet.migrate.MigrateBusy`` when the inbox
        is saturated (the route answers 429)."""
        return None

    def migrate_busy(self) -> Optional[float]:
        """Retry-After seconds when the inbox is saturated (the route
        answers 429 before it reads the envelope); None = accepting."""
        return None

    def pending_handoff(self) -> bool:
        """True while this pod still banks KV a peer may pull over
        ``GET /kv/blocks``: the drain then holds the server open until
        the budget ends."""
        return False

    def step_records(self, n: int = 256) -> List[Dict[str, Any]]:
        """The last ``n`` engine step records for the flight recorder."""
        tele = self.engine_telemetry()
        return tele.recent_steps(n) if tele is not None else []

    def close(self) -> None:
        """Release what ``load`` started (engine loop thread)."""


_SERVE_UI_HTML = """<!doctype html><meta charset="utf-8">
<title>%(app)s — %(task)s</title>
<style>body{font-family:sans-serif;max-width:52rem;margin:2rem auto}
textarea{width:100%%;font-family:monospace}pre{background:#f4f4f4;
padding:1rem;overflow:auto}</style>
<h1>%(app)s <small>(%(task)s)</small></h1>
<p>POST payload for <code>%(route)s</code>:</p>
<textarea id=payload rows=6>%(example)s</textarea>
<p><button onclick="run()">run</button>
<a href="/stats">stats</a> · <a href="/metrics">metrics</a> ·
<a href="/">config</a></p>
<pre id=out></pre>
<script>
async function run(){
  out.textContent = '...';
  const r = await fetch('%(route)s', {method:'POST', body: payload.value});
  out.textContent = JSON.stringify(await r.json(), null, 1);
}
</script>"""


def create_app(cfg: ServeConfig, service: ModelService,
               publisher: Optional[MetricsPublisher] = None) -> App:
    app = App(title=cfg.app)
    collector = LatencyCollector()
    pub = publisher or MetricsPublisher(cfg.app, cfg.nodepool, cfg.pod_name)
    state: Dict[str, Any] = {"loaded": False, "warm": False,
                             "load_error": None, "inflight": 0,
                             "lane_pending": 0}
    inflight_lock = threading.Lock()
    # request reliability: the bounded per-pod completion cache keyed
    # duplicates replay from; keyless traffic never touches it
    idem = rz_idemp.IdempotencyCache(
        max_entries=env_int("SHAI_IDEMP_CACHE", 1024),
        ttl_s=env_float("SHAI_IDEMP_TTL_S", 600.0))
    # bounded admission with the failover controller's thresholds (one
    # threshold owner), the tenant budget ledger riding the gate
    ledger = rz_qos.TenantLedger.from_env()
    gate = AdmissionGate(
        OverloadThresholds(max_queue_depth=cfg.admit_max_queue,
                           max_kv_utilization=cfg.admit_max_kv),
        max_inflight=cfg.max_inflight, ledger=ledger,
        tenant_max_inflight=env_int("SHAI_TENANT_MAX_INFLIGHT", 0))
    drainer = DrainController(budget_s=cfg.drain_budget_s)
    # every completed request's span timeline rings here (the asgi layer
    # closes each trace and sinks it); GET /debug/flight, /trace/{id}
    flight = FlightRecorder()
    app.trace_sink = flight.record_request
    # lifecycle probes and scrape surfaces must not ring the recorder;
    # /kv/* is probe-class too (a decode fleet's pulls would evict real
    # request timelines from the ring)
    app.trace_exclude |= {"/health/ready", "/debug/faults",
                          "/debug/conformance", "/profile", "/kv/blocks",
                          "/kv/migrate", "/kv/digests", "/kv/pull",
                          "/kv/protect", "/trace/{trace_id}"}
    pub.attach_engine_telemetry(service.engine_telemetry)
    pub.attach_idempotency(lambda: idem)
    pub.attach_tenant_ledger(lambda: ledger)
    pub.attach_service_stats(
        lambda: service.extra_stats() if state["loaded"] else {})
    lane = concurrent.futures.ThreadPoolExecutor(
        max_workers=max(1, service.concurrency), thread_name_prefix="model")
    app.state.update(cfg=cfg, service=service, collector=collector,
                     status=state, lane=lane, publisher=pub, flight=flight,
                     gate=gate, drainer=drainer, ledger=ledger, idem=idem)

    def _do_load_and_warm():
        t0 = time.perf_counter()
        try:
            service.load()
            state["loaded"] = True
            log.info("%s: model loaded in %.1fs", cfg.app,
                     time.perf_counter() - t0)
            if cfg.warmup:
                t1 = time.perf_counter()
                service.warmup()
                log.info("%s: warmup done in %.1fs", cfg.app,
                         time.perf_counter() - t1)
            state["warm"] = True
        except Exception as e:
            # the pod stays up but never ready: fail fast, no crash loop
            state["load_error"] = f"{type(e).__name__}: {e}"
            log.exception("%s: startup failed", cfg.app)

    @app.startup
    def _kick_off_load():
        state["load_future"] = lane.submit(_do_load_and_warm)

    @app.shutdown
    def _close():
        service.close()
        lane.shutdown(wait=False, cancel_futures=True)

    async def _run_model(fn: Callable, *args):
        loop = asyncio.get_running_loop()
        # under a COPY of the handler's context: run_in_executor does not
        # carry contextvars, and the request's deadline, QoS tag and trace
        # must reach the lane thread that submits to the engine
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(lane, lambda: ctx.run(fn, *args))

    def _require_ready():
        if state["load_error"]:
            raise HTTPError(500, f"model failed to load: {state['load_error']}")
        if not (state["loaded"] and state["warm"]):
            raise HTTPError(503, "model not ready")
        err = service.ready_error()
        if err:
            raise HTTPError(503, f"model unhealthy: {err}")

    # -- request lifecycle (resilience) ------------------------------------

    def _engine_snapshot() -> Optional[Dict[str, Any]]:
        tele = service.engine_telemetry()
        return None if tele is None else tele.snapshot()

    def _inflight_counts() -> Tuple[int, int]:
        """One locked read of (inflight, lane_pending); the lock is
        released before the gate and the ledger run, so it never nests
        with another lock."""
        with inflight_lock:
            return state["inflight"], state["lane_pending"]

    def _admit(tenant: str) -> None:
        """Shed (429/503 with ``Retry-After``) BEFORE the request parks a
        lane thread or enters the engine queue; every shed is counted on
        ``shai_shed_total`` under its reason and the tenant's label."""
        inflight, lane_pending = _inflight_counts()
        shed = gate.check(_engine_snapshot(), inflight=inflight,
                          draining=drainer.draining,
                          lane_width=max(1, service.concurrency),
                          lane_pending=lane_pending, tenant=tenant)
        if shed is not None:
            pub.count_shed(shed.reason, tenant)
            raise HTTPError(shed.status, shed.detail, headers=shed.headers)

    def _deadline_of(request: Request) -> Optional[rz_deadline.Deadline]:
        """The request's deadline: header wins, DEADLINE_MS fills in.
        Expired on arrival is a 504 before any model work."""
        try:
            dl = rz_deadline.deadline_from_headers(
                request.headers, default_ms=float(cfg.deadline_ms))
        except ValueError as e:
            raise HTTPError(400, str(e))
        if dl is not None and dl.expired:
            raise HTTPError(504, "deadline exceeded before processing")
        return dl

    class _InferScope:
        """Admission, deadline, QoS tag and in-flight accounting around
        one request. The deadline and the tag ride contextvars that
        ``_run_model``'s context copy carries onto the lane thread."""

        def __init__(self, request: Request):
            self.request = request
            self._tokens = None
            self._handed_off = False
            # the ledger-bounded tenant label every shed, charge and
            # in-flight count of this request attributes to
            self.tenant = ""

        def __enter__(self):
            raw_tenant, priority = rz_qos.qos_from_headers(
                self.request.headers)
            self.tenant = ledger.label_of(raw_tenant)
            _admit(self.tenant)
            dl = _deadline_of(self.request)
            # the engine tag carries the RAW (sanitized) tenant: an
            # untagged request reaches the engine untagged, keeping a
            # single-tenant pod on its FIFO path with no tenant families
            self._tokens = (
                rz_deadline.set_current_deadline(dl),
                rz_qos.set_current_qos(rz_qos.QosTag(tenant=raw_tenant,
                                                     priority=priority)))
            ledger.note_start(self.tenant)
            with inflight_lock:
                state["inflight"] += 1
                state["lane_pending"] += 1
            return dl

        def charge(self, out) -> None:
            """Debit the tenant's budget with the request's actual usage:
            OpenAI ``usage.total_tokens`` or ``/generate``'s prompt plus
            generated tokens; a floor of 1 unit otherwise."""
            tokens = 1
            if isinstance(out, dict):
                usage = out.get("usage")
                if isinstance(usage, dict) and isinstance(
                        usage.get("total_tokens"), (int, float)):
                    tokens = int(usage["total_tokens"])
                else:
                    try:
                        tokens = (int(out.get("n_tokens") or 0)
                                  + int(out.get("n_prompt") or 0))
                    except (TypeError, ValueError):
                        tokens = 1
            ledger.charge(self.tenant, max(1, tokens))

        def hand_off_inflight(self) -> Callable[[], None]:
            """Streaming: the request stays in flight until its stream
            DRAINS; returns the idempotent release the stream's iterator
            calls on its end (drain, disconnect or close). The lane-pending
            count drops now: the lane thread is free already."""
            self._handed_off = True
            with inflight_lock:
                state["lane_pending"] -= 1
            released = {"v": False}
            tenant = self.tenant

            def release():
                if not released["v"]:
                    released["v"] = True
                    with inflight_lock:
                        state["inflight"] -= 1
                    # a stream's tokens never reach the app layer mid-SSE:
                    # its budget is debited the floor
                    ledger.note_done(tenant)
                    ledger.charge(tenant, 1)

            return release

        def __exit__(self, *exc):
            if not self._handed_off:
                with inflight_lock:
                    state["inflight"] -= 1
                    state["lane_pending"] -= 1
                ledger.note_done(self.tenant)
            dl_token, qos_token = self._tokens
            rz_deadline.reset_current_deadline(dl_token)
            rz_qos.reset_current_qos(qos_token)
            return False

    def _record(t0: float) -> float:
        dt = time.perf_counter() - t0
        collector.record(dt)
        pub.publish(dt)
        return dt

    def _begin_drain(on_done: Optional[Callable[[], None]] = None) -> bool:
        """SIGTERM semantics, callable without a signal: flip readiness,
        shed new work, let in-flight requests (streams included) finish
        up to the drain budget, drain the service (its engine loop), then
        ``on_done`` (the server's shutdown). Idempotent: one drain per
        process. In order: the wait up to the budget less the migrate
        reserve, the migrate phase (when armed and work remains), the
        wait, ``service.drain``, the handoff hold."""
        if not drainer.begin():
            return False
        log.warning("%s: draining (budget %.1fs) — readiness now 503",
                    cfg.app, drainer.budget_s)

        def _work():
            idle = lambda: _inflight_counts()[0] == 0  # noqa: E731
            migrated = 0
            # the migrate phase: natural completion gets the budget less a
            # reservation, then what still runs is shipped to a peer, so
            # the pod's exit is a latency event for the long tail
            if service.wants_migration():
                from ..kvnet.migrate import migrate_reserve_s

                if not drainer.wait(idle, min_remaining=migrate_reserve_s(
                        drainer.budget_s)):
                    try:
                        migrated = service.migrate_inflight()
                        if migrated:
                            log.warning("%s: drain migrated %d in-flight "
                                        "request(s) to a peer", cfg.app,
                                        migrated)
                    except Exception:
                        log.exception("drain migrate phase failed — "
                                      "falling back to the budget wait")
            clean = drainer.wait(idle)
            if not clean:
                log.warning("%s: drain budget expired with %d requests "
                            "in flight", cfg.app, _inflight_counts()[0])
            try:
                service.drain(max(0.0, drainer.remaining_s))
            except Exception:
                log.exception("service drain failed")
            state["drained"] = {"clean": clean, "migrated": migrated,
                                "seconds": drainer.budget_s
                                - drainer.remaining_s}
            # the handoff hold: a pod whose tier still banks KV a peer may
            # pull keeps its probe-class GET routes (/kv/blocks) serving
            # until the budget ends
            try:
                while service.pending_handoff() and drainer.remaining_s > 0:
                    time.sleep(0.05)
            except Exception:
                log.exception("pending-handoff hold failed")
            if on_done is not None:
                on_done()

        threading.Thread(target=_work, daemon=True, name="drain").start()
        return True

    app.state["begin_drain"] = _begin_drain

    # -- uniform surface ---------------------------------------------------

    @app.get("/")
    def root(request: Request):
        return {
            "app": cfg.app,
            "task": service.task,
            "model_id": cfg.model_id,
            "device": cfg.device,
            "endpoints": sorted({r.pattern for r in app.routes}),
            "config": cfg.describe(),
            "served": pub.served,
        }

    @app.get("/health")
    def health(request: Request):
        # LIVENESS: only wedged-beyond-recovery states fail it; a
        # draining pod is still live (it is finishing real work)
        err = service.liveness_error()
        if err:
            return Response({"status": "stuck", "error": err}, status=503)
        return {"status": "ok"}

    @app.get("/readiness")
    @app.get("/health/ready")
    def readiness(request: Request):
        if drainer.draining:
            # the drain flips readiness first: the LB stops routing while
            # in-flight requests finish inside the budget
            return Response({"status": "draining"}, status=503)
        if state["load_error"]:
            return Response({"status": "failed",
                             "error": state["load_error"]}, status=500)
        if not (state["loaded"] and state["warm"]):
            return Response({"status": "loading"}, status=503)
        err = service.ready_error()
        if err:
            return Response({"status": "unhealthy", "error": err},
                            status=503)
        return {"status": "ready"}

    async def _idem_replay_or_claim(key: str):
        """A cached result (or a joined in-flight one) as the response;
        None when this caller owns the execution. Joiners wait on the
        entry's event off the event loop."""
        await rz_faults.get().asleep_at(rz_faults.IDEMP_LOOKUP)
        st, entry = idem.begin(key)
        if st == "new":
            return None
        if st == "done":
            return dict(entry.result, idempotent_replay=True)
        woke = await asyncio.get_running_loop().run_in_executor(
            None, entry.event.wait, 600.0)
        if entry.state == "done" and entry.result is not None:
            return dict(entry.result, idempotent_replay=True)
        if not woke:
            raise HTTPError(
                409, f"duplicate of an in-flight request (key {key!r}) "
                     f"that has not completed; retry later")
        # the original failed (failures are not cached): run again
        return None

    @app.post(service.infer_route)
    async def task_infer(request: Request):
        _require_ready()
        # keyed duplicates replay or join BEFORE admission, so a replay
        # never charges the tenant ledger a second time
        key = request.headers.get(rz_idemp.IDEMP_HEADER, "")
        if key:
            if not rz_idemp.valid_key(key):
                raise HTTPError(400, "bad idempotency key (want "
                                     "[A-Za-z0-9_.:-]{1,128})")
            cached = await _idem_replay_or_claim(key)
            if cached is not None:
                return cached
        payload = request.json()
        if key:
            payload["idem_key"] = key
        t0 = time.perf_counter()
        try:
            scope = _InferScope(request)
            with scope:
                # annotation=False: held across an await on the event loop
                with obs_trace.span("model_infer", annotation=False):
                    out = await _run_model(service.infer, payload)
            scope.charge(out)
        except BaseException:
            if key:
                idem.fail(key)
            raise
        dt = _record(t0)
        sc = service.spec_counters()
        if sc is not None:
            pub.publish_spec(**sc)
        tele = service.engine_telemetry()
        if tele is not None:
            pub.publish_engine(tele)
        if isinstance(out, dict):
            out.setdefault("latency_s", round(dt, 4))
        if key and isinstance(out, dict):
            # after the latency stamp: a replay is byte-equal to the
            # original (but for the replay marker)
            idem.complete(key, out)
        return out

    @app.post("/benchmark")
    async def benchmark(request: Request):
        _require_ready()
        payload = request.json()
        n_runs = int(payload.get("n_runs", cfg.num_of_runs_inf))
        if n_runs < 1 or n_runs > 10_000:
            raise HTTPError(400, "n_runs must be in [1, 10000]")
        example = payload.get("payload") or service.example_payload()
        report = await _run_model(
            lambda: run_benchmark(lambda: service.infer(example), n_runs,
                                  collector))
        return {"app": cfg.app, "report": report.to_dict()}

    @app.get("/load/{n_runs:int}/infer/{n_inf:int}")
    async def load_infer(request: Request, n_runs: int, n_inf: int):
        """``n_runs`` benchmark rounds of ``n_inf`` inferences each, every
        inference published (the reference's ``app/run-sd.py:157-175``)."""
        _require_ready()
        if n_runs < 1 or n_inf < 1 or n_runs * n_inf > 100_000:
            raise HTTPError(400, "bad load shape")
        example = service.example_payload()

        def _one_round():
            return run_benchmark(lambda: service.infer(example), n_inf,
                                 collector, on_sample=pub.publish)

        reports = []
        for _ in range(n_runs):
            reports.append((await _run_model(_one_round)).to_dict())
        return {"app": cfg.app, "rounds": reports, "served_total": pub.served}

    @app.get("/serve")
    def serve_ui(request: Request):
        """A dependency-free HTML console over the infer route (the
        reference mounts Gradio at ``/serve``)."""
        example = json.dumps(service.example_payload() or {"prompt": ""},
                             indent=1)
        return Response(_SERVE_UI_HTML % {
            "app": cfg.app, "task": service.task,
            "route": service.infer_route, "example": example},
            media_type="text/html")

    @app.get("/stats")
    def stats(request: Request):
        inflight, lane_pending = _inflight_counts()
        out: Dict[str, Any] = {
            "served": pub.served, "latency": collector.report(),
            "count": collector.count, "inflight": inflight,
            "lane_pending": lane_pending, "draining": drainer.draining}
        if gate.shed_total:
            out["shed"] = {"total": gate.shed_total,
                           **gate.shed_by_reason()}
        isnap = idem.snapshot()
        if any(isnap.values()):
            out["idempotency"] = isnap
        tele = service.engine_telemetry()
        if state["loaded"]:
            svc = service.extra_stats()
            # the unit's gauges at the top level (the port's earlier
            # contract) and under "service" (the reference's)
            out.update(svc)
            out["service"] = svc
        if tele is not None:
            out["engine"] = tele.snapshot()
            for sec, obj in (("slo", tele.slo), ("hbm", tele.hbm),
                             ("perf", tele.sentinel),
                             ("kvtier", tele.kvtier),
                             ("migrate", tele.migrate),
                             ("kvfabric", tele.kvfabric)):
                if obj is not None:
                    out[sec] = obj.snapshot()
        # warm-prefix advertisement (even tier-less: the device prefix
        # cache is warm too), and the host tier's chain-head runs
        aff = service.affinity_digests()
        if aff is not None:
            out.setdefault("kvtier", {})["affinity"] = aff
        tier = service.kv_tier()
        if tier is not None:
            out.setdefault("kvtier", {})["adverts"] = tier.advertisement()
        heads = service.affinity_heads()
        if heads:
            out.setdefault("kvtier", {})["aff_heads"] = heads
        # disaggregated serving: the pod's role, and the transport's
        # counters on a pod in the network KV plane
        out["role"] = service.role
        kn = service.kvnet_stats()
        if kn is not None:
            out["kvnet"] = kn.snapshot()
        # multi-tenant QoS: the ledger's per-tenant usage joined with the
        # engine's per-tenant view (namespaced engine_*: the two count
        # different things) and the scheduler's pick counters
        tenants: Dict[str, Dict[str, Any]] = {}
        for t, ent in ledger.snapshot().items():
            tenants.setdefault(t, {}).update(ent)
        sched = None
        if tele is not None:
            for t, ent in tele.tenant_snapshot().items():
                tenants.setdefault(t, {}).update(
                    {f"engine_{k}": v for k, v in ent.items()})
            sched = tele.qos_sched
        if tenants or sched is not None or ledger.metered:
            out["qos"] = {"metered": ledger.metered, "tenants": tenants}
            if sched is not None:
                out["qos"]["scheduler"] = sched.snapshot()
        return out

    @app.get("/kv/blocks")
    async def kv_blocks(request: Request):
        """Serve this pod's host-tier blocks by chain hash: ``?hashes=`` is
        a comma-joined list, the answer the LEADING contiguous resident
        run as binary frames (``(k, v)`` per block, or the int8 4-tuple
        ``(k, v, ks, vs)``), byte-exact. Probe-class: no admission gate,
        out of the flight ring, at most ``MAX_BLOCKS_PER_REQUEST`` hashes;
        a pod without a tier 404s. The copy and encode run on the default
        executor, neither on the event loop (probes must keep answering)
        nor on the model lane (a pull must not queue behind a step)."""
        from ..kvnet import client as kvnet_client
        from ..kvnet import frames as kvnet_frames

        tier = service.kv_tier()
        if tier is None:
            raise HTTPError(404, "no host KV tier on this pod")
        raw = request.query.get("hashes", "")
        try:
            hashes = [int(h) for h in raw.split(",") if h.strip()]
        except ValueError:
            raise HTTPError(400, "hashes must be comma-joined integers")
        if not hashes:
            raise HTTPError(400, "missing hashes")
        if len(hashes) > kvnet_client.MAX_BLOCKS_PER_REQUEST:
            raise HTTPError(
                400, f"at most {kvnet_client.MAX_BLOCKS_PER_REQUEST} "
                     f"hashes per request")

        def _gather() -> Tuple[int, bytes]:
            run = tier.get_run(hashes)
            return len(run), kvnet_frames.encode_frames(run)

        n_run, body = await asyncio.get_running_loop().run_in_executor(
            None, _gather)
        stats = service.kvnet_stats()
        if stats is not None:
            stats.count_served(n_run, len(body))
        return Response(body, media_type="application/octet-stream",
                        headers={"x-shai-kv-blocks": str(n_run)})

    @app.get("/kv/digests")
    def kv_digests(request: Request):
        """The host tier's bounded chain-head advertisement
        (``{"adverts": [{"head", "n", "seq"}, ...]}``), or with ``?head=``
        one advertised run's hash chain. Probe-class, O(bounded) reads off
        the tier's incrementally kept caches; 404 without a tier."""
        tier = service.kv_tier()
        if tier is None:
            raise HTTPError(404, "no host KV tier on this pod")
        raw = request.query.get("head", "")
        if raw:
            try:
                head = int(raw)
            except ValueError:
                raise HTTPError(400, "head must be an integer chain hash")
            return {"head": head, "hashes": tier.run_hashes(head)}
        return {"adverts": tier.advertisement()}

    @app.post("/kv/pull")
    async def kv_pull(request: Request):
        """Hot-prefix replication: pull one advertised run from ``source``
        into this pod's tier (``{"source": url, "head": chain_hash}``).
        Infrastructure route (no admission gate: background warmth, not
        a request), refused while draining, 404 with the fabric off. The
        fetch runs on the default executor."""
        _require_ready()
        if drainer.draining:
            raise HTTPError(503, "pod is draining; pick another peer",
                            headers={"retry-after": "1"})
        body = request.json()
        try:
            source = str(body["source"])
            head = int(body["head"])
        except (ValueError, TypeError, KeyError):
            raise HTTPError(400, "need {source: url, head: chain_hash}")
        n = await asyncio.get_running_loop().run_in_executor(
            None, service.fabric_pull, source, head)
        if n is None:
            raise HTTPError(404, "no KV fabric on this pod")
        return {"fetched": int(n)}

    @app.post("/kv/protect")
    async def kv_protect(request: Request):
        """Last-holder eviction deferral: the runs this pod is the fleet's
        only advertised holder of (``{"heads": [chain_hash], "ttl_s":
        s}``) are skipped by the tier's LRU for up to 60 s. Advisory
        (capacity still wins), 404 without a tier."""
        tier = service.kv_tier()
        if tier is None:
            raise HTTPError(404, "no host KV tier on this pod")
        body = request.json()
        try:
            heads = [int(h) for h in body.get("heads", [])]
            ttl_s = float(body.get("ttl_s", 5.0))
        except (ValueError, TypeError, AttributeError):
            raise HTTPError(400, "need {heads: [chain_hash], ttl_s: s}")
        return {"protected": tier.protect(heads, min(ttl_s, 60.0))}

    @app.post("/kv/migrate")
    async def kv_migrate(request: Request):
        """Live migration's accept: one MIGRATE envelope (manifest and
        CRC-checked frames) restores into this pod's tier and banks the
        manifest for its replay. Infrastructure route: no admission gate
        (the request paid admission on the draining pod; the resume pays
        this pod's), refused while draining, 429 with ``Retry-After``
        while the inbox is saturated (before the body is decoded), and a
        body cap of the manifest cap plus ``MAX_BLOCKS_PER_REQUEST``
        blocks. The decode and restore run on the default executor."""
        from ..kvnet import migrate as kv_migrate_mod
        from ..kvnet.client import MAX_BLOCKS_PER_REQUEST

        _require_ready()
        if drainer.draining:
            raise HTTPError(503, "pod is draining; pick another peer",
                            headers={"retry-after": "1"})
        busy_s = service.migrate_busy()
        if busy_s is not None:
            raise HTTPError(429, "migration inbox saturated; try "
                                 "another peer",
                            headers={"retry-after": f"{float(busy_s):g}"})
        body = request.body
        if not body:
            raise HTTPError(400, "empty migration envelope")
        tier = service.kv_tier()
        max_body = kv_migrate_mod.MAX_MANIFEST_BYTES + (1 << 16)
        if tier is not None:
            max_body += MAX_BLOCKS_PER_REQUEST * tier.block_nbytes * 2
        if len(body) > max_body:
            raise HTTPError(400, f"migration envelope of {len(body)} "
                                 f"bytes exceeds the {max_body}-byte cap")

        def _accept():
            manifest, entries = kv_migrate_mod.decode_migration(body)
            if len(entries) > MAX_BLOCKS_PER_REQUEST:
                raise kv_migrate_mod.MigrateError(
                    f"envelope carries {len(entries)} blocks, cap is "
                    f"{MAX_BLOCKS_PER_REQUEST}")
            return service.accept_migration(manifest, entries)

        try:
            ack = await asyncio.get_running_loop().run_in_executor(
                None, _accept)
        except kv_migrate_mod.MigrateError as e:
            raise HTTPError(400, f"bad migration envelope: {e}")
        except kv_migrate_mod.MigrateBusy as e:
            # the check-then-accept race, closed at the real accept
            raise HTTPError(429, "migration inbox saturated; try "
                                 "another peer",
                            headers={"retry-after":
                                     f"{e.retry_after_s:g}"})
        if ack is None:
            raise HTTPError(404, "this pod does not accept migrations")
        return ack

    @app.get("/metrics")
    def metrics(request: Request):
        return Response(pub.render(), media_type=CONTENT_TYPE)

    @app.get("/debug/conformance")
    def debug_conformance(request: Request):
        """Declared budgets against live reality: the HBM ledger, the SLO
        burn rates and the perf sentinel, with one verdict."""
        tele = service.engine_telemetry()
        out: Dict[str, Any] = {"app": cfg.app}
        hbm = slo = perf = None
        if tele is not None:
            hbm, slo, perf = tele.hbm, tele.slo, tele.sentinel
            out["engine"] = tele.snapshot()
        out["hbm"] = hbm.snapshot() if hbm is not None else None
        out["slo"] = slo.snapshot() if slo is not None else None
        out["perf"] = perf.snapshot() if perf is not None else None
        verdict = {
            "hbm_leak_suspect": bool((out["hbm"] or {}).get("leak_suspect")),
            "slo_breach": bool((out["slo"] or {}).get("breach")),
            "perf_degraded": bool((out["perf"] or {}).get("degraded")),
        }
        verdict["ok"] = not any(verdict.values())
        out["verdict"] = verdict
        return out

    @app.get("/debug/faults")
    def debug_faults(request: Request):
        """The live fault schedule (spec, seed, per-clause draws and
        firings)."""
        return rz_faults.get().snapshot()

    @app.post("/debug/faults")
    def debug_faults_set(request: Request):
        """Replace the fault schedule: ``{"spec": "...", "seed": 0}``.
        Armed only by ``SHAI_FAULTS_ENDPOINT=1``: a production pod must not
        take fault writes off its serving port."""
        if not rz_faults.endpoint_enabled():
            raise HTTPError(403, "fault injection endpoint is not enabled "
                                 "(set SHAI_FAULTS_ENDPOINT=1)")
        body = request.json()
        try:
            inj = rz_faults.configure(str(body.get("spec", "")),
                                      int(body.get("seed", 0) or 0))
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad fault spec: {e}")
        return inj.snapshot()

    @app.get("/debug/flight")
    def debug_flight(request: Request):
        """The last completed request timelines and the engine's recent
        step records (bounded rings)."""
        n_req = None
        if "requests" in request.query:
            try:
                n_req = max(0, int(request.query["requests"]))
            except ValueError:
                raise HTTPError(400, "requests must be an integer")
        return flight.dump(step_source=service.step_records,
                           n_requests=n_req)

    @app.get("/trace/{trace_id}")
    def trace_by_id(request: Request, trace_id: str):
        """Every flight-ring record under ``trace_id``; 404 when it never
        recorded here or was evicted."""
        traces = flight.traces_for(trace_id)
        if not traces:
            raise HTTPError(404, f"trace {trace_id} not in flight ring")
        return {"trace_id": trace_id, "traces": traces}

    # one trace at a time; "task" pins the stop coroutine (the event loop
    # holds tasks weakly, and a collected stop task would leave the trace
    # open for good)
    profile_state: Dict[str, Any] = {"until": 0.0, "dir": None, "task": None}

    @app.get("/profile")
    def profile_status(request: Request):
        """The profiler session's state; ``trace_dir`` is the last
        session's trace directory (the current one's while it runs)."""
        now = time.time()
        running = now < profile_state["until"] or bool(profile_state["task"])
        return {"running": running,
                "seconds_left": round(max(0.0, profile_state["until"] - now),
                                      1),
                "trace_dir": profile_state["dir"]}

    @app.post("/profile/{seconds:int}")
    async def profile(request: Request, seconds: int):
        """Trace the card (and the host) with ``torch.profiler`` for
        ``seconds`` while the pod keeps serving; the Chrome trace lands
        under ``ARTIFACT_ROOT/traces/<app>/<stamp>/``, with the engine's
        ``engine.prefill``/``engine.decode`` ranges and the request spans
        (``obs.trace``) in it."""
        if seconds < 1 or seconds > 300:
            raise HTTPError(400, "seconds must be in [1, 300]")
        now = time.time()
        if now < profile_state["until"] or profile_state["task"]:
            left = max(0.0, profile_state["until"] - now)
            raise HTTPError(409, f"trace already running ({left:.0f}s left)")
        import torch

        trace_dir = os.path.join(cfg.artifact_root, "traces", cfg.app,
                                 time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(trace_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available() and cfg.device == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            # every thread: the engine loop and the model lane run the
            # engine.prefill/engine.decode ranges and the request spans
            every = {"experimental_config": torch._C._profiler
                     ._ExperimentalConfig(profile_all_threads=True)}
        except (AttributeError, TypeError):  # a torch without the option
            log.warning("torch.profiler cannot profile all threads here; "
                        "the trace holds this thread's ranges only")
            every = {}
        prof = torch.profiler.profile(activities=activities, **every)
        try:
            prof.start()
        except RuntimeError as e:
            # the profiler is held by another session in this process
            raise HTTPError(409, f"trace already running: {e}")
        obs_trace.set_profiling(True)
        profile_state.update(until=now + seconds, dir=trace_dir)

        async def _stop_later():
            await asyncio.sleep(seconds)
            try:
                obs_trace.set_profiling(False)
                prof.stop()
                path = os.path.join(trace_dir, "trace.json")
                await asyncio.get_running_loop().run_in_executor(
                    None, prof.export_chrome_trace, path)
            except Exception:
                log.exception("profiler stop failed")
            finally:
                profile_state["until"] = 0.0
                profile_state["task"] = None

        profile_state["task"] = asyncio.get_running_loop().create_task(
            _stop_later())
        return {"trace_dir": trace_dir, "seconds": seconds,
                "hint": "open <trace_dir>/trace.json in chrome://tracing "
                        "or Perfetto"}

    # -- the unit's own routes --------------------------------------------
    for pattern, methods, handler in service.extra_routes():
        if tuple(methods) == ("GET",):
            # GET-only extra routes are metadata (/v1/models): no gate, no
            # deadline, no lane — a client enumerating models must not eat
            # a 429/503 from a pod that is merely busy or draining
            def _wrap_meta(h):
                async def _meta_handler(request: Request, **params):
                    _require_ready()
                    return h(request, **params)
                return _meta_handler
            app.route(pattern, tuple(methods))(_wrap_meta(handler))
            continue

        def _wrap(h):
            async def _handler(request: Request, **params):
                _require_ready()
                t0 = time.perf_counter()
                scope = _InferScope(request)
                with scope:
                    with obs_trace.span("model_infer", annotation=False):
                        out = await _run_model(lambda: h(request, **params))
                    if isinstance(out, StreamingResponse):
                        # in flight (and timed) until the stream DRAINS,
                        # not when the handler returns the submission: a
                        # live stream counts against MAX_INFLIGHT and the
                        # drain waits for it
                        release = scope.hand_off_inflight()
                        inner = out.iterator

                        def timed_iter():
                            try:
                                yield from inner  # closing this closes inner
                            finally:
                                release()
                                _record(t0)

                        out.iterator = timed_iter()
                        return out
                scope.charge(out)
                _record(t0)
                tele = service.engine_telemetry()
                if tele is not None:
                    pub.publish_engine(tele)
                return out
            return _handler
        app.route(pattern, tuple(methods))(_wrap(handler))

    return app


def serve_forever(cfg: ServeConfig, service: ModelService) -> None:
    """Pod entrypoint: build the app, start the metrics exporter on
    ``METRICS_PORT`` (0: none), and serve until interrupted. SIGTERM
    begins the graceful drain: readiness 503, new work shed with
    ``Retry-After``, in-flight requests finished inside
    ``DRAIN_BUDGET_S``, the engine loop drained, then the server stops and
    the process exits 0."""
    import signal

    from .httpd import Server

    pub = MetricsPublisher(cfg.app, cfg.nodepool, cfg.pod_name)
    app = create_app(cfg, service, publisher=pub)
    server = Server(app, port=cfg.port)
    if cfg.metrics_port:
        try:
            pub.start_exporter(cfg.metrics_port)
        except OSError as e:
            log.warning("metrics exporter on port %d not started: %s",
                        cfg.metrics_port, e)

    def _on_sigterm(signum, frame):
        app.state["begin_drain"](on_done=server.request_shutdown)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (embedded use)
        log.warning("cannot install SIGTERM drain handler off the main "
                    "thread; relying on the platform grace period")
    try:
        server.run()
    finally:
        pub.stop_exporter()
