"""The serving runtime: one app factory for every model unit.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/serve/app.py``
(``ModelService``, ``create_app``, ``serve_forever``) with the uniform
surface this port serves:

- ``GET  /``              self-describing config (redacted)
- ``GET  /health``        liveness
- ``GET  /readiness``     503 until the model is loaded and warm; also
  ``GET /health/ready``
- ``GET  /stats``         latency report plus the unit's gauges
- ``GET  /metrics``       Prometheus text exposition (``serve/metrics.py``)
- ``GET  /profile``       the profiler session's state;
  ``POST /profile/{seconds}`` traces the card with ``torch.profiler`` for
  that long while the pod keeps serving (409 while one runs)
- the unit's infer route (``POST /generate`` for the vllm unit) and its
  ``extra_routes`` (the OpenAI routes)

Every request to the infer route or a non-GET extra route carries a
deadline (``X-SHAI-Deadline-Ms``, or the ``DEADLINE_MS`` default; one
already expired on arrival is a 504 before any model work) and a QoS tag
(``X-SHAI-Tenant``, ``X-SHAI-Priority``), both on contextvars that the
model lane's call runs under (``_run_model`` copies the context). Model
work runs on a thread pool (the "model lane"), so the event loop keeps
answering probes during a load or a long request. Admission shedding,
tenant budgets, idempotency, tracing, the SIGTERM drain, ``/benchmark``,
``/load``, ``/serve`` and ``/debug`` come in later slices.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..resilience import deadline as rz_deadline
from ..resilience import qos as rz_qos
from ..utils.env import ServeConfig
from ..utils.latency import LatencyCollector
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

    def extra_stats(self) -> Dict[str, float]:
        """Numeric service-level gauges merged into ``/stats``."""
        return {}

    def engine_telemetry(self):
        """The engine's ``obs.steploop.StepTelemetry`` (None for services
        without an engine, or before it is built)."""
        return None

    def close(self) -> None:
        """Release what ``load`` started (engine loop thread)."""


def create_app(cfg: ServeConfig, service: ModelService,
               publisher: Optional[MetricsPublisher] = None) -> App:
    app = App(title=cfg.app)
    collector = LatencyCollector()
    pub = publisher or MetricsPublisher(cfg.app, cfg.nodepool, cfg.pod_name)
    state: Dict[str, Any] = {"loaded": False, "warm": False,
                             "load_error": None}
    lane = concurrent.futures.ThreadPoolExecutor(
        max_workers=max(1, service.concurrency), thread_name_prefix="model")
    app.state.update(cfg=cfg, service=service, collector=collector,
                     status=state, lane=lane, publisher=pub)

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
        # carry contextvars, and the request's deadline and QoS tag must
        # reach the lane thread that submits to the engine
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

    class _RequestScope:
        """The deadline and the tenant/priority tag of one request, set on
        contextvars for its model call and reset after it."""

        def __init__(self, request: Request):
            self.request = request
            self._tokens = None

        def __enter__(self):
            dl = _deadline_of(self.request)
            tenant, priority = rz_qos.qos_from_headers(self.request.headers)
            self._tokens = (
                rz_deadline.set_current_deadline(dl),
                rz_qos.set_current_qos(rz_qos.QosTag(tenant=tenant,
                                                     priority=priority)))
            return dl

        def __exit__(self, *exc):
            dl_token, qos_token = self._tokens
            rz_deadline.reset_current_deadline(dl_token)
            rz_qos.reset_current_qos(qos_token)
            return False

    def _record(t0: float) -> None:
        dt = time.perf_counter() - t0
        collector.record(dt)
        pub.publish(dt)

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
        return {"status": "ok"}

    @app.get("/readiness")
    @app.get("/health/ready")
    def readiness(request: Request):
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

    @app.post(service.infer_route)
    async def task_infer(request: Request):
        _require_ready()
        payload = request.json()
        t0 = time.perf_counter()
        with _RequestScope(request):
            out = await _run_model(service.infer, payload)
        _record(t0)
        if isinstance(out, dict):
            out.setdefault("latency_s", round(time.perf_counter() - t0, 4))
        return out

    @app.get("/stats")
    def stats(request: Request):
        out = {"served": pub.served, "latency": collector.report(),
               "count": collector.count}
        if state["loaded"]:
            out.update(service.extra_stats())
        return out

    @app.get("/metrics")
    def metrics(request: Request):
        return Response(pub.render(service.engine_telemetry),
                        media_type=CONTENT_TYPE)

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
        under ``ARTIFACT_ROOT/traces/<app>/<stamp>/``."""
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
        prof = torch.profiler.profile(activities=activities)
        try:
            prof.start()
        except RuntimeError as e:
            # the profiler is held by another session in this process
            raise HTTPError(409, f"trace already running: {e}")
        profile_state.update(until=now + seconds, dir=trace_dir)

        async def _stop_later():
            await asyncio.sleep(seconds)
            try:
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
            # GET-only extra routes are metadata (/v1/models): no
            # deadline, no lane
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
                with _RequestScope(request):
                    out = await _run_model(lambda: h(request, **params))
                if isinstance(out, StreamingResponse):
                    # the request is served when its stream DRAINS, not
                    # when the handler returns it
                    inner = out.iterator

                    def timed_iter():
                        try:
                            yield from inner   # closing this closes inner
                        finally:
                            _record(t0)

                    out.iterator = timed_iter()
                    return out
                _record(t0)
                return out
            return _handler
        app.route(pattern, tuple(methods))(_wrap(handler))

    return app


def serve_forever(cfg: ServeConfig, service: ModelService) -> None:
    """Pod entrypoint: build the app and serve until interrupted."""
    from .httpd import Server

    Server(create_app(cfg, service), port=cfg.port).run()
