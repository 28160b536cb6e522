"""The serving runtime: one app factory for every model unit.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/serve/app.py``
(``ModelService``, ``create_app``, ``serve_forever``) with the uniform
surface this slice serves:

- ``GET  /``           self-describing config (redacted)
- ``GET  /health``     liveness
- ``GET  /readiness``  503 until the model is loaded and warm
- ``GET  /stats``      latency report plus the unit's gauges
- the unit's infer route (``POST /generate`` for the vllm unit)

Model work runs on a thread pool (the "model lane"), so the event loop
keeps answering probes during a load or a long request. Admission control,
deadlines, QoS, idempotency, ``/metrics``, tracing and the benchmark routes
come in later slices.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..utils.env import ServeConfig
from ..utils.latency import LatencyCollector
from .asgi import App, HTTPError, Request, Response

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

    def ready_error(self) -> Optional[str]:
        """Non-None fails /readiness with the reason (e.g. a dead engine
        loop), so the LB stops routing into guaranteed 500s."""
        return None

    def extra_stats(self) -> Dict[str, float]:
        """Numeric service-level gauges merged into ``/stats``."""
        return {}

    def close(self) -> None:
        """Release what ``load`` started (engine loop thread)."""


def create_app(cfg: ServeConfig, service: ModelService) -> App:
    app = App(title=cfg.app)
    collector = LatencyCollector()
    state: Dict[str, Any] = {"loaded": False, "warm": False,
                             "load_error": None, "served": 0}
    lock = threading.Lock()
    lane = concurrent.futures.ThreadPoolExecutor(
        max_workers=max(1, service.concurrency), thread_name_prefix="model")
    app.state.update(cfg=cfg, service=service, collector=collector,
                     status=state, lane=lane)

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
        return await loop.run_in_executor(lane, fn, *args)

    def _require_ready():
        if state["load_error"]:
            raise HTTPError(500, f"model failed to load: {state['load_error']}")
        if not (state["loaded"] and state["warm"]):
            raise HTTPError(503, "model not ready")
        err = service.ready_error()
        if err:
            raise HTTPError(503, f"model unhealthy: {err}")

    @app.get("/")
    def root(request: Request):
        return {
            "app": cfg.app,
            "task": service.task,
            "model_id": cfg.model_id,
            "device": cfg.device,
            "endpoints": sorted({path for _, path, _ in app.routes}),
            "config": cfg.describe(),
            "served": state["served"],
        }

    @app.get("/health")
    def health(request: Request):
        return {"status": "ok"}

    @app.get("/readiness")
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
        out = await _run_model(service.infer, payload)
        dt = time.perf_counter() - t0
        collector.record(dt)
        with lock:
            state["served"] += 1
        if isinstance(out, dict):
            out.setdefault("latency_s", round(dt, 4))
        return out

    @app.get("/stats")
    def stats(request: Request):
        out = {"served": state["served"], "latency": collector.report(),
               "count": collector.count}
        if state["loaded"]:
            out.update(service.extra_stats())
        return out

    return app


def serve_forever(cfg: ServeConfig, service: ModelService) -> None:
    """Pod entrypoint: build the app and serve until interrupted."""
    from .httpd import Server

    Server(create_app(cfg, service), port=cfg.port).run()
