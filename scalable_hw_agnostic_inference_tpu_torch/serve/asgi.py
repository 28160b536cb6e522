"""Minimal ASGI micro-framework — the serving runtime's HTTP substrate.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/serve/asgi.py``: the
router, ``Request``/``Response``/``HTTPError`` and the ASGI-3 ``http``
entry point. Routes are exact paths and bodies are JSON: path parameters,
query strings, the lifespan protocol, request tracing and streaming
responses (SSE) come with the routes that use them in later slices.
"""

from __future__ import annotations

import inspect
import json
import logging
import traceback
from typing import Any, Awaitable, Callable, Dict, List, Tuple

log = logging.getLogger(__name__)


class HTTPError(Exception):
    """Raise inside a handler to return a non-200 JSON error."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class Request:
    """One HTTP request as seen by a handler."""

    def __init__(self, scope: Dict, body: bytes):
        self.method: str = scope["method"].upper()
        self.path: str = scope["path"]
        self.headers: Dict[str, str] = {
            k.decode("latin-1").lower(): v.decode("latin-1")
            for k, v in scope.get("headers", [])
        }
        self.body: bytes = body

    def json(self) -> Any:
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from e


class Response:
    """A JSON response."""

    def __init__(self, content: Any = None, status: int = 200):
        self.status = status
        self.body = json.dumps(content).encode()
        self.headers = {"content-type": "application/json",
                        "content-length": str(len(self.body))}


class App:
    """ASGI-3 application with decorator routing and startup hooks."""

    def __init__(self, title: str = "shai-cuda"):
        self.title = title
        self.routes: List[Tuple[str, str, Callable]] = []  # method, path, fn
        self.on_startup: List[Callable[[], Any]] = []
        self.on_shutdown: List[Callable[[], Any]] = []
        self.state: Dict[str, Any] = {}
        self._started = False

    def route(self, path: str, method: str):
        def deco(fn):
            self.routes.append((method, path, fn))
            return fn

        return deco

    def get(self, path: str):
        return self.route(path, "GET")

    def post(self, path: str):
        return self.route(path, "POST")

    def startup(self, fn):
        self.on_startup.append(fn)
        return fn

    def shutdown(self, fn):
        self.on_shutdown.append(fn)
        return fn

    async def _run_startup(self):
        if self._started:
            return
        self._started = True
        for fn in self.on_startup:
            r = fn()
            if inspect.isawaitable(r):
                await r

    async def _run_shutdown(self):
        for fn in self.on_shutdown:
            r = fn()
            if inspect.isawaitable(r):
                await r

    async def _dispatch(self, request: Request) -> Response:
        allowed = False
        for method, path, handler in self.routes:
            if path != request.path:
                continue
            if request.method != method:
                allowed = True
                continue
            result = handler(request)
            if inspect.isawaitable(result):
                result = await result
            return result if isinstance(result, Response) else Response(result)
        if allowed:
            return Response({"detail": "method not allowed"}, status=405)
        return Response({"detail": f"not found: {request.path}"}, status=404)

    async def __call__(self, scope: Dict,
                       receive: Callable[[], Awaitable], send: Callable):
        if scope["type"] != "http":
            raise RuntimeError(f"unsupported scope type {scope['type']}")
        await self._run_startup()

        body = b""
        while True:
            message = await receive()
            if message["type"] == "http.request":
                body += message.get("body", b"")
                if not message.get("more_body"):
                    break
            elif message["type"] == "http.disconnect":
                return

        request = Request(scope, body)
        try:
            response = await self._dispatch(request)
        except HTTPError as e:
            response = Response({"detail": e.detail}, status=e.status)
        except Exception:
            log.error("handler error on %s %s\n%s", request.method,
                      request.path, traceback.format_exc())
            response = Response({"detail": "internal server error"},
                                status=500)
        await send({
            "type": "http.response.start",
            "status": response.status,
            "headers": [(k.encode("latin-1"), v.encode("latin-1"))
                        for k, v in response.headers.items()],
        })
        await send({"type": "http.response.body", "body": response.body})
