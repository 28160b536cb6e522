"""Minimal ASGI micro-framework — the serving runtime's HTTP substrate.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/serve/asgi.py``: the
router, ``Request``/``Response``/``StreamingResponse``/``HTTPError`` and
the ASGI-3 ``http`` entry point with query strings and the request
trace. Route patterns take ``{name}`` (string) and ``{name:int}``
segments, passed to the handler as keyword arguments. A
:class:`StreamingResponse` (an SSE token stream) is pulled on the app's
own stream executor, never the model lane, while a disconnect watch races
each pull: when the client goes first, the generator is closed, and its
``finally`` (the vllm unit's ``loop.cancel``) frees the engine's slot.

Every request outside :attr:`App.trace_exclude` owns an ``obs.trace``
trace (continuing a valid inbound W3C ``traceparent``), active on the
handler's context; the response carries its ``traceparent``, and when the
request ends (a stream at its drain) the closed trace goes to
:attr:`App.trace_sink` (the flight recorder). The lifespan protocol is
left out: ``serve.httpd`` runs startup itself.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import inspect
import json
import logging
import re
import traceback
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl

from ..obs import trace as obs_trace

log = logging.getLogger(__name__)

#: threads of the stream executor: one per concurrently live stream,
#: which covers every engine's ``max_num_seqs`` with slack (idle threads
#: cost only stack pages)
STREAM_THREADS = 64


class HTTPError(Exception):
    """Raise inside a handler to return a non-200 JSON error; ``headers``
    are extra response headers (``Retry-After`` and the like)."""

    def __init__(self, status: int, detail: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.headers = dict(headers or {})


class Request:
    """One HTTP request as seen by a handler."""

    def __init__(self, scope: Dict, body: bytes):
        self.method: str = scope["method"].upper()
        self.path: str = scope["path"]
        self.headers: Dict[str, str] = {
            k.decode("latin-1").lower(): v.decode("latin-1")
            for k, v in scope.get("headers", [])
        }
        self.query: Dict[str, str] = dict(
            parse_qsl(scope.get("query_string", b"").decode("latin-1")))
        self.path_params: Dict[str, Any] = {}
        self.body: bytes = body
        self.route_matched = False  # set by dispatch when a handler runs

    def json(self) -> Any:
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except json.JSONDecodeError as e:
            raise HTTPError(400, f"invalid JSON body: {e}") from e


class Response:
    """A response: JSON for anything but ``str`` or ``bytes`` content,
    which goes out as it is with ``media_type``."""

    def __init__(self, content: Any = None, status: int = 200,
                 media_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        if isinstance(content, str):
            self.body = content.encode()
            self.headers.setdefault(
                "content-type",
                media_type if media_type != "application/json"
                else "text/plain; charset=utf-8")
        elif isinstance(content, bytes):
            self.body = content
            self.headers.setdefault("content-type", media_type)
        else:
            self.body = json.dumps(content).encode()
            self.headers.setdefault("content-type", "application/json")
        self.headers.setdefault("content-length", str(len(self.body)))


class StreamingResponse(Response):
    """A body produced as it goes (SSE token streams): ``iterator`` is a
    SYNC generator of ``str``/``bytes`` chunks, pulled on the app's stream
    executor so a blocking token queue does not stall the event loop. No
    content-length: the server sends it chunked."""

    def __init__(self, iterator, status: int = 200,
                 media_type: str = "text/event-stream",
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self.headers.setdefault("content-type", media_type)
        self.headers.setdefault("cache-control", "no-store")
        self.body = b""
        self.iterator = iterator


_SEGMENT = re.compile(r"\{(\w+)(?::(int))?\}")
_CASTS = {"int": int, None: str}


def _compile_pattern(pattern: str) -> Tuple[re.Pattern, Dict[str, Callable]]:
    casts: Dict[str, Callable] = {}
    out = []
    last = 0
    for m in _SEGMENT.finditer(pattern):
        out.append(re.escape(pattern[last:m.start()]))
        name, kind = m.group(1), m.group(2)
        casts[name] = _CASTS[kind]
        out.append(f"(?P<{name}>[^/]+)")
        last = m.end()
    out.append(re.escape(pattern[last:]))
    return re.compile("^" + "".join(out) + "$"), casts


class Route:
    def __init__(self, method: str, pattern: str, handler: Callable):
        self.method = method.upper()
        self.pattern = pattern
        self.regex, self.casts = _compile_pattern(pattern)
        self.handler = handler

    def match_path(self, path: str) -> Optional[Dict[str, Any]]:
        """The path parameters when ``path`` and their casts match, else
        None (whatever the method)."""
        m = self.regex.match(path)
        if not m:
            return None
        params: Dict[str, Any] = {}
        for k, v in m.groupdict().items():
            try:
                params[k] = self.casts[k](v)
            except ValueError:
                return None
        return params


class App:
    """ASGI-3 application with decorator routing and startup hooks."""

    def __init__(self, title: str = "shai-cuda"):
        self.title = title
        self.routes: List[Route] = []
        self.on_startup: List[Callable[[], Any]] = []
        self.on_shutdown: List[Callable[[], Any]] = []
        self.state: Dict[str, Any] = {}
        self._started = False
        # the executor StreamingResponse chunks are pulled on, made at the
        # first stream: each live stream parks one thread in its pull
        # (minutes for a queued request), so sharing the model lane or the
        # loop's default executor would starve them
        self._stream_pool: Optional[concurrent.futures.Executor] = None
        # completed request traces go here (serve.app points it at the
        # flight recorder); None = drop them after the response
        self.trace_sink: Optional[Callable[[Dict[str, Any]], None]] = None
        # probe and scrape surfaces stay untraced: a kubelet polling
        # /readiness would evict every real request from the flight ring;
        # entries holding "{" are route patterns
        self.trace_exclude = {"/health", "/readiness", "/metrics", "/stats",
                              "/debug/flight"}
        self._exclude_patterns: Dict[str, re.Pattern] = {}

    def route(self, pattern: str, methods: Tuple[str, ...] = ("GET",)):
        def deco(fn):
            for m in methods:
                self.routes.append(Route(m, pattern, fn))
            return fn

        return deco

    def get(self, pattern: str):
        return self.route(pattern, ("GET",))

    def post(self, pattern: str):
        return self.route(pattern, ("POST",))

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
        if self._stream_pool is not None:
            self._stream_pool.shutdown(wait=False, cancel_futures=True)

    def _trace_excluded(self, path: str) -> bool:
        if path in self.trace_exclude:
            return True
        for entry in self.trace_exclude:
            if "{" not in entry:
                continue
            rx = self._exclude_patterns.get(entry)
            if rx is None:
                rx = self._exclude_patterns[entry] = _compile_pattern(
                    entry)[0]
            if rx.match(path):
                return True
        return False

    def _streams(self) -> concurrent.futures.Executor:
        if self._stream_pool is None:
            self._stream_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=STREAM_THREADS, thread_name_prefix="sse-stream")
        return self._stream_pool

    async def _dispatch(self, request: Request) -> Response:
        allowed = False
        for route in self.routes:
            params = route.match_path(request.path)
            if params is None:
                continue
            if request.method != route.method:
                allowed = True
                continue
            request.path_params = params
            request.route_matched = True
            result = route.handler(request, **params)
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
        # W3C trace-context ingest: a valid inbound traceparent continues
        # the caller's trace id, else a fresh trace roots here (None with
        # tracing off). Excluded surfaces trace only a correlated call
        tp_header = request.headers.get("traceparent")
        tr = None
        if (not self._trace_excluded(request.path)
                or obs_trace.parse_traceparent(tp_header) is not None):
            tr = obs_trace.begin_request_trace(
                f"{request.method} {request.path}", tp_header,
                method=request.method, path=request.path)

        def _finish_trace(status: int) -> None:
            if tr is None or tr.root.closed:
                return
            tr.root.attrs["status"] = status
            tr.close()
            # only requests a handler served are sunk: unrouted traffic
            # must not turn over the flight ring
            if request.route_matched and self.trace_sink is not None:
                try:
                    self.trace_sink(tr.to_dict())
                except Exception:  # recorder trouble must not fail requests
                    log.exception("trace sink failed")

        with obs_trace.use_trace(tr):
            try:
                response = await self._dispatch(request)
            except HTTPError as e:
                response = Response({"detail": e.detail}, status=e.status,
                                    headers=e.headers)
            except Exception:
                log.error("handler error on %s %s\n%s", request.method,
                          request.path, traceback.format_exc())
                response = Response({"detail": "internal server error"},
                                    status=500)
        if tr is not None:
            # traceparent emit: the client and downstream hops join here
            response.headers.setdefault("traceparent", tr.traceparent)
        # the root span covers the stream's drain, and a request aborted
        # mid-stream still closes and sinks its trace
        try:
            await send({
                "type": "http.response.start",
                "status": response.status,
                "headers": [(k.encode("latin-1"), v.encode("latin-1"))
                            for k, v in response.headers.items()],
            })
            if isinstance(response, StreamingResponse):
                await self._drain_stream(response, receive, send)
                return
            await send({"type": "http.response.body",
                        "body": response.body})
        finally:
            _finish_trace(response.status)

    async def _drain_stream(self, response: StreamingResponse,
                            receive: Callable[[], Awaitable],
                            send: Callable) -> None:
        """Pump a StreamingResponse to the client while watching for
        ``http.disconnect``. Each chunk pull races the disconnect message;
        when the client goes first (or a socket write fails), the
        generator is CLOSED, on a stream thread once its pull returns, so
        its ``finally`` (the engine cancel) runs off the event loop."""
        loop = asyncio.get_running_loop()
        pool = self._streams()
        it = iter(response.iterator)
        end = object()

        def _next():
            try:
                return next(it)
            except StopIteration:
                return end

        def _close():
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    log.exception("stream iterator close failed")

        async def _until_disconnect():
            # after the request body, the next message is http.disconnect
            # once the client goes away; a transport error counts too
            try:
                while True:
                    message = await receive()
                    if message["type"] == "http.disconnect":
                        return
            except Exception:
                return

        gone = loop.create_task(_until_disconnect())
        pull = None
        aborted = False
        try:
            while True:
                pull = loop.run_in_executor(pool, _next)
                done, _ = await asyncio.wait(
                    {pull, gone}, return_when=asyncio.FIRST_COMPLETED)
                if gone in done and pull not in done:
                    aborted = True  # the client went away mid-stream
                    break
                chunk = pull.result()
                if chunk is end:
                    break
                if isinstance(chunk, str):
                    chunk = chunk.encode()
                if not chunk:
                    continue
                try:
                    await send({"type": "http.response.body",
                                "body": chunk, "more_body": True})
                except Exception:
                    aborted = True  # the socket died mid-write
                    break
            if not aborted:
                await send({"type": "http.response.body", "body": b""})
        finally:
            gone.cancel()
            try:
                await gone
            except asyncio.CancelledError:
                pass
            if aborted:
                # a generator cannot be closed while it runs: wait for the
                # pull in flight (the generators poll bounded queues, so
                # this is short), then close on a stream thread
                if pull is not None and not pull.done():
                    try:
                        await asyncio.wait_for(asyncio.shield(pull), 5.0)
                    except Exception:
                        log.warning("abandoned stream still pulling; "
                                    "closing it when the pull returns")
                        pull.add_done_callback(lambda f: _close())
                        pull = None
                if pull is not None:
                    await loop.run_in_executor(pool, _close)
