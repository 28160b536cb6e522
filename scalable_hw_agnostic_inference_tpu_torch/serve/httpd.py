"""Stdlib asyncio HTTP/1.1 server speaking ASGI — the uvicorn replacement.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/serve/httpd.py``:
HTTP/1.1 with keep-alive and content-length bodies, each request turned
into an ASGI-3 ``http`` scope. Chunked streaming and the mid-stream
disconnect watch come with the streaming routes in a later slice. Handlers
run model work on a thread executor (``serve.app``), so the event loop
keeps answering probes while the engine works.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Optional, Tuple

log = logging.getLogger(__name__)

MAX_HEADER_BYTES = 65536
MAX_BODY_BYTES = 512 * 1024 * 1024


class _Connection:
    def __init__(self, app, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.app = app
        self.reader = reader
        self.writer = writer
        self._pushback = b""  # bytes read past the current request

    async def run(self):
        try:
            while await self._one_request():
                pass
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.LimitOverrunError):
            pass
        except Exception:  # pragma: no cover
            log.exception("connection error")
        finally:
            try:
                self.writer.close()
                await self.writer.wait_closed()
            except Exception:
                pass

    async def _read_head(self) -> bytes:
        buf = bytearray(self._pushback)
        self._pushback = b""
        while True:
            i = buf.find(b"\r\n\r\n")
            if i >= 0:
                self._pushback = bytes(buf[i + 4:])
                return bytes(buf[:i])
            if len(buf) > MAX_HEADER_BYTES:
                raise asyncio.LimitOverrunError("headers too large", len(buf))
            data = await self.reader.read(65536)
            if not data:
                raise asyncio.IncompleteReadError(bytes(buf), None)
            buf += data

    async def _read_body(self, length: int) -> bytes:
        buf = bytearray(self._pushback[:length])
        self._pushback = self._pushback[length:]
        while len(buf) < length:
            data = await self.reader.read(length - len(buf))
            if not data:
                raise asyncio.IncompleteReadError(bytes(buf), length)
            buf += data
        return bytes(buf)

    async def _one_request(self) -> bool:
        try:
            raw = await self._read_head()
        except asyncio.LimitOverrunError:
            await self._simple_response(431, b"headers too large")
            return False
        head = raw.decode("latin-1").split("\r\n")
        try:
            method, target, version = head[0].split(" ", 2)
        except ValueError:
            await self._simple_response(400, b"bad request line")
            return False
        headers = []
        for line in head[1:]:
            if not line:
                continue
            if ":" not in line:
                await self._simple_response(400, b"bad header")
                return False
            k, v = line.split(":", 1)
            headers.append((k.strip().lower().encode("latin-1"),
                            v.strip().encode("latin-1")))
        hmap = {k: v for k, v in headers}
        try:
            length = int(hmap.get(b"content-length", b"0"))
        except ValueError:
            length = -1
        if length < 0:
            await self._simple_response(400, b"bad content-length")
            return False
        if length > MAX_BODY_BYTES:
            await self._simple_response(413, b"body too large")
            return False
        body = await self._read_body(length) if length else b""

        path, _, query = target.partition("?")
        scope = {
            "type": "http",
            "asgi": {"version": "3.0"},
            "http_version": version.split("/")[-1],
            "method": method,
            "path": path,
            "raw_path": target.encode("latin-1"),
            "query_string": query.encode("latin-1"),
            "headers": headers,
            "server": self.writer.get_extra_info("sockname"),
            "client": self.writer.get_extra_info("peername"),
        }
        http10 = version.strip().upper() == "HTTP/1.0"
        default_conn = b"close" if http10 else b"keep-alive"
        keep_alive = (hmap.get(b"connection", default_conn).lower()
                      == b"keep-alive")
        sent_body = False
        started = False
        messages = [{"type": "http.request", "body": body,
                     "more_body": False}]

        async def receive():
            if messages:
                return messages.pop(0)
            return {"type": "http.disconnect"}

        async def send(message):
            nonlocal sent_body, started
            if message["type"] == "http.response.start":
                started = True
                status = message["status"]
                lines = [f"HTTP/1.1 {status} {_reason(status)}".encode(
                    "latin-1")]
                for k, v in message.get("headers", []):
                    lines.append(k + b": " + v)
                lines.append(b"connection: keep-alive" if keep_alive
                             else b"connection: close")
                self.writer.write(b"\r\n".join(lines) + b"\r\n\r\n")
            elif message["type"] == "http.response.body":
                self.writer.write(message.get("body", b""))
                if not message.get("more_body"):
                    sent_body = True
                await self.writer.drain()

        try:
            await self.app(scope, receive, send)
        except Exception:  # pragma: no cover
            log.exception("ASGI app crashed")
            if not started:
                await self._simple_response(500, b"internal server error")
            return False
        return keep_alive and sent_body

    async def _simple_response(self, status: int, msg: bytes):
        self.writer.write(
            f"HTTP/1.1 {status} {_reason(status)}\r\n"
            f"content-length: {len(msg)}\r\nconnection: close\r\n\r\n".encode(
                "latin-1") + msg)
        await self.writer.drain()


_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}


def _reason(status: int) -> str:
    return _REASONS.get(status, "Unknown")


class Server:
    """Serve an ASGI app on (host, port); supports in-thread background mode."""

    def __init__(self, app, host: str = "0.0.0.0", port: int = 8000):
        self.app = app
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()

    async def _handle(self, reader, writer):
        await _Connection(self.app, reader, writer).run()

    async def serve(self):
        # bind first so probes connect during model load; startup hooks
        # only kick the load off (serve.app runs it on the model lane)
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, reuse_address=True,
            limit=MAX_HEADER_BYTES)
        await self.app._run_startup()
        self.port = self._server.sockets[0].getsockname()[1]
        self._ready.set()
        log.info("serving %s on %s:%d", getattr(self.app, "title", "app"),
                 self.host, self.port)
        async with self._server:
            await self._server.serve_forever()

    def run(self):
        """Blocking serve (pod entrypoint)."""
        try:
            asyncio.run(self.serve())
        except (KeyboardInterrupt, asyncio.CancelledError):  # pragma: no cover
            pass

    def start_background(self) -> Tuple[str, int]:
        def _target():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self.serve())
            except asyncio.CancelledError:
                pass
            finally:
                self._loop.close()

        self._thread = threading.Thread(target=_target, daemon=True,
                                        name="shai-httpd")
        self._thread.start()
        if not self._ready.wait(timeout=10):
            raise RuntimeError("server failed to start within 10s")
        host = self.host if self.host != "0.0.0.0" else "127.0.0.1"
        return host, self.port

    def request_shutdown(self):
        """Thread-safe server stop: app shutdown hooks, then task teardown."""
        loop, server, app = self._loop, self._server, self.app
        if loop is None:
            return

        def _shutdown():
            if server is not None:
                server.close()

            async def _finish():
                try:
                    await app._run_shutdown()
                except Exception:
                    log.exception("app shutdown hooks failed")
                current = asyncio.current_task()
                for task in asyncio.all_tasks(loop):
                    if task is not current:
                        task.cancel()

            loop.create_task(_finish())

        try:
            loop.call_soon_threadsafe(_shutdown)
        except RuntimeError:  # loop already closed
            pass

    def stop(self):
        self.request_shutdown()
        if self._thread:
            self._thread.join(timeout=5)
