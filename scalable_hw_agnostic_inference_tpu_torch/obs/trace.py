"""Request-scoped tracing: dependency-free spans with W3C trace context.

The reference stack's only per-request record is a CloudWatch latency
metric (one number per served request — SURVEY.md §5); nothing explains
*where* a slow request spent its time. Here every HTTP request owns a
:class:`Trace` — a tree of timed spans (http → tokenize → queue → prefill →
decode → detokenize) — propagated two ways:

- **in-process** via a ``contextvars`` pair (current trace + current span),
  so nested ``span()`` calls build a tree without plumbing arguments. The
  serving layer copies the context onto its executor threads
  (``serve.app._run_model``), so spans opened inside a model call land in
  the right request's trace.
- **cross-process** via the W3C ``traceparent`` header: ingested in
  ``serve.asgi`` (an upstream LB/client id continues here) and emitted on
  every response.

Spans also emit ``torch.profiler.record_function`` ranges while a
``torch.profiler`` session is active, so request phases and the engine's
``engine.prefill``/``engine.decode`` dispatches appear in the device trace
next to the kernels and graph replays they cover. A session counts as
active when the serving layer's ``/profile`` started one
(:func:`set_profiling`: torch's own flag is thread-local, and the engine
loop runs on its own thread) or when one runs on the calling thread. With
none active nothing is entered (the reference's "when JAX is loaded"
guard), and nothing is ever entered while the current CUDA stream is
capturing a graph.

Copy of ``scalable_hw_agnostic_inference_tpu/obs/trace.py``, the JAX
profiler annotation replaced by the torch one.

Overhead contract: with tracing disabled (``SHAI_TRACE=0`` or
:func:`configure`), :func:`span` returns a shared no-op context manager and
:func:`begin_request_trace` returns ``None`` — one flag check, zero
allocation on the hot path.
"""

from __future__ import annotations

import contextvars
import dataclasses
import os
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..utils.env import env_bool as _env_flag

_enabled = _env_flag("SHAI_TRACE", True)


def configure(enabled: bool) -> None:
    """Process-wide tracing switch (env default: on unless SHAI_TRACE=0)."""
    global _enabled
    _enabled = bool(enabled)


def enabled() -> bool:
    return _enabled


# profiler sessions the serving layer started (POST /profile): torch's
# own profiler flag is per thread, and the engine loop runs on its own
_profiling = False


def set_profiling(active: bool) -> None:
    """Mark a process-wide ``torch.profiler`` session (one started with
    all threads profiled) as running or stopped."""
    global _profiling
    _profiling = bool(active)


# -- W3C trace context -------------------------------------------------------

_TRACEPARENT = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-.*)?$")


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``traceparent`` header → ``(trace_id, parent_span_id)``; None when
    absent/malformed (a bad header starts a fresh trace, never a 4xx).

    W3C versioning: version ``ff`` is forbidden; version ``00`` must have
    exactly the four defined fields; a FUTURE version (``01``..``fe``) may
    carry extra trailing fields — parse the leading four and continue the
    trace rather than orphaning it on the first spec bump."""
    if not header:
        return None
    m = _TRACEPARENT.match(header.strip().lower())
    if not m:
        return None
    version, trace_id, span_id, tail = (
        m.group(1), m.group(2), m.group(3), m.group(5))
    if version == "ff":
        return None  # spec: version 255 is invalid
    if version == "00" and tail:
        return None  # spec: version 00 defines exactly four fields
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # spec: all-zero ids are invalid
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


# -- spans -------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    name: str
    span_id: str
    parent_id: Optional[str]
    t_wall: float               # wall-clock start (time.time())
    t_mono: float               # monotonic start (duration basis)
    duration_s: float = -1.0    # -1 while open
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def closed(self) -> bool:
        return self.duration_s >= 0.0

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": round(self.t_wall, 6),
            "duration_s": round(self.duration_s, 6),
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class _LiveSpan:
    """Context manager binding one open :class:`Span` to the contextvar
    stack (and a ``torch.profiler.record_function`` range while a profiler
    session is active)."""

    __slots__ = ("trace", "span", "_token", "_ann", "_annotate")

    def __init__(self, trace: "Trace", span: Span, annotation: bool = True):
        self.trace = trace
        self.span = span
        self._token = None
        self._ann = None
        self._annotate = annotation

    def set(self, **attrs) -> "_LiveSpan":
        self.span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_LiveSpan":
        self._token = _current_span.set(self.span)
        ann = _annotation(self.span.name) if self._annotate else None
        if ann is not None:
            try:
                ann.__enter__()
                self._ann = ann
            except Exception:
                self._ann = None
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        if self._token is not None:
            _current_span.reset(self._token)
        if exc_type is not None:
            self.span.attrs.setdefault("error", exc_type.__name__)
        self.trace.close_span(self.span)
        return False


class _NoopSpan:
    """Shared do-nothing span: THE disabled-path object (no allocation)."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP = _NoopSpan()


def _annotation(name: str):
    """A ``torch.profiler.record_function`` range while a profiler session
    is active and the current CUDA stream is not capturing; None otherwise
    (never imports torch itself — tracing must not pull the backend in)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not (_profiling or torch.autograd._profiler_enabled()):
            return None
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            return None
        return torch.profiler.record_function(name)
    except Exception:  # pragma: no cover - profiler API moved
        return None


def annotate(name: str):
    """Bare device-trace annotation (no span bookkeeping): the engine wraps
    its dispatch phases with this so ``/profile`` traces show step structure
    even for work not tied to one request."""
    if not _enabled:
        return NOOP
    return _annotation(name) or NOOP


# -- traces ------------------------------------------------------------------


class Trace:
    """One request's span tree. Thread-safe: the serving thread and the
    engine loop thread both append (the engine's phase spans arrive via
    :meth:`add_span` with explicit timestamps)."""

    def __init__(self, name: str, trace_id: Optional[str] = None,
                 remote_parent: Optional[str] = None, **attrs):
        self.trace_id = trace_id or new_trace_id()
        self.remote_parent = remote_parent
        self._lock = threading.Lock()
        self.spans: List[Span] = []
        self.root = Span(name, new_span_id(), None, time.time(),
                         time.monotonic(), attrs=dict(attrs))
        self.spans.append(self.root)

    # -- span lifecycle ----------------------------------------------------

    def span(self, name: str, annotation: bool = True,
             **attrs) -> _LiveSpan:
        """Open a child of the context-current span (root when none).
        ``annotation=False`` skips the profiler range: required for spans
        held across an ``await`` — profiler ranges are a per-thread LIFO
        stack, and two requests interleaving on the event loop would close
        each other's ranges out of order."""
        parent = _current_span.get()
        pid = parent.span_id if parent is not None else self.root.span_id
        s = Span(name, new_span_id(), pid, time.time(), time.monotonic(),
                 attrs=dict(attrs))
        with self._lock:
            self.spans.append(s)
        return _LiveSpan(self, s, annotation=annotation)

    def close_span(self, s: Span) -> None:
        if not s.closed:
            s.duration_s = max(0.0, time.monotonic() - s.t_mono)

    def add_span(self, name: str, start_mono: float, end_mono: float,
                 parent: Optional[Span] = None, **attrs) -> Span:
        """Append an already-timed span from monotonic stamps (engine phase
        records); converted to wall-clock against this process's clocks."""
        now_mono, now_wall = time.monotonic(), time.time()
        start_mono = min(start_mono, end_mono)
        s = Span(name, new_span_id(),
                 (parent or self.root).span_id,
                 now_wall - (now_mono - start_mono), start_mono,
                 duration_s=max(0.0, end_mono - start_mono),
                 attrs=dict(attrs))
        with self._lock:
            self.spans.append(s)
        return s

    def add_phase_spans(self, timing: Dict[str, float],
                        parent: Optional[Span] = None) -> None:
        """Engine ``Finished.timing`` → queue/prefill/decode child spans,
        plus the sub-phase events the span tree cannot see from outside:
        the fabric-probe rung and KV-tier restore become child spans of
        whichever phase window contains them (the probe can run before
        ``t_admit`` is stamped, so containment decides — not assumption),
        recompute-fallback tokens annotate prefill, request-attributed
        pipeline flushes annotate decode, and a migration cut leaves a
        zero-duration marker at its instant."""
        t_sub = timing.get("t_submit") or 0.0
        t_adm = timing.get("t_admit") or t_sub
        t_first = timing.get("t_first") or t_adm
        t_done = timing.get("t_done") or t_first
        if not t_sub:
            return
        queue = self.add_span("queue", t_sub, t_adm, parent=parent)
        prefill = self.add_span("prefill", t_adm, t_first, parent=parent)
        decode = self.add_span("decode", t_first, t_done, parent=parent)
        if timing.get("recompute_tokens"):
            prefill.attrs["recompute_tokens"] = int(
                timing["recompute_tokens"])
        if timing.get("pipeline_flushes"):
            decode.attrs["pipeline_flushes"] = int(
                timing["pipeline_flushes"])

        def _phase_parent(t: float) -> Span:
            return queue if t < t_adm else prefill

        t_fab = timing.get("t_fabric") or 0.0
        if t_fab:
            self.add_span(
                "fabric_probe", t_fab,
                t_fab + max(0.0, timing.get("fabric_probe_s") or 0.0),
                parent=_phase_parent(t_fab),
                blocks=int(timing.get("fabric_blocks") or 0))
        t_res = timing.get("t_kv_restore") or 0.0
        if t_res:
            self.add_span(
                "kv_restore", t_res,
                t_res + max(0.0, timing.get("kv_restore_s") or 0.0),
                parent=_phase_parent(t_res),
                blocks=int(timing.get("kv_restore_blocks") or 0))
        t_cut = timing.get("t_migrate_cut") or 0.0
        if t_cut:
            self.add_span("migrate_cut", t_cut, t_cut, parent=parent)

    def close(self) -> None:
        """Close the root (and defensively any span a crashed handler left
        open, flagged ``unclosed`` so the validator still reports it)."""
        with self._lock:
            for s in self.spans:
                if not s.closed and s is not self.root:
                    s.attrs["unclosed"] = True
                    self.close_span(s)
            self.close_span(self.root)

    # -- export ------------------------------------------------------------

    @property
    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.root.span_id)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        d = {"trace_id": self.trace_id, "name": self.root.name,
             "spans": spans}
        if self.remote_parent:
            d["remote_parent"] = self.remote_parent
        return d


# -- context propagation -----------------------------------------------------

_current_trace: contextvars.ContextVar[Optional[Trace]] = \
    contextvars.ContextVar("shai_trace", default=None)
_current_span: contextvars.ContextVar[Optional[Span]] = \
    contextvars.ContextVar("shai_span", default=None)


def current_trace() -> Optional[Trace]:
    return _current_trace.get()


def current_span() -> Optional[Span]:
    """The context-current live span (None outside any ``span()`` body).
    The serving lane passes this as the graft parent for engine phase
    spans so queue/prefill/decode land UNDER ``model_infer`` instead of
    overlapping it as root siblings — self-time autopsies depend on it."""
    return _current_span.get()


def current_traceparent() -> Optional[str]:
    tr = _current_trace.get()
    if tr is None:
        return None
    s = _current_span.get()
    return format_traceparent(tr.trace_id,
                              (s or tr.root).span_id)


class use_trace:
    """Activate ``trace`` for the current context (``with use_trace(tr):``).
    ``trace=None`` is a no-op activation, so callers need no branching."""

    __slots__ = ("trace", "_tok_t", "_tok_s")

    def __init__(self, trace: Optional[Trace]):
        self.trace = trace
        self._tok_t = self._tok_s = None

    def __enter__(self) -> Optional[Trace]:
        if self.trace is not None:
            self._tok_t = _current_trace.set(self.trace)
            self._tok_s = _current_span.set(self.trace.root)
        return self.trace

    def __exit__(self, *exc) -> bool:
        if self._tok_s is not None:
            _current_span.reset(self._tok_s)
        if self._tok_t is not None:
            _current_trace.reset(self._tok_t)
        return False


def span(name: str, annotation: bool = True, **attrs):
    """Open a child span on the context-current trace; no-op (shared
    constant, zero allocation) when tracing is off or no trace is active.
    Pass ``annotation=False`` for spans that wrap an ``await`` (see
    :meth:`Trace.span`)."""
    if not _enabled:
        return NOOP
    tr = _current_trace.get()
    if tr is None:
        return NOOP
    return tr.span(name, annotation=annotation, **attrs)


def begin_request_trace(name: str,
                        traceparent_header: Optional[str] = None,
                        **attrs) -> Optional[Trace]:
    """Trace for one inbound request, continuing the caller's W3C context
    when a valid ``traceparent`` header arrived. None when tracing is off."""
    if not _enabled:
        return None
    parsed = parse_traceparent(traceparent_header)
    if parsed:
        return Trace(name, trace_id=parsed[0], remote_parent=parsed[1],
                     **attrs)
    return Trace(name, **attrs)


# -- validation (used by tests and the flight recorder's self-checks) --------


def well_formed_problems(trace_dict: Dict[str, Any]) -> List[str]:
    """Structural problems of a dumped trace: [] means well-formed —
    exactly one root, every parent exists, no unclosed spans."""
    problems: List[str] = []
    spans = trace_dict.get("spans", [])
    if not spans:
        return ["trace has no spans"]
    by_id = {}
    for s in spans:
        if s["span_id"] in by_id:
            problems.append(f"duplicate span_id {s['span_id']}")
        by_id[s["span_id"]] = s
    roots = [s for s in spans if s.get("parent_id") is None]
    if len(roots) != 1:
        problems.append(f"expected exactly one root, got {len(roots)}")
    for s in spans:
        pid = s.get("parent_id")
        if pid is not None and pid not in by_id:
            problems.append(f"orphan span {s['name']} (parent {pid} missing)")
        if s.get("duration_s", -1.0) < 0.0:
            problems.append(f"unclosed span {s['name']}")
        if s.get("attrs", {}).get("unclosed"):
            problems.append(f"span {s['name']} force-closed at trace end")
    return problems
