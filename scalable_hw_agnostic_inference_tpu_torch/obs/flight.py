"""Flight recorder: bounded in-memory postmortem buffer per serving pod.

Copy of ``scalable_hw_agnostic_inference_tpu/obs/flight.py``.

When a pod degrades in production, the Prometheus history says *that*
latency moved; the flight recorder says *what the last N requests actually
did*: every completed request's span timeline (``obs.trace``) plus the last
M engine-step records (``obs.steploop``) ride in two ring buffers, dumpable
as JSON via ``GET /debug/flight`` (``serve.app``). Memory is strictly
bounded — the rings never grow past their configured sizes — so the
recorder is always-on, like an aircraft FDR, not a debug mode someone has
to remember to enable before the incident.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional


class FlightRecorder:
    """Ring of the last N completed request timelines (+ an optional
    engine-step feed provided at dump time). Thread-safe."""

    def __init__(self, max_requests: Optional[int] = None,
                 max_steps: int = 256):
        if max_requests is None:
            from ..utils.env import env_int

            max_requests = env_int("SHAI_FLIGHT_REQUESTS", 128)
        self.max_requests = max_requests
        self.max_steps = max_steps
        self._lock = threading.Lock()
        self._requests: deque = deque(maxlen=max_requests)
        self._seq = 0
        # trace_id -> records still in the ring (newest last). Maintained
        # on record/evict so /trace/{trace_id} is a dict hit, not a ring
        # walk; strictly bounded by the ring itself.
        self._by_trace: Dict[str, List[Dict[str, Any]]] = {}

    def record_request(self, trace_dict: Dict[str, Any]) -> None:
        """Ring-append one completed request's trace (the asgi layer's
        trace sink). Cheap: one lock + one deque append. The trace id is
        lifted to the record's top level so flight timelines join to
        distributed traces (and the step records' ``finished_ids`` join to
        the trace root's ``engine_req_id``) without digging into spans."""
        rec = {"recorded_at": round(time.time(), 4),
               "trace_id": trace_dict.get("trace_id"),
               "trace": trace_dict}
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            if (self._requests.maxlen is not None and self._requests
                    and len(self._requests) == self._requests.maxlen):
                self._unindex(self._requests[0])
            if self._requests.maxlen != 0:
                self._requests.append(rec)
                self._index(rec)

    def _index(self, rec: Dict[str, Any]) -> None:
        tid = rec.get("trace_id")
        if tid:
            # the caller holds the lock (record_request)
            self._by_trace.setdefault(tid, []).append(rec)

    def _unindex(self, rec: Dict[str, Any]) -> None:
        tid = rec.get("trace_id")
        if not tid:
            return
        # the caller holds the lock (record_request)
        recs = self._by_trace.get(tid)
        if recs is not None:
            try:
                recs.remove(rec)
            except ValueError:
                pass
            if not recs:
                del self._by_trace[tid]

    def traces_for(self, trace_id: str) -> List[Dict[str, Any]]:
        """All still-resident trace dicts recorded under ``trace_id``
        (oldest first) — the ``GET /trace/{trace_id}`` backing lookup."""
        with self._lock:
            recs = self._by_trace.get(trace_id) or []
            return [r["trace"] for r in recs]

    @property
    def n_recorded(self) -> int:
        with self._lock:
            return self._seq

    def dump(self, step_source: Optional[Callable[[int],
                                                  List[Dict]]] = None,
             n_requests: Optional[int] = None) -> Dict[str, Any]:
        """The ``/debug/flight`` payload: newest-last request timelines and
        (when an engine feed exists) the recent step records."""
        with self._lock:
            reqs = list(self._requests)
            total = self._seq
        if n_requests is not None:
            # explicit zero-guard: reqs[-0:] would be the WHOLE list
            reqs = reqs[max(0, len(reqs) - n_requests):] \
                if n_requests > 0 else []
        out: Dict[str, Any] = {
            "recorded_total": total,
            "capacity": {"requests": self.max_requests,
                         "steps": self.max_steps},
            "requests": reqs,
            "engine_steps": [],
        }
        if step_source is not None:
            try:
                out["engine_steps"] = step_source(self.max_steps)
            except Exception as e:  # a dead engine must not break the dump
                out["engine_steps_error"] = f"{type(e).__name__}: {e}"
        return out
