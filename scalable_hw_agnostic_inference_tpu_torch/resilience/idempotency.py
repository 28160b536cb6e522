"""Per-pod idempotency cache: replayed/hedged duplicates return the
original result instead of re-executing.

Copy of ``scalable_hw_agnostic_inference_tpu/resilience/idempotency.py``;
the fleet's hedge and retry layer that mints the keys comes with the
fleet control plane.

The fleet's retry layer (``resilience.hedge`` + cova's hedged dispatch)
deliberately sends the same request twice — a hedge after the adaptive
p95 delay, a budgeted retry after a retryable failure, a migration
resume replayed by a nervous client. Each of those duplicates carries
the SAME ``X-SHAI-Idempotency-Key`` (cova mints one when the client
didn't), and this cache is what turns "executed twice" into "executed
once, answered twice":

- a duplicate arriving AFTER the original completed replays the cached
  result — no admission, no engine work, and critically **no second
  tenant-ledger charge** (``serve.app`` returns before ``_InferScope``);
- a duplicate arriving WHILE the original is in flight *joins* it: the
  joiner parks on the entry's event and wakes with the original's
  result;
- a key is only ever associated with one execution at a time — failures
  are **not** cached (``fail`` clears the entry), because a retry after
  a real failure is exactly the case that SHOULD re-execute.

Keyed replay is opt-in per request (no header -> the cache is never
consulted; the contract that non-idempotent replay stays forbidden
without a key is preserved by construction). The cache is bounded
(``SHAI_IDEMP_CACHE`` entries, ``SHAI_IDEMP_TTL_S`` freshness) and
pod-local: a hedge that lands on a *different* pod executes there — the
dedup story for cross-pod duplicates is first-winner-cancels at cova
plus this cache absorbing same-pod replays and duplicate migration
resumes.

Exported counters (``/stats`` -> ``"idempotency"`` and the Prometheus
families below):
``shai_idemp_replayed_total`` (completed-entry replays),
``shai_idemp_joined_total`` (in-flight joins),
``shai_idemp_misses_total`` (new keys — executions),
``shai_idemp_evicted_total`` (bound/TTL evictions),
``shai_idemp_lookup_errors_total`` (injected/real lookup failures that
degraded to a miss), and the ``shai_idemp_entries`` gauge.

Chaos site :data:`resilience.faults.IDEMP_LOOKUP`: an injected error
makes :meth:`IdempotencyCache.begin` report a MISS — at-most-once
degrades to at-least-once, never to a dropped request.

Threading: lane threads (every keyed request) and scrape threads all
touch the table — every mutation moves under ``_lock`` (nothing blocking
runs under it; joiners wait on their entry's event strictly OUTSIDE the
lock).
"""

from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from . import faults

#: header key (lowercased — serve.asgi lowercases all request headers)
IDEMP_HEADER = "x-shai-idempotency-key"

#: key grammar: printable, shell/log-safe, bounded — a client key that
#: fails this is a 400, never a silent pass-through (\Z, not $: $ would
#: let a trailing newline through)
_KEY_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,128}\Z")


def valid_key(key: str) -> bool:
    return bool(_KEY_RE.match(key or ""))


class _Entry:
    """One key's lifecycle: inflight (event unset) -> done | cleared."""

    __slots__ = ("state", "result", "event", "done_at")

    def __init__(self):
        self.state = "inflight"
        self.result: Optional[Dict[str, Any]] = None
        self.event = threading.Event()
        self.done_at = 0.0


class IdempotencyCache:
    """Bounded, TTL'd key -> completed-result table with in-flight join."""

    def __init__(self, max_entries: int = 1024, ttl_s: float = 600.0,
                 clock=time.monotonic):
        self.max_entries = max(1, int(max_entries))
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._counts: Dict[str, int] = {
            "replayed": 0, "joined": 0, "misses": 0, "evicted": 0,
            "lookup_errors": 0,
        }

    # -- lifecycle ---------------------------------------------------------

    def begin(self, key: str) -> Tuple[str, Optional[_Entry]]:
        """Claim or join ``key``. Returns one of:

        - ``("new", entry)`` — this caller owns the execution and must
          end it with :meth:`complete` or :meth:`fail`;
        - ``("done", entry)`` — a fresh completed result is cached
          (``entry.result``); replay it;
        - ``("inflight", entry)`` — the original is still executing;
          park on ``entry.event`` (OUTSIDE any lock) and re-read
          ``entry.state``/``entry.result`` after it sets.
        """
        # delay-kind faults at this site are applied by the (async) caller
        # via asleep_at — a blocking sleep here would stall the event loop
        inj = faults.get()
        if inj.should_fail(faults.IDEMP_LOOKUP):
            # degraded lookup: report a miss WITHOUT touching the table —
            # the request executes (at-least-once), and completion lands
            # through complete()'s upsert as usual
            with self._lock:
                self._counts["lookup_errors"] += 1
            return "new", _Entry()
        now = self._clock()
        with self._lock:
            self._purge_locked(now)
            e = self._entries.get(key)
            if e is not None:
                if e.state == "done":
                    self._entries.move_to_end(key)
                    self._counts["replayed"] += 1
                    return "done", e
                self._counts["joined"] += 1
                return "inflight", e
            e = _Entry()
            self._entries[key] = e
            self._counts["misses"] += 1
            self._evict_locked()
            return "new", e

    def complete(self, key: str, result: Dict[str, Any]) -> None:
        """Publish ``key``'s result and wake joiners. Upserts — a
        degraded-lookup execution still lands its completion."""
        now = self._clock()
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = _Entry()
                self._entries[key] = e
                self._evict_locked()
            e.state = "done"
            e.result = result
            e.done_at = now
            self._entries.move_to_end(key)
        e.event.set()

    def fail(self, key: str) -> None:
        """The execution failed: clear the claim so a later retry
        legitimately re-executes, and wake joiners (they re-read the
        entry, see ``state != "done"``, and run their own attempt)."""
        with self._lock:
            e = self._entries.pop(key, None)
        if e is not None:
            e.state = "failed"
            e.event.set()

    # -- bounds ------------------------------------------------------------

    def _purge_locked(self, now: float) -> None:
        """TTL sweep over completed entries (in-flight entries never
        expire here — their owner ends them)."""
        if self.ttl_s <= 0:
            return
        # the caller holds the lock (begin)
        stale = [k for k, e in self._entries.items()
                 if e.state == "done" and now - e.done_at > self.ttl_s]
        for k in stale:
            del self._entries[k]
        self._counts["evicted"] += len(stale)

    def _evict_locked(self) -> None:
        """Bound the table: oldest DONE entries go first; if the table is
        somehow all in-flight, the oldest claim goes anyway — bounded
        memory beats perfect dedup (the evicted duplicate re-executes)."""
        # the caller holds the lock (begin, complete)
        while len(self._entries) > self.max_entries:
            victim = next((k for k, e in self._entries.items()
                           if e.state == "done"),
                          next(iter(self._entries)))
            e = self._entries.pop(victim)
            self._counts["evicted"] += 1
            if e.state != "done":
                e.state = "failed"
                e.event.set()

    # -- observability -----------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out = {f"{k}_total": float(v) for k, v in self._counts.items()}
            out["entries"] = float(len(self._entries))
            return out
