"""Graceful drain and the engine-step watchdog.

Copy of ``scalable_hw_agnostic_inference_tpu/resilience/drain.py``. On
the port the watchdog reads the step telemetry's last RETIRED step: an
async step that only enqueued a replay does not refresh it, so a replay
the card never finishes reads as a stall (``obs.steploop``).

**Drain** (SIGTERM → rolling update / preemption): the pod must finish
what it accepted and refuse what it hasn't. ``DrainController`` is the
shared flag + budget: the serving layer flips ``/readiness`` (and
``/health/ready``) to 503 so the LB stops routing, the admission gate
sheds new work with 503 + ``Retry-After``, in-flight requests run to
completion up to the drain budget, then the engine loop stops and the
process exits. Without this, Kubernetes' default SIGTERM→SIGKILL window
kills mid-decode requests that the client already paid queue time for.

**Watchdog**: a wedged engine dispatch (device hang, deadlocked collective,
runaway compile) leaves the loop thread alive but the engine silent — the
pod keeps answering ``/health`` while every request blackholes. The
watchdog compares the time since the last completed step against N× the
p99 step duration from the obs telemetry ring (floored by ``min_stall_s``)
*while the engine has work*; a trip fails liveness so Kubernetes restarts
the pod instead of serving a black hole. An idle engine never trips — no
work means no steps is the healthy state.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)


class DrainController:
    """One pod's drain state: armed once (idempotent), budgeted, waitable."""

    def __init__(self, budget_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.budget_s = max(0.0, budget_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._started_at: Optional[float] = None

    @property
    def draining(self) -> bool:
        # deliberately LOCK-FREE: this property runs on the main thread
        # (readiness/admission handlers on the event loop), and the
        # SIGTERM handler — which also runs on the main thread, between
        # bytecodes — takes _lock via begin(); a locked read here could
        # self-deadlock the signal handler against its own thread. A
        # GIL-atomic is-None check of a single reference cannot tear.
        return self._started_at is not None

    def begin(self) -> bool:
        """Arm the drain; True only for the first caller (a duplicate
        SIGTERM must not restart the budget clock)."""
        with self._lock:
            if self._started_at is not None:
                return False
            self._started_at = self._clock()
            return True

    @property
    def remaining_s(self) -> float:
        with self._lock:
            if self._started_at is None:
                return self.budget_s
            return max(0.0, self.budget_s - (self._clock() - self._started_at))

    def wait(self, idle_fn: Callable[[], bool],
             poll_s: float = 0.05, min_remaining: float = 0.0) -> bool:
        """Block until ``idle_fn()`` or the budget runs out; True = drained
        clean, False = budget exhausted with work still in flight.

        ``min_remaining``: stop waiting while that much budget is still
        left — the migrate phase's reservation (live migration ships the
        long tail with budget to spare, instead of discovering at the
        deadline that nothing can ship anymore)."""
        while True:
            if idle_fn():
                return True
            if self.remaining_s <= max(0.0, min_remaining):
                return False
            time.sleep(poll_s)


class StepWatchdog:
    """Detect a stuck engine dispatch from the obs step telemetry.

    ``telemetry_provider`` returns the engine's
    ``obs.steploop.StepTelemetry`` (or None before load); ``busy_fn``
    reports whether the engine has work. Threshold: ``max(min_stall_s,
    multiplier * p99 step duration)`` — p99 from the telemetry's recent
    step ring, so a tier whose steps legitimately take seconds (large
    batch, long context) gets a proportionally longer leash than a tier
    stepping at 10 ms.
    """

    def __init__(self, telemetry_provider: Callable[[], Any],
                 busy_fn: Callable[[], bool], multiplier: float = 30.0,
                 min_stall_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.telemetry_provider = telemetry_provider
        self.busy_fn = busy_fn
        self.multiplier = multiplier
        self.min_stall_s = min_stall_s
        self._clock = clock
        # when we first OBSERVED the engine busy after an idle stretch:
        # the loop only steps while it has work, so time-since-last-step
        # includes the idle gap — measuring from the idle->busy transition
        # keeps a pod that idled an hour from reading as stalled the
        # moment its next request arrives
        self._busy_since: Optional[float] = None

    def threshold_s(self, tele) -> float:
        p99 = tele.step_duration_p99()
        return max(self.min_stall_s, self.multiplier * p99)

    def check(self) -> Optional[str]:
        """Non-None = the liveness failure reason (the pod should restart)."""
        try:
            tele = self.telemetry_provider()
        except Exception:
            return None
        if tele is None:
            return None
        try:
            busy = self.busy_fn()
        except Exception:
            return None
        now = self._clock()
        if not busy:
            self._busy_since = None
            return None  # idle: no steps is the healthy state
        if self._busy_since is None:
            self._busy_since = now
        age = min(tele.last_step_age_s(now=now), now - self._busy_since)
        limit = self.threshold_s(tele)
        if age > limit:
            return (f"engine step stalled: {age:.1f}s since last completed "
                    f"step with work pending (limit {limit:.1f}s = "
                    f"max({self.min_stall_s:.1f}s, {self.multiplier:.0f}x "
                    f"p99 step))")
        return None
