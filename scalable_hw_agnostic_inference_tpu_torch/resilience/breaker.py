"""Per-peer circuit breaker: stop hammering a dead peer.

Copy of ``scalable_hw_agnostic_inference_tpu/resilience/breaker.py``
(``CircuitBreaker``) for the kvnet puller (``kvnet/client.py``), which
keeps one breaker per peer pod. Consecutive connect-phase failures open
the circuit; while open, calls fail fast instead of eating a connect
timeout each. After a jittered exponential backoff one probe is allowed
through (half-open); success closes the circuit, failure re-opens it with
a longer backoff. The rng and clock are injectable so tests are
deterministic.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Classic three-state breaker; thread-safe (serving-lane threads
    pull from peers concurrently)."""

    def __init__(self, failure_threshold: int = 3,
                 base_backoff_s: float = 0.5, max_backoff_s: float = 30.0,
                 jitter_frac: float = 0.25,
                 rng: Optional[random.Random] = None,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        self.jitter_frac = jitter_frac
        self._rng = rng or random.Random()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_count = 0        # consecutive opens: escalates backoff
        self._open_until = 0.0
        self._probing = False       # one half-open probe at a time

    # -- state -------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        if self._state == OPEN and self._clock() >= self._open_until:
            return HALF_OPEN
        return self._state

    @property
    def retry_after_s(self) -> float:
        """Seconds until the next probe is allowed (0 when closed)."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._open_until - self._clock())

    def backoff_s(self, n_open: int) -> float:
        """Deterministic part of the n-th consecutive open's backoff."""
        return min(self.max_backoff_s,
                   self.base_backoff_s * (2 ** max(0, n_open - 1)))

    # -- transitions -------------------------------------------------------

    def allow(self) -> bool:
        """May a call proceed right now? While half-open, exactly one
        caller gets True (the probe) until it reports back."""
        with self._lock:
            st = self._effective_state()
            if st == CLOSED:
                return True
            if st == HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def release_probe(self) -> None:
        """Release the half-open probe slot WITHOUT recording an outcome —
        for a probe that never reports back (e.g. the awaiting task was
        cancelled mid-call). Idempotent; without this the breaker would
        deadlock with ``allow()`` False forever, failing the backend long
        after it recovered."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            self._state = CLOSED
            self._consecutive_failures = 0
            self._open_count = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._probing = False
            self._consecutive_failures += 1
            was_half_open = self._effective_state() == HALF_OPEN
            if (self._consecutive_failures >= self.failure_threshold
                    or was_half_open):
                self._open_count += 1
                base = self.backoff_s(self._open_count)
                jitter = 1.0 + self.jitter_frac * self._rng.random()
                self._open_until = self._clock() + base * jitter
                self._state = OPEN
