"""Perf-model sentinel: is this pod running as fast as its own model says?

Copy of ``scalable_hw_agnostic_inference_tpu/obs/sentinel.py`` with one
change: **no TPU projection.** The reference falls back to the repo's
``PERF_MODEL.json``, whose rates were projected for a TPU and mean
nothing on the card; the port's :func:`perf_model_path` has no default.
A projection comes only from ``SHAI_PERF_PROJECTED_TOK_S`` (a direct
rate) or from the ``projections`` table of a file that ``SHAI_PERF_MODEL``
names (keyed by ``SHAI_PERF_PROJECTION`` or the model-id heuristic); with
neither, :meth:`PerfSentinel.from_env` returns None, as the reference
does when nothing resolves.

The sentinel compares a pod against its projection: the engine feeds it
every decode step's (tokens committed, busy seconds), it keeps a rolling
window of realized throughput, and exports ``shai_perf_conformance`` — live tok/s
over projected tok/s. Conformance persistently below ``min_conformance``
(default 0.8) with enough tokens in the window flips ``degraded`` and logs
ONE structured diagnosis (step-gap mean, flush/preemption counts — the
numbers that say *why*: host-gap regression, pool thrash, drafter
collapse) per healthy→degraded transition.

Live rates are host-clock tokens over the async step's host seconds, as
in the reference: nothing synchronizes the card for them.

Layering: stdlib-only (``json`` file read); injectable clock for tests.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..utils.env import env_str

log = logging.getLogger(__name__)

ENV_PROJECTED = "SHAI_PERF_PROJECTED_TOK_S"   # direct projected rate
ENV_PROJECTION = "SHAI_PERF_PROJECTION"       # PERF_MODEL.json key
ENV_MODEL_PATH = "SHAI_PERF_MODEL"            # override the json path
ENV_MIN_CONFORMANCE = "SHAI_PERF_MIN_CONFORMANCE"
ENV_WINDOW_S = "SHAI_PERF_WINDOW_S"
ENV_MIN_TOKENS = "SHAI_PERF_MIN_TOKENS"


def perf_model_path() -> Optional[str]:
    """The projection file ``SHAI_PERF_MODEL`` names; None without it (no
    default: the repo's ``PERF_MODEL.json`` holds TPU projections)."""
    return env_str(ENV_MODEL_PATH)


def load_projections(path: Optional[str] = None) -> Dict[str, Dict]:
    """The ``projections`` table of the projection file; {} when none is
    named, or it is absent or unreadable (a pod must boot without it)."""
    path = path or perf_model_path()
    if not path:
        return {}
    try:
        with open(path) as f:
            return json.load(f).get("projections", {}) or {}
    except Exception:
        return {}


def default_projection_key(model: str, quantized: bool = False,
                           tp: int = 1) -> str:
    """Geometry heuristic: map a served model id onto the projection the
    perf model tabulates for that tier ("" = no match)."""
    m = (model or "").lower()
    if "mllama" in m or "vision" in m or "11b" in m:
        return "mllama_decode_b1_tpot"
    if "70b" in m:
        return "vllm_decode_70b_tp8_tpot" if tp >= 8 else ""
    if "3b" in m:
        return "llama3b_int8_gen" if quantized else "llama3b_gen"
    if "1b" in m:
        return "llama1b_int8_gen" if quantized else "llama1b_gen"
    return ""


class PerfSentinel:
    """Rolling live-vs-projected throughput conformance for one engine.
    Thread-safe: the engine loop records, scrape threads snapshot."""

    def __init__(self, projected_per_s: float, *, key: str = "",
                 min_conformance: float = 0.8, window_s: float = 60.0,
                 min_tokens: int = 64,
                 clock: Callable[[], float] = time.monotonic):
        if projected_per_s <= 0:
            raise ValueError("projected_per_s must be > 0")
        self.projected_per_s = float(projected_per_s)
        self.key = key
        self.min_conformance = float(min_conformance)
        self.window_s = float(window_s)
        self.min_tokens = int(min_tokens)
        self._clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque()     # (t, tokens, busy_s)
        self._degraded = False
        self.diagnoses = 0

    @classmethod
    def from_env(cls, default_key: str = "") -> Optional["PerfSentinel"]:
        """Engine-construction entry point; None when no projection
        resolves for this tier."""
        from ..utils.env import env_float as _envf

        rate = _envf(ENV_PROJECTED, 0.0)
        key = env_str(ENV_PROJECTION) or default_key
        if rate <= 0 and key:
            proj = load_projections().get(key)
            if isinstance(proj, dict):
                rate = float(proj.get("projected_per_s") or 0.0)
        if rate <= 0:
            return None
        return cls(rate, key=key,
                   min_conformance=_envf(ENV_MIN_CONFORMANCE, 0.8),
                   window_s=_envf(ENV_WINDOW_S, 60.0),
                   min_tokens=int(_envf(ENV_MIN_TOKENS, 64)))

    # -- feed (engine loop thread) -----------------------------------------

    def record_step(self, *, kind: str, duration_s: float,
                    tokens: int) -> bool:
        """One engine step. Only busy steps (decode/spec) enter the window —
        an idle pod is not a slow pod. Returns True exactly when this
        sample flipped healthy → degraded (the caller then has one shot to
        attach context via :meth:`diagnose`)."""
        if kind not in ("decode", "spec") or duration_s <= 0:
            return False
        now = self._clock()
        with self._lock:
            self._events.append((now, int(tokens), float(duration_s)))
            self._prune(now)
            degraded = self._degraded_locked(now)
            flipped = degraded and not self._degraded
            self._degraded = degraded
        return flipped

    def _prune(self, now: float) -> None:
        while self._events and self._events[0][0] < now - self.window_s:
            self._events.popleft()

    def _rates_locked(self, now: float):
        tokens = sum(t for _, t, _ in self._events)
        busy = sum(b for _, _, b in self._events)
        live = tokens / busy if busy > 0 else 0.0
        return tokens, busy, live

    def _degraded_locked(self, now: float) -> bool:
        tokens, busy, live = self._rates_locked(now)
        if tokens < self.min_tokens:
            return False
        return (live / self.projected_per_s) < self.min_conformance

    def diagnose(self, context: Optional[Dict[str, Any]] = None) -> None:
        """Structured degradation diagnosis — one JSON log line a human (or
        a log-router alert) can act on."""
        self.diagnoses += 1
        snap = self.snapshot()
        if context:
            snap.update(context)
        snap["projection_key"] = self.key
        log.warning("perf sentinel: pod below %.0f%% of its projected "
                    "throughput %s",
                    100 * self.min_conformance, json.dumps(snap))

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Flat numeric state — the ``/stats`` ``"perf"`` section;
        ``serve.metrics`` prefixes with ``shai_perf_`` (so ``conformance``
        exports as ``shai_perf_conformance``).

        Evidence-gated: with fewer than ``min_tokens`` in the window the
        pod reads CONFORMANT (1.0, not degraded) — an idle pod has no
        evidence of slowness, and a degraded-then-drained pod must not
        keep alarming off an empty window. ``window_tokens`` says how much
        evidence backs the ratio."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            tokens, busy, live = self._rates_locked(now)
            degraded = self._degraded_locked(now)
            self._degraded = degraded   # drain clears a stale latch
        conf = (live / self.projected_per_s if tokens >= self.min_tokens
                else 1.0)
        return {
            "projected_per_s": round(self.projected_per_s, 4),
            "live_per_s": round(live, 4),
            "conformance": round(conf, 4),
            "window_tokens": float(tokens),
            "window_busy_s": round(busy, 4),
            "degraded": 1.0 if degraded else 0.0,
        }

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded
