"""SLO engine: per-model latency/error objectives as multi-window burn rates.

Copy of ``scalable_hw_agnostic_inference_tpu/obs/slo.py``, fed by the
port engine's TTFT, TPOT and stop reasons as the reference's engine feeds
it (``engine/engine.py:1212-1241``).

The failover controller reacted to capacity events and queue overload —
never to a tier *missing its own latency targets*. This module turns raw
TTFT/TPOT observations and request outcomes into the SRE-standard signal:
for each objective, the **burn rate** — observed violation fraction over a
rolling window divided by the error budget — evaluated over a fast window
(default 5 m, catches a sudden regression) and a slow window (default 1 h,
filters blips). A breach (fast burn ≥ 14.4 *and* slow burn ≥ 1, with
enough events to mean anything) exports as ``shai_slo_breach`` and rides
``/stats`` → ``"slo"``, where ``orchestrate.capacity_checker`` reads it as
a latency-driven failover trigger alongside the capacity/overload paths.

Targets come from the unit config (``EngineConfig.slo_*``) or env
(``SHAI_SLO_TTFT_MS`` etc. — env wins); with no target configured the
engine carries no SLO state at all.

Layering: stdlib-only; an injectable ``clock`` keeps the window math
deterministically testable.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

#: objective → env override (milliseconds for latency, fraction for errors)
ENV_TTFT_MS = "SHAI_SLO_TTFT_MS"
ENV_TPOT_MS = "SHAI_SLO_TPOT_MS"
ENV_ERROR_RATE = "SHAI_SLO_ERROR_RATE"
ENV_BUDGET = "SHAI_SLO_BUDGET"
ENV_FAST_S = "SHAI_SLO_FAST_S"
ENV_SLOW_S = "SHAI_SLO_SLOW_S"
ENV_FAST_BURN = "SHAI_SLO_FAST_BURN"
ENV_SLOW_BURN = "SHAI_SLO_SLOW_BURN"
ENV_MIN_EVENTS = "SHAI_SLO_MIN_EVENTS"

#: engine stop reasons that count against the error objective. Client-
#: initiated cancels are neither good nor bad; eos/length are successes.
ERROR_REASONS = ("rejected", "timeout")


from ..utils.env import env_float as _env_float  # lenient: bad knob ≠ boot crash


@dataclasses.dataclass(frozen=True)
class SloTargets:
    """Objective thresholds + window/burn policy. A 0 threshold disables
    that objective; :meth:`enabled` is False when nothing is configured."""

    ttft_ms: float = 0.0          # "TTFT ≤ this for ≥ (1-budget) of reqs"
    tpot_ms: float = 0.0
    error_rate: float = 0.0       # allowed terminal-error fraction
    budget_frac: float = 0.01     # violation budget for latency objectives
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn: float = 14.4       # breach: fast ≥ this AND slow ≥ slow_burn
    slow_burn: float = 1.0
    min_events: int = 10          # fast-window events required to breach

    @property
    def enabled(self) -> bool:
        return (self.ttft_ms > 0 or self.tpot_ms > 0
                or self.error_rate > 0)

    @classmethod
    def from_env(cls, base: Optional["SloTargets"] = None) -> "SloTargets":
        """Env over unit config: a fleet-wide env rollout must win over a
        stale ConfigMap."""
        b = base or cls()
        return cls(
            ttft_ms=_env_float(ENV_TTFT_MS, b.ttft_ms),
            tpot_ms=_env_float(ENV_TPOT_MS, b.tpot_ms),
            error_rate=_env_float(ENV_ERROR_RATE, b.error_rate),
            budget_frac=max(1e-6, _env_float(ENV_BUDGET, b.budget_frac)),
            fast_window_s=_env_float(ENV_FAST_S, b.fast_window_s),
            slow_window_s=_env_float(ENV_SLOW_S, b.slow_window_s),
            fast_burn=_env_float(ENV_FAST_BURN, b.fast_burn),
            slow_burn=_env_float(ENV_SLOW_BURN, b.slow_burn),
            min_events=int(_env_float(ENV_MIN_EVENTS, b.min_events)),
        )


class _Window:
    """Bucketized good/bad counts over a bounded horizon (O(1) record,
    O(buckets) query, memory bounded by horizon/bucket)."""

    def __init__(self, horizon_s: float, bucket_s: float = 5.0):
        self.horizon_s = horizon_s
        self.bucket_s = max(0.001, bucket_s)
        self._buckets: deque = deque()   # [bucket_idx, good, bad]

    def record(self, now: float, bad: bool) -> None:
        idx = int(now // self.bucket_s)
        if self._buckets and self._buckets[-1][0] == idx:
            self._buckets[-1][2 if bad else 1] += 1
        else:
            self._buckets.append([idx, 0 if bad else 1, 1 if bad else 0])
        self._prune(idx)

    def _prune(self, now_idx: int) -> None:
        min_idx = now_idx - int(self.horizon_s // self.bucket_s) - 1
        while self._buckets and self._buckets[0][0] < min_idx:
            self._buckets.popleft()

    def counts(self, now: float, window_s: float) -> Tuple[int, int]:
        """(good, bad) inside the trailing ``window_s``."""
        lo = int((now - window_s) // self.bucket_s)
        good = bad = 0
        for idx, g, b in self._buckets:
            if idx >= lo:
                good += g
                bad += b
        return good, bad


class _Objective:
    def __init__(self, name: str, threshold_s: Optional[float],
                 budget: float, targets: SloTargets):
        self.name = name
        self.threshold_s = threshold_s   # None: outcome-fed (error objective)
        self.budget = max(1e-6, budget)
        self.t = targets
        self.window = _Window(targets.slow_window_s)

    def record(self, now: float, bad: bool) -> None:
        self.window.record(now, bad)

    def state(self, now: float) -> Dict[str, float]:
        fg, fb = self.window.counts(now, self.t.fast_window_s)
        sg, sb = self.window.counts(now, self.t.slow_window_s)
        fast = (fb / (fg + fb) / self.budget) if (fg + fb) else 0.0
        slow = (sb / (sg + sb) / self.budget) if (sg + sb) else 0.0
        breach = (fast >= self.t.fast_burn and slow >= self.t.slow_burn
                  and (fg + fb) >= self.t.min_events)
        return {f"{self.name}_fast_burn": round(fast, 4),
                f"{self.name}_slow_burn": round(slow, 4),
                f"{self.name}_events": float(fg + fb),
                f"{self.name}_breach": 1.0 if breach else 0.0}


class SloEngine:
    """Rolling burn-rate evaluation for one model's objectives.
    Thread-safe: the engine loop records, scrape threads snapshot."""

    def __init__(self, targets: SloTargets,
                 clock: Callable[[], float] = time.monotonic):
        self.targets = targets
        self._clock = clock
        self._lock = threading.Lock()
        self._objs: Dict[str, _Objective] = {}
        if targets.ttft_ms > 0:
            self._objs["ttft"] = _Objective(
                "ttft", targets.ttft_ms / 1e3, targets.budget_frac, targets)
        if targets.tpot_ms > 0:
            self._objs["tpot"] = _Objective(
                "tpot", targets.tpot_ms / 1e3, targets.budget_frac, targets)
        if targets.error_rate > 0:
            self._objs["error"] = _Objective(
                "error", None, targets.error_rate, targets)

    @classmethod
    def maybe_from_env(cls, base: Optional[SloTargets] = None
                       ) -> Optional["SloEngine"]:
        """The engine-construction entry point: None when no objective is
        configured anywhere — an unconfigured pod pays nothing."""
        t = SloTargets.from_env(base)
        return cls(t) if t.enabled else None

    # -- feeds (engine loop thread) ----------------------------------------

    def _latency(self, name: str, seconds: float) -> None:
        obj = self._objs.get(name)
        if obj is None:
            return
        with self._lock:
            obj.record(self._clock(), seconds > obj.threshold_s)

    def record_ttft(self, seconds: float) -> None:
        self._latency("ttft", seconds)

    def record_tpot(self, seconds: float) -> None:
        self._latency("tpot", seconds)

    def record_outcome(self, stop_reason: str) -> None:
        obj = self._objs.get("error")
        if obj is None or stop_reason == "cancelled":
            return
        with self._lock:
            obj.record(self._clock(), stop_reason in ERROR_REASONS)

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Flat numeric state: per-objective fast/slow burn + breach, and
        the overall ``breach`` the failover controller keys on."""
        now = self._clock()
        out: Dict[str, Any] = {}
        with self._lock:
            for obj in self._objs.values():
                out.update(obj.state(now))
        out["breach"] = 1.0 if any(
            v for k, v in out.items() if k.endswith("_breach")) else 0.0
        return out

    @property
    def breached(self) -> bool:
        return bool(self.snapshot()["breach"])
