"""Bounded admission: shed load at the HTTP door instead of parking threads.

Copy of ``scalable_hw_agnostic_inference_tpu/resilience/admission.py``.
The engine snapshot it reads is the port's ``obs.steploop`` gauges: host
counters the engine loop writes at the end of each step, so a check
never touches a device tensor on the request thread.

The engine queue was previously unbounded — any number of requests could
pile into ``add_request`` while the pool was saturated, each one parking a
serving-lane thread on a future for up to 600 s. That converts overload
into latency collapse (every queued request times out together) instead of
the fast 429 a load balancer can act on.

The gate prices admission with the SAME thresholds the failover controller
uses (:class:`orchestrate.capacity_checker.OverloadThresholds`, via
``is_overloaded``): sustained admission-queue depth or a KV pool at the
preemption edge. One threshold owner means the pod starts shedding exactly
where the fleet controller would call it saturated — the 429s a client
sees and the failover the controller triggers describe the same line.

Shed responses carry ``Retry-After``; counts are exported as
``shai_shed_total{reason}`` on ``/metrics`` (see ``serve.metrics``) and
under ``/stats`` → ``"shed"``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

from ..orchestrate.capacity_checker import (
    OverloadThresholds,
    is_overloaded,
)
from .qos import TenantLedger


@dataclasses.dataclass(frozen=True)
class Shed:
    """One shed decision: HTTP status + reason + client backoff hint."""

    status: int          # 429 (overload) or 503 (draining)
    reason: str          # "draining" | "queue_depth" | "kv_pressure" | ...
    retry_after_s: float

    @property
    def detail(self) -> str:
        return {
            "draining": "pod is draining: shutting down, retry elsewhere",
            "queue_depth": "admission queue is full, retry later",
            "kv_pressure": "KV pool is at the preemption edge, retry later",
            "inflight": "too many requests in flight, retry later",
            "tenant_budget": "tenant token-rate budget exhausted, retry "
                             "after the bucket refills",
            "tenant_inflight": "tenant in-flight cap reached, retry later",
        }.get(self.reason, self.reason)

    @property
    def headers(self) -> Dict[str, str]:
        return {"retry-after": str(max(1, int(round(self.retry_after_s))))}


class AdmissionGate:
    """Engine-aware load shedding in front of ``add_request``.

    ``check`` reads the engine's obs telemetry snapshot (queue depth and KV
    utilization gauges — the numbers the autoscaler already scrapes) plus
    the drain flag, an optional in-flight cap, and the serving lane's width
    (so blocking requests queued in the lane executor — invisible to the
    engine's gauges — still count against the queue-depth threshold).
    Returns a :class:`Shed` to refuse, None to admit. Thread-safe counters.
    """

    def __init__(self, thresholds: Optional[OverloadThresholds] = None,
                 max_inflight: int = 0, retry_after_s: float = 1.0,
                 drain_retry_after_s: float = 5.0,
                 tier_full_utilization: float = 0.95,
                 tier_full_kv_utilization: float = 0.85,
                 ledger: Optional[TenantLedger] = None,
                 tenant_max_inflight: int = 0):
        self.thresholds = thresholds or OverloadThresholds()
        self.max_inflight = max_inflight  # 0 = no cap
        self.retry_after_s = retry_after_s
        self.drain_retry_after_s = drain_retry_after_s
        # multi-tenant QoS (resilience.qos): when a budget ledger is
        # attached, a tenant in token-bucket debt sheds with 429 +
        # a Retry-After DERIVED from its refill deficit (finite by
        # construction) instead of the static hint the structural sheds
        # keep; tenant_max_inflight optionally caps one tenant's
        # concurrency (0 = off) so a flooder can't own every lane slot
        # even inside its token budget.
        self.ledger = ledger
        self.tenant_max_inflight = tenant_max_inflight
        # host KV tier pricing (kvtier): while the host pool can absorb
        # demotions, device eviction is cheap (a copy, not lost work) and
        # the normal max_kv_utilization line applies. Once the HOST pool
        # saturates (>= tier_full_utilization), every further eviction
        # destroys banked prefill again — the gate tightens to the lower
        # tier_full_kv_utilization line so shedding starts BEFORE the pod
        # re-enters the recompute regime. Pods without a tier never report
        # host_kv_utilization and are unaffected.
        self.tier_full_utilization = tier_full_utilization
        self.tier_full_kv_utilization = tier_full_kv_utilization
        self._lock = threading.Lock()
        self._shed: Dict[str, int] = {}

    def check(self, engine_stats: Optional[dict] = None, inflight: int = 0,
              draining: bool = False, lane_width: int = 0,
              lane_pending: int = 0, tenant: str = "") -> Optional[Shed]:
        shed = self._decide(engine_stats, inflight, draining, lane_width,
                            lane_pending, tenant)
        if shed is not None:
            with self._lock:
                self._shed[shed.reason] = self._shed.get(shed.reason, 0) + 1
        return shed

    def _decide(self, stats: Optional[dict], inflight: int,
                draining: bool, lane_width: int,
                lane_pending: int, tenant: str = "") -> Optional[Shed]:
        if draining:
            return Shed(503, "draining", self.drain_retry_after_s)
        if self.ledger is not None:
            # per-tenant enforcement BEFORE the structural caps: an
            # over-budget tenant must shed even on an idle pod, and its
            # Retry-After is the bucket's actual refill time — the static
            # hint stays for the structural (non-budget) reasons below
            ra = self.ledger.admit(tenant)
            if ra is not None:
                return Shed(429, "tenant_budget", ra)
            if (self.tenant_max_inflight
                    and self.ledger.inflight_of(tenant)
                    >= self.tenant_max_inflight):
                return Shed(429, "tenant_inflight", self.retry_after_s)
        if self.max_inflight and inflight >= self.max_inflight:
            return Shed(429, "inflight", self.retry_after_s)
        # Lane backlog: blocking requests beyond the executor's width queue
        # INVISIBLY to the engine's "waiting" gauge (only `lane_width`
        # threads ever reach add_request at once), so price the app-level
        # overflow with the same queue-depth threshold. Without this, a
        # burst of blocking calls parks unboundedly in the lane queue and
        # overload becomes latency collapse with zero 429s. ``lane_pending``
        # counts only lane-bound requests — live SSE streams run on the
        # stream pool and must not read as executor queue depth (they are
        # still visible to ``inflight``/MAX_INFLIGHT above).
        if (lane_width > 0
                and lane_pending - lane_width > self.thresholds.max_queue_depth):
            return Shed(429, "queue_depth", self.retry_after_s)
        if (isinstance(stats, dict)
                and stats.get("host_kv_utilization", 0.0)
                >= self.tier_full_utilization
                and stats.get("kv_utilization", 0.0)
                > self.tier_full_kv_utilization):
            # saturated host tier: demotion degraded back to deletion, so
            # device-KV pressure is priced at the tighter line
            return Shed(429, "kv_pressure", self.retry_after_s)
        if isinstance(stats, dict) and is_overloaded(stats, self.thresholds):
            reason = ("queue_depth"
                      if stats.get("waiting", 0) > self.thresholds.max_queue_depth
                      else "kv_pressure")
            return Shed(429, reason, self.retry_after_s)
        return None

    @property
    def shed_total(self) -> int:
        with self._lock:
            return sum(self._shed.values())

    def shed_by_reason(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._shed)
