"""The overload thresholds the admission gate and the failover controller
share.

Trimmed copy of
``scalable_hw_agnostic_inference_tpu/orchestrate/capacity_checker.py``
(``OverloadThresholds``, ``slo_breached`` and ``is_overloaded``,
``:55-92``): one threshold owner, so the pod starts shedding exactly where
the fleet controller would call it saturated. The controller itself (the
event scan, the routing decision, the kubectl glue) comes with the fleet
control plane.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class OverloadThresholds:
    """When a pod's engine telemetry (``/stats`` -> ``engine``, the
    ``obs.steploop`` snapshot) reads saturated: a sustained admission queue
    OR a KV pool at the preemption edge."""

    max_queue_depth: float = 8.0       # waiting requests on one pod
    max_kv_utilization: float = 0.95   # page pool fraction in use


def slo_breached(stats: Optional[dict]) -> bool:
    """A merged snapshot's ``slo_breach`` key (the fleet controller merges
    it in from ``/stats`` -> ``"slo"``); absent telemetry reads healthy."""
    return isinstance(stats, dict) and bool(stats.get("slo_breach"))


def is_overloaded(stats: Optional[dict],
                  th: OverloadThresholds = OverloadThresholds()) -> bool:
    """One pod's engine snapshot -> saturated? A missing or partial
    snapshot (pod loading) reads healthy, so absent telemetry never flaps
    the routing mode; a merged SLO breach counts as saturation."""
    if not isinstance(stats, dict):
        return False
    if stats.get("waiting", 0) > th.max_queue_depth:
        return True
    if slo_breached(stats):
        return True
    return stats.get("kv_utilization", 0.0) > th.max_kv_utilization
