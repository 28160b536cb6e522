"""Multi-tenant QoS: priority classes and weighted-fair scheduling.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/resilience/qos.py``
(``:54-296``): the header parse (``X-SHAI-Tenant``, ``X-SHAI-Priority``),
``QosTag`` and its contextvar, the ``SHAI_QOS`` gate,
``WeightedFairScheduler`` and ``schedule_rotate``. Priority classes are
``high``/``normal``/``low`` (0/1/2, lower is more important); a malformed
priority degrades to the default, never a 400. The scheduler is a stride
scheduler over the classes with anti-starvation aging; the engine rotates
the picked class's oldest request to the queue head
(:func:`schedule_rotate`), so its FIFO admission dequeues weighted-fair,
and with ``SHAI_QOS`` unset the rotation never runs. The tenant budgets
(``TenantBudget``, ``TenantLedger``) and admission shedding come in a
later slice.
"""

from __future__ import annotations

import contextvars
import dataclasses
import logging
import re
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

from ..utils.env import env_bool, env_int, env_str

log = logging.getLogger(__name__)

#: request headers naming the tenant and priority class
TENANT_HEADER = "x-shai-tenant"
PRIORITY_HEADER = "x-shai-priority"

#: priority classes: LOWER is more important (sorts naturally)
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2
PRIORITY_NAMES = {"high": PRIORITY_HIGH, "normal": PRIORITY_NORMAL,
                  "low": PRIORITY_LOW}
_CLASS_NAMES = {v: k for k, v in PRIORITY_NAMES.items()}

#: default stride weights per class: high gets 8x low's service share
DEFAULT_WEIGHTS = {PRIORITY_HIGH: 8.0, PRIORITY_NORMAL: 4.0,
                   PRIORITY_LOW: 1.0}

#: tenant label charset/length bound: anything else sanitizes away, so a
#: hostile header cannot mint unbounded or exposition-breaking labels
_TENANT_RE = re.compile(r"[^A-Za-z0-9_.:-]+")
MAX_TENANT_CHARS = 64


def qos_enabled() -> bool:
    """``SHAI_QOS`` gate, default OFF: unset, the engine's dequeue (and so
    its token stream) is the FIFO baseline's."""
    return env_bool("SHAI_QOS", False)


def sanitize_tenant(raw: Optional[str]) -> str:
    """Bounded, charset-safe tenant id ('' when absent or empty)."""
    if not raw:
        return ""
    return _TENANT_RE.sub("", str(raw))[:MAX_TENANT_CHARS]


def parse_priority(raw: Optional[str],
                   default: int = PRIORITY_NORMAL) -> int:
    """Lenient priority parse: ``high``/``normal``/``low`` or ``0``/``1``/
    ``2``; anything else (absent, typo) degrades to ``default``."""
    if raw is None:
        return default
    v = str(raw).strip().lower()
    if v in PRIORITY_NAMES:
        return PRIORITY_NAMES[v]
    try:
        n = int(v)
    except ValueError:
        return default
    return min(max(n, PRIORITY_HIGH), PRIORITY_LOW)


def class_name(priority: int) -> str:
    return _CLASS_NAMES.get(priority, str(priority))


def qos_from_headers(headers: Dict[str, str]) -> Tuple[str, int]:
    """Resolve ``(tenant, priority)`` for one request: header wins, env
    default (``SHAI_TENANT_DEFAULT`` / ``SHAI_PRIORITY_DEFAULT``) fills
    in. Both parses are lenient."""
    tenant = sanitize_tenant(headers.get(TENANT_HEADER))
    if not tenant:
        tenant = sanitize_tenant(env_str("SHAI_TENANT_DEFAULT", ""))
    default_prio = parse_priority(env_str("SHAI_PRIORITY_DEFAULT", ""),
                                  PRIORITY_NORMAL)
    return tenant, parse_priority(headers.get(PRIORITY_HEADER),
                                  default_prio)


@dataclasses.dataclass(frozen=True)
class QosTag:
    """One request's QoS identity, riding the request context onto the
    model lane and from there into ``EngineLoop.submit``."""

    tenant: str = ""
    priority: int = PRIORITY_NORMAL


_current: "contextvars.ContextVar[Optional[QosTag]]" = (
    contextvars.ContextVar("shai_qos", default=None))


def set_current_qos(tag: Optional[QosTag]) -> "contextvars.Token":
    return _current.set(tag)


def reset_current_qos(token: "contextvars.Token") -> None:
    _current.reset(token)


def current_qos() -> Optional[QosTag]:
    return _current.get()


class WeightedFairScheduler:
    """Stride scheduling over priority classes, with aging.

    Each class holds a ``pass`` value; :meth:`select` returns the eligible
    class with the least pass (ties: the more important class) and
    advances it by ``STRIDE / weight``. A class joining (or re-joining
    after its queue drained) enters at the eligible minimum, so absence
    banks no credit. Aging: a class skipped ``aging_rounds`` consecutive
    selections while eligible is served at once, whatever the weights
    say. Host arithmetic only; only the engine-loop thread calls
    :meth:`select`.
    """

    STRIDE = float(1 << 20)

    def __init__(self, weights: Optional[Dict[int, float]] = None,
                 aging_rounds: int = 32):
        w = dict(DEFAULT_WEIGHTS)
        if weights:
            w.update(weights)
        # floor 1.0: a zero or negative weight would be starvation by
        # configuration, exactly what aging exists to prevent
        self.weights = {int(c): max(1.0, float(v)) for c, v in w.items()}
        self.aging_rounds = max(1, int(aging_rounds))
        self._pass: Dict[int, float] = {}
        self._skipped: Dict[int, int] = {}
        self.picks: Dict[int, int] = {}
        self.aged_picks = 0

    @classmethod
    def from_env(cls) -> "WeightedFairScheduler":
        """``SHAI_QOS_WEIGHTS`` (``high=8,normal=4,low=1``: names or class
        numbers, lenient per clause) and ``SHAI_QOS_AGING_ROUNDS``."""
        weights: Dict[int, float] = {}
        for clause in env_str("SHAI_QOS_WEIGHTS", "").split(","):
            clause = clause.strip()
            if not clause:
                continue
            name, sep, val = clause.partition("=")
            try:
                if not sep:
                    raise ValueError("missing '='")
                cls_id = parse_priority(name, -1)
                if cls_id < 0:
                    raise ValueError(f"unknown class {name!r}")
                weights[cls_id] = float(val)
            except ValueError as e:
                log.warning("malformed SHAI_QOS_WEIGHTS clause %r (%s), "
                            "ignored", clause, e)
        return cls(weights or None,
                   aging_rounds=env_int("SHAI_QOS_AGING_ROUNDS", 32))

    def _stride(self, cls_id: int) -> float:
        return self.STRIDE / self.weights.get(cls_id, 1.0)

    def select(self, nonempty: Sequence[int]) -> int:
        """Pick the next class to serve among ``nonempty`` (class ids with
        queued work). Advances the stride and aging state."""
        eligible = sorted(set(nonempty))
        if not eligible:
            raise ValueError("select() needs at least one non-empty class")
        known = [self._pass[c] for c in eligible if c in self._pass]
        floor = min(known) if known else 0.0
        for c in eligible:
            self._pass[c] = max(self._pass.get(c, floor), floor)
        for c in self._skipped:
            # "skipped" means skipped while eligible: a drained class
            # re-joining carries no old streak into a forced pick
            if c not in eligible:
                self._skipped[c] = 0
        aged = [c for c in eligible
                if self._skipped.get(c, 0) >= self.aging_rounds]
        if aged:
            pick = max(aged, key=lambda c: (self._skipped.get(c, 0), c))
            self.aged_picks += 1
        else:
            pick = min(eligible, key=lambda c: (self._pass[c], c))
        self._pass[pick] += self._stride(pick)
        for c in eligible:
            self._skipped[c] = 0 if c == pick else self._skipped.get(c, 0) + 1
        self.picks[pick] = self.picks.get(pick, 0) + 1
        # rebase so pass values stay bounded over the process's life
        base = min(self._pass.values())
        if base > 1e15:
            for c in self._pass:
                self._pass[c] -= base
        return pick


def schedule_rotate(waiting: "deque", sched: WeightedFairScheduler) -> None:
    """The weighted-fair dequeue: rotate the selected class's OLDEST
    request to the head of ``waiting``, so the engine's ``popleft``
    admission dequeues it next. FIFO within a class; a no-op when fewer
    than two classes are queued (the stride state never advances without
    contention)."""
    if len(waiting) < 2:
        return
    first_idx: Dict[int, int] = {}
    for idx, r in enumerate(waiting):
        p = getattr(r, "priority", PRIORITY_NORMAL)
        if p not in first_idx:
            first_idx[p] = idx
    if len(first_idx) < 2:
        return
    idx = first_idx[sched.select(sorted(first_idx))]
    if idx:
        req = waiting[idx]
        del waiting[idx]
        waiting.appendleft(req)
