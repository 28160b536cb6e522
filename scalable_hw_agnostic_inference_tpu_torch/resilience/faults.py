"""Deterministic fault injection: named sites, seeded draws, env/endpoint
driven.

Copy of ``scalable_hw_agnostic_inference_tpu/resilience/faults.py``: the
``SHAI_FAULTS`` grammar, the seeded per-site streams, ``sleep_at``,
``raise_at``, ``should_fail`` and the ``SHAI_FAULTS_ENDPOINT`` arm.

The chaos suite's core claim — *every accepted request reaches a terminal
state within its deadline under any injected fault* — is only testable if
the faults themselves are reproducible. So the injector is seeded: each
site draws from its own ``random.Random(f"{seed}:{site}")`` stream, making
a site's firing pattern a pure function of (spec, seed, per-site call
count) regardless of how other sites interleave.

Spec grammar (``SHAI_FAULTS`` env var, or ``POST /debug/faults``)::

    spec    := clause ("," clause)*
    clause  := site "=" kind ["(" arg ")"] ["@" prob] ["#" limit]
    kind    := "delay" | "stall" | "error" | "drop"

- ``delay(seconds)`` — sleep before the site's work (step latency);
- ``stall(seconds)`` — same mechanism, spelled for long hangs (watchdog
  fodder); default 30 s when the arg is omitted;
- ``error`` — raise (``FaultError`` or the site's native exception type);
- ``drop`` — the site discards its message/effect (multihost mirror);
- ``@prob`` — firing probability per draw, default 1.0;
- ``#limit`` — max total firings, default unlimited.

Examples::

    SHAI_FAULTS="engine.step=delay(0.05)@0.5"        # flaky slow steps
    SHAI_FAULTS="engine.kv_reserve=error@0.3,cova.rpc=error#3"
    SHAI_FAULTS="engine.step=stall(20)#1"            # one 20s stall

Sites this port calls (grep for the constant):

- :data:`ENGINE_STEP` — ``LLMEngine.step`` entry, both disciplines
  (latency/stall/crash). It runs on the host between steps, before any
  replay is enqueued, never inside a graph capture;
- :data:`KV_RESERVE` — the admission reservation gate (``_try_reserve``):
  an injected failure reads as a dry pool, exercising reject/wait paths;
- :data:`COMPILE` — an executable-factory cache miss (``_prefill_for``,
  ``_cont_for``, ``_decode_for``, the fused keys): an injected error is a
  compile failure. It fires before the function is built, so before the
  eager warm call and before ``torch.cuda.graph`` opens a capture: a raise
  inside a capture would leave the stream in capture mode and poison
  every later launch;
- :data:`IDEMP_LOOKUP` — the per-pod idempotency-cache lookup
  (``resilience.idempotency``): error -> the lookup degrades to a cache
  MISS (the request executes; at-most-once degrades to at-least-once,
  never to a dropped request), delay -> a slow lookup;
- :data:`MIRROR` — the leader's broadcast of a mirrored call
  (``serve.multihost``): drop -> the leader runs the call alone, and its
  collectives fail the unit together at the group's timeout.

The other site names (``cova.rpc``, ``kvnet.fetch``,
``migrate.*``, ``kvfabric.probe``, ``scale.*``, ``hedge.fire``,
``poison.mark``) are kept as constants so that one ``SHAI_FAULTS`` spec
means the same on a JAX pod and a port pod; their call sites come with
the modules that own them.

The module-level injector is built once from ``SHAI_FAULTS`` /
``SHAI_FAULTS_SEED`` and replaced at runtime via :func:`configure` (the
``/debug/faults`` endpoint). With no spec, every helper is a dict-miss —
safe on the engine hot path.
"""

from __future__ import annotations

import logging
import random
import re
import threading
import time
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

ENGINE_STEP = "engine.step"
KV_RESERVE = "engine.kv_reserve"
COMPILE = "engine.compile"
COVA_RPC = "cova.rpc"
MIRROR = "multihost.mirror"
KVNET_FETCH = "kvnet.fetch"
MIGRATE_SHIP = "migrate.ship"
MIGRATE_RESTORE = "migrate.restore"
# the KV-fabric peer-probe rung (kvnet.directory.FabricProbe): error ->
# the probed holder looks dead (breaker-counted), the admission ladder
# degrades to recompute — never a request failure
KVFABRIC_PROBE = "kvfabric.probe"
# the fleet autoscaler (orchestrate.scaler): decide -> a corrupted
# decision the control discipline must absorb; apply -> the actuator
# fails and the tick must retry, not wedge
SCALE_DECIDE = "scale.decide"
SCALE_APPLY = "scale.apply"
# request reliability (resilience.hedge / resilience.idempotency via
# orchestrate.cova and serve.app): hedge launch, per-pod idempotency
# lookup, and the poison-registry mark after an abnormal engine death
HEDGE_FIRE = "hedge.fire"
IDEMP_LOOKUP = "idemp.lookup"
POISON_MARK = "poison.mark"

KINDS = ("delay", "stall", "error", "drop")

_CLAUSE = re.compile(
    r"^(?P<site>[\w.\-]+)=(?P<kind>\w+)"
    r"(?:\((?P<arg>[^)]*)\))?"
    r"(?:@(?P<prob>[0-9.]+))?"
    r"(?:#(?P<limit>\d+))?$")


class FaultError(RuntimeError):
    """Default exception an ``error``-kind fault raises at its site."""


class _Clause:
    def __init__(self, site: str, kind: str, arg: float, prob: float,
                 limit: Optional[int], seed: int):
        self.site = site
        self.kind = kind
        self.arg = arg
        self.prob = prob
        self.limit = limit
        self.fired = 0
        self.draws = 0
        # per-clause stream: a site's firing pattern depends only on its
        # own draw count, never on other sites' call interleaving
        self._rng = random.Random(f"{seed}:{site}:{kind}")

    def draw(self) -> bool:
        """One deterministic firing decision (caller holds the lock)."""
        self.draws += 1
        if self.limit is not None and self.fired >= self.limit:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True

    def describe(self) -> Dict:
        return {"site": self.site, "kind": self.kind, "arg": self.arg,
                "prob": self.prob, "limit": self.limit,
                "fired": self.fired, "draws": self.draws}


def _parse(spec: str, seed: int) -> Dict[str, List[_Clause]]:
    out: Dict[str, List[_Clause]] = {}
    for raw in spec.split(","):
        raw = raw.strip()
        if not raw:
            continue
        m = _CLAUSE.match(raw)
        if not m:
            raise ValueError(f"bad fault clause {raw!r} "
                             f"(grammar: site=kind[(arg)][@prob][#limit])")
        kind = m.group("kind")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {raw!r} "
                             f"(known: {KINDS})")
        arg = m.group("arg")
        if arg:
            arg_f = float(arg)
        else:
            arg_f = 30.0 if kind == "stall" else 0.0
        prob = float(m.group("prob")) if m.group("prob") else 1.0
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"prob out of [0,1] in {raw!r}")
        limit = int(m.group("limit")) if m.group("limit") else None
        site = m.group("site")
        out.setdefault(site, []).append(
            _Clause(site, kind, arg_f, prob, limit, seed))
    return out


class FaultInjector:
    """Seeded fault schedule over named sites. Thread-safe: sites fire from
    the engine loop, the event loop, and pool threads concurrently."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._clauses = _parse(spec, seed)
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self._clauses)

    def _fire(self, site: str, kinds) -> Optional[_Clause]:
        clauses = self._clauses.get(site)
        if not clauses:
            return None
        with self._lock:
            for c in clauses:
                if c.kind in kinds and c.draw():
                    return c
        return None

    # -- site helpers (each consults only its own kinds) -------------------

    def _sleep_seconds(self, site: str) -> float:
        c = self._fire(site, ("delay", "stall"))
        if c is None:
            return 0.0
        log.warning("fault %s: %s %.3fs", site, c.kind, c.arg)
        return c.arg

    def sleep_at(self, site: str) -> float:
        """Apply a ``delay``/``stall`` clause; returns seconds slept.
        Blocking — for thread-resident sites (the engine loop)."""
        s = self._sleep_seconds(site)
        if s:
            time.sleep(s)
        return s

    async def asleep_at(self, site: str) -> float:
        """:meth:`sleep_at` for event-loop-resident sites (cova's fan-out):
        awaits instead of blocking, so an injected RPC delay slows THAT
        call, not every coroutine in the process. Same draw stream."""
        s = self._sleep_seconds(site)
        if s:
            import asyncio

            await asyncio.sleep(s)
        return s

    def should_fail(self, site: str) -> bool:
        """True when an ``error`` clause fires — the site raises its own
        native failure (or calls :meth:`raise_at`)."""
        c = self._fire(site, ("error",))
        if c is not None:
            log.warning("fault %s: injected error", site)
            return True
        return False

    def raise_at(self, site: str, exc=FaultError) -> None:
        if self.should_fail(site):
            raise exc(f"injected fault at {site}")

    def should_drop(self, site: str) -> bool:
        c = self._fire(site, ("drop",))
        if c is not None:
            log.warning("fault %s: dropping", site)
            return True
        return False

    def snapshot(self) -> Dict:
        """Introspection payload for ``GET /debug/faults``."""
        with self._lock:
            return {"spec": self.spec, "seed": self.seed,
                    "active": self.active,
                    "clauses": [c.describe()
                                for cl in self._clauses.values()
                                for c in cl]}


_NOOP = FaultInjector("", 0)
_global: Optional[FaultInjector] = None
_global_lock = threading.Lock()


def get() -> FaultInjector:
    """The process injector: built once from ``SHAI_FAULTS`` (seed
    ``SHAI_FAULTS_SEED``, default 0), no-op when unset. Cheap when idle —
    the hot path pays one attribute read and a dict miss."""
    global _global
    inj = _global
    if inj is not None:
        return inj
    with _global_lock:
        if _global is None:
            from ..utils.env import env_int, env_str

            spec = env_str("SHAI_FAULTS")
            seed = env_int("SHAI_FAULTS_SEED", 0)
            try:
                _global = FaultInjector(spec, seed) if spec else _NOOP
            except ValueError:
                log.exception("bad SHAI_FAULTS spec %r — faults disabled",
                              spec)
                _global = _NOOP
        return _global


def configure(spec: str, seed: int = 0) -> FaultInjector:
    """Replace the process injector (the ``POST /debug/faults`` path).
    Raises ``ValueError`` on a bad spec, leaving the old schedule live."""
    global _global
    inj = FaultInjector(spec, seed) if spec else _NOOP
    with _global_lock:
        _global = inj
    return inj


def endpoint_enabled() -> bool:
    """``POST /debug/faults`` is armed only by explicit env opt-in — a
    production pod must not accept fault writes from anyone who can reach
    its port. ``SHAI_FAULTS`` alone does NOT arm it: a canary running a
    benign env fault must not open an unauthenticated write endpoint."""
    from ..utils.env import env_bool

    return env_bool("SHAI_FAULTS_ENDPOINT", False)


def reset() -> None:
    """Drop back to the env-derived schedule (tests)."""
    global _global
    with _global_lock:
        _global = None
