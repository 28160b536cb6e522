"""The port's resilience layer against the JAX package's, on the CPU.

Each case of ``tests/test_resilience.py`` (the fault grammar, seeded
determinism, per-site streams, the admission gate, the drain controller
and the step watchdog), ``tests/test_reliability.py:167-237`` (the
idempotency cache) and ``tests/test_qos.py:83-159,308-340`` (tenant
budgets, the ledger and the gate's tenant sheds) runs on both packages
(``pkg`` is ``jax`` or ``torch``), with injected clocks and seeded draws.
The ``test_parity_*`` cases run one scripted sequence through both
packages and require equal results, snapshot for snapshot.
"""

import asyncio
import types

import pytest

from scalable_hw_agnostic_inference_tpu.orchestrate import (
    capacity_checker as j_cap,
)
from scalable_hw_agnostic_inference_tpu.resilience import admission as j_adm
from scalable_hw_agnostic_inference_tpu.resilience import drain as j_drain
from scalable_hw_agnostic_inference_tpu.resilience import faults as j_faults
from scalable_hw_agnostic_inference_tpu.resilience import (
    idempotency as j_idemp,
)
from scalable_hw_agnostic_inference_tpu.resilience import qos as j_qos
from scalable_hw_agnostic_inference_tpu.utils import env as j_env
from scalable_hw_agnostic_inference_tpu_torch.orchestrate import (
    capacity_checker as t_cap,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import (
    admission as t_adm,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import (
    drain as t_drain,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import (
    faults as t_faults,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import (
    idempotency as t_idemp,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import qos as t_qos
from scalable_hw_agnostic_inference_tpu_torch.utils import env as t_env

PKGS = {
    "jax": types.SimpleNamespace(cap=j_cap, adm=j_adm, drain=j_drain,
                                 faults=j_faults, idemp=j_idemp, qos=j_qos,
                                 env=j_env),
    "torch": types.SimpleNamespace(cap=t_cap, adm=t_adm, drain=t_drain,
                                   faults=t_faults, idemp=t_idemp, qos=t_qos,
                                   env=t_env),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    ns = PKGS[request.param]
    ns.faults.reset()
    yield ns
    ns.faults.reset()


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- faults ------------------------------------------------------------------

def test_fault_spec_grammar(pkg):
    inj = pkg.faults.FaultInjector(
        "engine.step=delay(0.01)@0.5#3,cova.rpc=error,x.y=drop#1,"
        "a.b=stall", seed=7)
    by_site = {c["site"]: c for c in inj.snapshot()["clauses"]}
    assert by_site["engine.step"]["kind"] == "delay"
    assert by_site["engine.step"]["arg"] == 0.01
    assert by_site["engine.step"]["prob"] == 0.5
    assert by_site["engine.step"]["limit"] == 3
    assert by_site["cova.rpc"]["kind"] == "error"
    assert by_site["a.b"]["arg"] == 30.0      # stall default
    assert inj.active


@pytest.mark.parametrize("bad", ["site", "s=frobnicate", "s=error@1.5",
                                 "=error", "s=delay(x)"])
def test_fault_spec_rejects_garbage(pkg, bad):
    with pytest.raises(ValueError):
        pkg.faults.FaultInjector(bad)


def test_fault_determinism_and_limits(pkg):
    def pattern(seed):
        inj = pkg.faults.FaultInjector("a=error@0.5", seed=seed)
        return [inj.should_fail("a") for _ in range(50)]

    assert pattern(3) == pattern(3)
    assert pattern(3) != pattern(4)
    assert 5 < sum(pattern(3)) < 45
    inj = pkg.faults.FaultInjector("a=error#2")
    assert [inj.should_fail("a") for _ in range(5)] == [
        True, True, False, False, False]


def test_fault_sites_are_independent_streams(pkg):
    solo = pkg.faults.FaultInjector("a=error@0.5", seed=1)
    a_solo = [solo.should_fail("a") for _ in range(20)]
    mixed = pkg.faults.FaultInjector("a=error@0.5,b=error@0.5", seed=1)
    a_mixed = []
    for _ in range(20):
        mixed.should_fail("b")
        a_mixed.append(mixed.should_fail("a"))
    assert a_solo == a_mixed


def test_fault_kind_helpers_do_not_cross_fire(pkg):
    inj = pkg.faults.FaultInjector("a=error")
    assert inj.sleep_at("a") == 0.0
    assert not inj.should_drop("a")
    assert inj.should_fail("a")
    with pytest.raises(pkg.faults.FaultError):
        inj.raise_at("a")


def test_fault_global_configure_and_reset(pkg):
    inj = pkg.faults.configure("a=drop")
    assert pkg.faults.get() is inj
    assert pkg.faults.get().should_drop("a")
    pkg.faults.reset()
    assert not pkg.faults.get().active


def test_fault_endpoint_not_armed_by_spec_env(pkg, monkeypatch):
    monkeypatch.delenv("SHAI_FAULTS_ENDPOINT", raising=False)
    monkeypatch.setenv("SHAI_FAULTS", "engine.step=delay(0.01)@0.01")
    assert not pkg.faults.endpoint_enabled()
    monkeypatch.setenv("SHAI_FAULTS_ENDPOINT", "1")
    assert pkg.faults.endpoint_enabled()
    monkeypatch.setenv("SHAI_FAULTS_ENDPOINT", "0")
    assert not pkg.faults.endpoint_enabled()


def test_fault_env_spec_builds_the_process_injector(pkg, monkeypatch):
    monkeypatch.setenv("SHAI_FAULTS", "engine.step=error#1")
    monkeypatch.setenv("SHAI_FAULTS_SEED", "5")
    pkg.faults.reset()
    inj = pkg.faults.get()
    assert inj.active and inj.seed == 5
    assert inj.should_fail(pkg.faults.ENGINE_STEP)
    assert not inj.should_fail(pkg.faults.ENGINE_STEP)


def test_fault_async_sleep_shares_draw_stream(pkg):
    sync = pkg.faults.FaultInjector("a=delay(0.001)@0.5", seed=9)
    pattern_sync = [sync.sleep_at("a") > 0 for _ in range(20)]
    ainj = pkg.faults.FaultInjector("a=delay(0.001)@0.5", seed=9)

    async def drain():
        return [await ainj.asleep_at("a") > 0 for _ in range(20)]

    assert asyncio.run(drain()) == pattern_sync
    assert 2 < sum(pattern_sync) < 18


def test_fault_site_names_match():
    names = [n for n in dir(j_faults) if n.isupper() and isinstance(
        getattr(j_faults, n), (str, tuple))]
    assert names
    for n in names:
        assert getattr(t_faults, n) == getattr(j_faults, n), n


# -- admission gate ----------------------------------------------------------

def test_admission_gate_thresholds_mirror_controller(pkg):
    gate = pkg.adm.AdmissionGate(pkg.cap.OverloadThresholds(
        max_queue_depth=2.0, max_kv_utilization=0.9))
    assert gate.check({"waiting": 1.0, "kv_utilization": 0.5}) is None
    shed = gate.check({"waiting": 5.0, "kv_utilization": 0.5})
    assert (shed.status, shed.reason) == (429, "queue_depth")
    shed = gate.check({"waiting": 0.0, "kv_utilization": 0.95})
    assert (shed.status, shed.reason) == (429, "kv_pressure")
    assert int(shed.headers["retry-after"]) >= 1
    assert gate.check(None) is None
    assert gate.check({}) is None
    assert gate.shed_total == 2
    assert gate.shed_by_reason() == {"queue_depth": 1, "kv_pressure": 1}


def test_admission_gate_drain_and_inflight(pkg):
    gate = pkg.adm.AdmissionGate(max_inflight=2)
    shed = gate.check(None, draining=True)
    assert (shed.status, shed.reason) == (503, "draining")
    assert gate.check(None, inflight=1) is None
    shed = gate.check(None, inflight=2)
    assert (shed.status, shed.reason) == (429, "inflight")


def test_admission_gate_lane_backlog_sheds_blocking_overload(pkg):
    gate = pkg.adm.AdmissionGate(pkg.cap.OverloadThresholds(
        max_queue_depth=4.0))
    idle = {"waiting": 0.0, "kv_utilization": 0.1}
    assert gate.check(idle, lane_pending=5, lane_width=1) is None
    shed = gate.check(idle, lane_pending=6, lane_width=1)
    assert (shed.status, shed.reason) == (429, "queue_depth")
    assert gate.check(idle, lane_pending=6, lane_width=8) is None
    assert gate.check(idle, inflight=100, lane_pending=0,
                      lane_width=1) is None
    assert gate.check(idle, lane_pending=100) is None


def test_overload_thresholds_are_the_serve_config_defaults(pkg):
    th = pkg.cap.OverloadThresholds()
    cfg = pkg.env.ServeConfig()
    assert (th.max_queue_depth, th.max_kv_utilization) == (
        cfg.admit_max_queue, cfg.admit_max_kv)
    assert pkg.cap.is_overloaded({"slo_breach": 1.0})
    assert not pkg.cap.is_overloaded(None)


# -- drain controller and watchdog -------------------------------------------

def test_drain_controller_budget_and_idempotence(pkg):
    clock = FakeClock()
    d = pkg.drain.DrainController(budget_s=10.0, clock=clock)
    assert not d.draining and d.remaining_s == 10.0
    assert d.begin()
    assert not d.begin()
    assert d.draining
    clock.t = 4.0
    assert d.remaining_s == pytest.approx(6.0)
    clock.t = 11.0
    assert d.remaining_s == 0.0
    assert d.wait(lambda: False) is False
    assert d.wait(lambda: True) is True


def test_drain_wait_returns_when_idle(pkg):
    d = pkg.drain.DrainController(budget_s=5.0)
    d.begin()
    box = {"n": 3}

    def idle():
        box["n"] -= 1
        return box["n"] <= 0

    assert d.wait(idle, poll_s=0.001) is True


class FakeTele:
    def __init__(self, age, p99):
        self._age = age
        self._p99 = p99

    def last_step_age_s(self, now=None):
        return self._age

    def step_duration_p99(self):
        return self._p99


def _watchdog_script(pkg):
    """The reference's watchdog walk, recording every verdict."""
    clock = FakeClock()
    tele = FakeTele(age=100.0, p99=0.01)
    busy = {"v": False}
    wd = pkg.drain.StepWatchdog(lambda: tele, lambda: busy["v"],
                                multiplier=10.0, min_stall_s=1.0,
                                clock=clock)
    out = [wd.check()]                 # idle: never trips
    busy["v"] = True
    out.append(wd.check())             # fresh idle->busy transition
    clock.t = 2.0
    out.append(wd.check())             # busy 2 s with no step: trips
    tele._age = 0.5
    out.append(wd.check())             # fresh step
    tele._age, tele._p99 = 5.0, 1.0    # limit max(1, 10 x 1.0) = 10
    clock.t = 20.0
    out.append(wd.check())
    tele._age = 11.0
    out.append(wd.check())
    busy["v"] = False
    out.append(wd.check())
    busy["v"] = True
    out.append(wd.check())
    out.append(pkg.drain.StepWatchdog(lambda: None, lambda: True).check())
    return out


def test_watchdog_trips_only_when_busy_and_stale(pkg):
    v = _watchdog_script(pkg)
    assert v[0] is None and v[1] is None
    assert "stalled" in v[2]
    assert v[3] is None and v[4] is None
    assert v[5] is not None
    assert v[6] is None and v[7] is None and v[8] is None


def test_watchdog_idle_gap_not_counted_as_stall(pkg):
    clock = FakeClock(3600.0)
    tele = FakeTele(age=3600.0, p99=0.01)
    wd = pkg.drain.StepWatchdog(lambda: tele, lambda: True,
                                multiplier=10.0, min_stall_s=1.0,
                                clock=clock)
    assert wd.check() is None
    clock.t = 3600.5
    assert wd.check() is None
    clock.t = 3602.0
    assert wd.check() is not None


# -- idempotency cache -------------------------------------------------------

@pytest.mark.parametrize("key,ok", [
    ("abc-123_x.y:z", True), ("a" * 128, True), ("a" * 129, False),
    ("", False), ("has spaces", False), ("newline\n", False)])
def test_idemp_key_grammar(pkg, key, ok):
    assert pkg.idemp.valid_key(key) is ok
    assert pkg.idemp.IDEMP_HEADER == "x-shai-idempotency-key"


def _idemp_lifecycle(pkg):
    c = pkg.idemp.IdempotencyCache(max_entries=8)
    st, e = c.begin("k1")
    st2, e2 = c.begin("k1")
    joined = (st2, e2 is e, e2.event.is_set())
    c.complete("k1", {"generated_text": "hi", "n_tokens": 2})
    st3, e3 = c.begin("k1")
    return {"first": st, "joined": joined, "event": e.event.is_set(),
            "state": e.state, "replay": (st3, e3.result),
            "snap": c.snapshot()}


def test_idemp_replay_and_join_lifecycle(pkg):
    r = _idemp_lifecycle(pkg)
    assert r["first"] == "new"
    assert r["joined"] == ("inflight", True, False)
    assert r["event"] and r["state"] == "done"
    assert r["replay"] == ("done", {"generated_text": "hi", "n_tokens": 2})
    snap = r["snap"]
    assert (snap["misses_total"], snap["joined_total"],
            snap["replayed_total"], snap["entries"]) == (1.0, 1.0, 1.0, 1.0)


def test_idemp_failure_clears_claim_so_retry_reexecutes(pkg):
    c = pkg.idemp.IdempotencyCache()
    assert c.begin("k")[0] == "new"
    st2, joined = c.begin("k")
    assert st2 == "inflight"
    c.fail("k")
    assert joined.event.is_set() and joined.state != "done"
    assert c.begin("k")[0] == "new"
    assert c.snapshot()["misses_total"] == 2.0


def _idemp_bounds(pkg):
    now = [0.0]
    c = pkg.idemp.IdempotencyCache(max_entries=3, ttl_s=10.0,
                                   clock=lambda: now[0])
    for i in range(3):
        c.begin(f"k{i}")
        c.complete(f"k{i}", {"i": i})
    c.begin("k3")
    c.complete("k3", {"i": 3})
    out = {"after_cap": c.snapshot(), "victim": c.begin("k0")[0]}
    c.fail("k0")
    now[0] = 11.0
    out["fresh"] = c.begin("fresh")[0]
    out["after_ttl"] = c.snapshot()
    c2 = pkg.idemp.IdempotencyCache(max_entries=2)
    _, e0 = c2.begin("a")
    c2.begin("b")
    c2.begin("c")
    out["inflight_bound"] = (c2.snapshot(), e0.event.is_set(), e0.state)
    return out


def test_idemp_ttl_and_capacity_bounds(pkg):
    r = _idemp_bounds(pkg)
    assert r["after_cap"]["entries"] == 3.0
    assert r["after_cap"]["evicted_total"] == 1.0
    assert r["victim"] == "new"
    assert r["fresh"] == "new" and r["after_ttl"]["entries"] == 1.0
    snap, woke, state = r["inflight_bound"]
    assert snap["entries"] == 2.0 and woke and state == "failed"


def test_idemp_lookup_fault_degrades_to_miss(pkg):
    c = pkg.idemp.IdempotencyCache()
    c.begin("k")
    c.complete("k", {"x": 1})
    pkg.faults.configure("idemp.lookup=error#1")
    try:
        st, _ = c.begin("k")
        assert st == "new"
        c.complete("k", {"x": 2})
    finally:
        pkg.faults.reset()
    st2, e2 = c.begin("k")
    assert st2 == "done" and e2.result == {"x": 2}
    assert c.snapshot()["lookup_errors_total"] == 1.0


# -- tenant budgets, the ledger and the gate's tenant sheds ------------------

def test_budget_grammar_lenient(pkg):
    q = pkg.qos
    b = q.parse_budgets("acme=100:200, free=10 , *=50")
    assert b["acme"] == q.TenantBudget(rate=100.0, burst=200.0)
    assert b["free"] == q.TenantBudget(rate=10.0, burst=10.0)
    assert b["*"].rate == 50.0
    b = q.parse_budgets("good=5,bad,=3,neg=-1,zero=0,also=x:y")
    assert list(b) == ["good"]
    assert q.parse_budgets("") == {}


def _clocked_ledger(q, spec, **kw):
    t = [0.0]
    return q.TenantLedger(q.parse_budgets(spec), clock=lambda: t[0],
                          **kw), t


def test_ledger_debt_and_budget_derived_retry_after(pkg):
    led, t = _clocked_ledger(pkg.qos, "a=10:20")
    assert led.admit("a") is None
    led.charge("a", 50)
    ra = led.admit("a")
    assert ra == pytest.approx((1.0 + 30.0) / 10.0)
    t[0] += ra
    assert led.admit("a") is None
    t[0] += 1e6
    led.charge("a", 21)
    assert led.admit("a") is not None


def test_ledger_unmetered_and_wildcard(pkg):
    led, _ = _clocked_ledger(pkg.qos, "a=5")
    assert led.admit("nobody") is None
    led.charge("nobody", 10**6)
    assert led.admit("nobody") is None
    led, _ = _clocked_ledger(pkg.qos, "*=5:5")
    led.charge("anyone", 6)
    assert led.admit("anyone") is not None
    assert led.metered


def test_ledger_bounded_cardinality_keeps_budgets_enforceable(pkg):
    q = pkg.qos
    led, _ = _clocked_ledger(q, "vip=5:5", max_tenants=2)
    led.note_start("t1")
    led.note_start("t2")
    assert led.label_of("t3-minted") == q.OTHER_TENANT
    assert led.label_of("t4-minted") == q.OTHER_TENANT
    led.note_start("t3-minted")
    assert set(led.snapshot()) <= {"t1", "t2", q.OTHER_TENANT, "vip"}
    led.charge("vip", 6)
    assert led.admit("vip") is not None
    assert led.label_of("vip") == "vip"


def test_ledger_inflight_accounting_thread_counters(pkg):
    led, _ = _clocked_ledger(pkg.qos, "")
    led.note_start("a")
    led.note_start("a")
    led.note_done("a")
    assert led.inflight_of("a") == 1
    led.note_done("a")
    led.note_done("a")
    assert led.inflight_of("a") == 0
    assert led.snapshot()["a"]["requests"] == 2


def test_gate_budget_derived_retry_after_vs_static(pkg):
    led, _ = _clocked_ledger(pkg.qos, "a=10:10")
    gate = pkg.adm.AdmissionGate(ledger=led, retry_after_s=1.0)
    assert gate.check(tenant="a") is None
    led.charge("a", 60)
    shed = gate.check(tenant="a")
    assert (shed.status, shed.reason) == (429, "tenant_budget")
    assert shed.retry_after_s == pytest.approx(51.0 / 10.0)
    assert shed.headers["retry-after"] == "5"
    assert gate.check(tenant="b") is None
    gate2 = pkg.adm.AdmissionGate(max_inflight=1, retry_after_s=1.0,
                                  ledger=led)
    shed2 = gate2.check(inflight=1, tenant="b")
    assert shed2.reason == "inflight" and shed2.retry_after_s == 1.0


def test_gate_tenant_inflight_cap(pkg):
    led, _ = _clocked_ledger(pkg.qos, "")
    gate = pkg.adm.AdmissionGate(ledger=led, tenant_max_inflight=2)
    led.note_start("a")
    led.note_start("a")
    shed = gate.check(tenant="a")
    assert shed is not None and shed.reason == "tenant_inflight"
    assert gate.check(tenant="b") is None
    led.note_done("a")
    assert gate.check(tenant="a") is None


def test_ledger_from_env(pkg, monkeypatch):
    monkeypatch.setenv("SHAI_TENANT_BUDGETS", "acme=4:8,*=2")
    monkeypatch.setenv("SHAI_QOS_MAX_TENANTS", "3")
    led = pkg.qos.TenantLedger.from_env()
    assert led.max_tenants == 3 and led.metered
    assert led.budgets == {"acme": pkg.qos.TenantBudget(4.0, 8.0)}
    assert led.default_budget == pkg.qos.TenantBudget(2.0, 2.0)


# -- scripted parity: equal results, snapshot for snapshot -------------------

def _faults_script(ns):
    inj = ns.faults.FaultInjector(
        "engine.step=delay(0.0)@0.3#4,engine.kv_reserve=error@0.5,"
        "engine.compile=error#1,idemp.lookup=error@0.2", seed=11)
    fired = []
    for _ in range(30):
        fired.append((inj.sleep_at("engine.step") >= 0.0
                      and inj.snapshot()["clauses"][0]["fired"],
                      inj.should_fail("engine.kv_reserve"),
                      inj.should_fail("engine.compile"),
                      inj.should_fail("idemp.lookup")))
    return {"fired": fired, "snapshot": inj.snapshot()}


def _gate_script(ns):
    led, t = _clocked_ledger(ns.qos, "a=10:20,*=5:5", max_tenants=4)
    gate = ns.adm.AdmissionGate(
        ns.cap.OverloadThresholds(max_queue_depth=3.0,
                                  max_kv_utilization=0.8),
        max_inflight=6, ledger=led, tenant_max_inflight=2)
    out = []
    script = [
        ({"waiting": 0.0, "kv_utilization": 0.1}, 0, False, "a"),
        ({"waiting": 5.0, "kv_utilization": 0.1}, 1, False, "b"),
        ({"waiting": 0.0, "kv_utilization": 0.9}, 2, False, "a"),
        ({"waiting": 0.0, "kv_utilization": 0.1}, 6, False, "c"),
        ({"waiting": 0.0, "kv_utilization": 0.1}, 0, True, "a"),
    ]
    for i, (stats, inflight, draining, tenant) in enumerate(script):
        led.note_start(tenant)
        led.charge(tenant, 7 * i)
        t[0] += 0.5
        shed = gate.check(stats, inflight=inflight, draining=draining,
                          lane_width=2, lane_pending=inflight,
                          tenant=tenant)
        out.append(None if shed is None else
                   (shed.status, shed.reason, shed.retry_after_s,
                    shed.headers, shed.detail))
    return {"sheds": out, "by_reason": gate.shed_by_reason(),
            "ledger": led.snapshot()}


def _drain_script(ns):
    clock = FakeClock()
    d = ns.drain.DrainController(budget_s=7.5, clock=clock)
    out = [(d.draining, d.remaining_s, d.begin())]
    for t in (1.0, 3.0, 8.0):
        clock.t = t
        out.append((d.draining, d.remaining_s, d.begin()))
    return out


@pytest.mark.parametrize("script", [
    _faults_script, _gate_script, _drain_script, _watchdog_script,
    _idemp_lifecycle, _idemp_bounds],
    ids=lambda f: f.__name__.strip("_"))
def test_parity_scripted(script):
    def plain(v):
        # entries and events differ by class; compare what they hold
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v

    assert plain(script(PKGS["jax"])) == plain(script(PKGS["torch"]))
