"""The port's observability layer against the JAX package's, on the CPU.

The cases of ``tests/test_obs.py:34-199`` (traceparent, the span tree and
its fuzz, disabled tracing, histograms, the step ring, the flight
recorder) and ``tests/test_conformance.py:41-179,255-327`` (the drift
detector, the HBM ledger, SLO burn, the perf sentinel) run on both
packages (``pkg`` is ``jax`` or ``torch``) with injected clocks; the
``test_parity_*`` cases run one scripted sequence through both and
require equal snapshots. Beside them, the port's own rules: its sentinel
resolves to None with no env even with the repo's ``PERF_MODEL.json``
present (the JAX package's reads that file's TPU projection), and its
``annotate`` is a ``torch.profiler`` range only while a profiler runs.
"""

import json
import random
import threading
import time
import types

import pytest
import torch

from scalable_hw_agnostic_inference_tpu.obs import flight as j_flight
from scalable_hw_agnostic_inference_tpu.obs import hbm as j_hbm
from scalable_hw_agnostic_inference_tpu.obs import sentinel as j_sentinel
from scalable_hw_agnostic_inference_tpu.obs import slo as j_slo
from scalable_hw_agnostic_inference_tpu.obs import steploop as j_steploop
from scalable_hw_agnostic_inference_tpu.obs import trace as j_trace
from scalable_hw_agnostic_inference_tpu_torch.obs import flight as t_flight
from scalable_hw_agnostic_inference_tpu_torch.obs import hbm as t_hbm
from scalable_hw_agnostic_inference_tpu_torch.obs import (
    sentinel as t_sentinel,
)
from scalable_hw_agnostic_inference_tpu_torch.obs import slo as t_slo
from scalable_hw_agnostic_inference_tpu_torch.obs import (
    steploop as t_steploop,
)
from scalable_hw_agnostic_inference_tpu_torch.obs import trace as t_trace

PKGS = {
    "jax": types.SimpleNamespace(flight=j_flight, hbm=j_hbm,
                                 sentinel=j_sentinel, slo=j_slo,
                                 steploop=j_steploop, trace=j_trace),
    "torch": types.SimpleNamespace(flight=t_flight, hbm=t_hbm,
                                   sentinel=t_sentinel, slo=t_slo,
                                   steploop=t_steploop, trace=t_trace),
}
PERF_ENV = ("SHAI_PERF_PROJECTED_TOK_S", "SHAI_PERF_PROJECTION",
            "SHAI_PERF_MODEL", "SHAI_PERF_MIN_CONFORMANCE",
            "SHAI_PERF_WINDOW_S", "SHAI_PERF_MIN_TOKENS")


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# -- trace primitives --------------------------------------------------------

def test_traceparent_parse_and_format(pkg):
    tr = pkg.trace
    tid, sid = "ab" * 16, "cd" * 8
    hdr = tr.format_traceparent(tid, sid)
    assert hdr == f"00-{tid}-{sid}-01"
    assert tr.parse_traceparent(hdr) == (tid, sid)
    assert tr.parse_traceparent(None) is None
    assert tr.parse_traceparent("garbage") is None
    assert tr.parse_traceparent("00-" + "0" * 32 + "-" + sid + "-01") is None
    assert tr.parse_traceparent(f"00-{tid}-{'0' * 16}-01") is None
    assert tr.parse_traceparent(f"ff-{tid}-{sid}-01") is None
    assert tr.parse_traceparent(f"00-{tid}-{sid}-01-extra") is None
    assert tr.parse_traceparent(f"01-{tid}-{sid}-01-extra") == (tid, sid)


def test_span_nesting_builds_tree_via_contextvars(pkg):
    tr = pkg.trace.Trace("root-op")
    with pkg.trace.use_trace(tr):
        with pkg.trace.span("outer") as outer:
            with pkg.trace.span("inner", k=1) as inner:
                assert pkg.trace.current_traceparent().split("-")[2] == \
                    inner.span.span_id
    tr.close()
    d = tr.to_dict()
    assert not pkg.trace.well_formed_problems(d)
    by_name = {s["name"]: s for s in d["spans"]}
    assert by_name["outer"]["parent_id"] == by_name["root-op"]["span_id"]
    assert by_name["inner"]["parent_id"] == by_name["outer"]["span_id"]
    assert by_name["inner"]["attrs"]["k"] == 1
    assert inner.span.closed and outer.span.closed


def test_add_span_from_other_thread_is_safe(pkg):
    tr = pkg.trace.Trace("op")
    t0 = time.monotonic()
    t = threading.Thread(
        target=lambda: tr.add_span("decode", t0, t0 + 0.01, phase=True))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    tr.close()
    d = tr.to_dict()
    assert not pkg.trace.well_formed_problems(d)
    decode = next(s for s in d["spans"] if s["name"] == "decode")
    assert decode["parent_id"] == tr.root.span_id
    assert decode["duration_s"] == pytest.approx(0.01, abs=1e-3)


def test_well_formed_detects_orphans_unclosed_and_multiroot(pkg):
    wf = pkg.trace.well_formed_problems
    assert wf({"spans": []})
    assert any("orphan" in p for p in wf({"spans": [
        {"name": "r", "span_id": "a", "parent_id": None, "duration_s": 0.1},
        {"name": "x", "span_id": "b", "parent_id": "zz", "duration_s": 0.1},
    ]}))
    assert any("unclosed" in p for p in wf({"spans": [
        {"name": "r", "span_id": "a", "parent_id": None,
         "duration_s": -1.0}]}))
    assert any("one root" in p for p in wf({"spans": [
        {"name": "r", "span_id": "a", "parent_id": None, "duration_s": 0.1},
        {"name": "q", "span_id": "b", "parent_id": None, "duration_s": 0.1},
    ]}))
    tr = pkg.trace.Trace("op")
    tr.span("leaky").__enter__()  # never exited
    tr.close()
    assert any("force-closed" in p for p in wf(tr.to_dict()))


def test_span_tree_fuzz_always_well_formed(pkg):
    rng = random.Random(1337)
    for trial in range(30):
        tr = pkg.trace.Trace(f"op-{trial}")

        def nested(depth):
            if depth <= 0 or rng.random() < 0.3:
                return
            try:
                with pkg.trace.span(f"d{depth}-{rng.randrange(4)}"):
                    if rng.random() < 0.2:
                        raise ValueError("handler blew up mid-span")
                    nested(depth - 1)
            except ValueError:
                pass

        def engine_side():
            t0 = time.monotonic()
            for i in range(rng.randrange(1, 4)):
                tr.add_span(f"phase{i}", t0, t0 + rng.random() * 0.01)
            if rng.random() < 0.5:
                tr.add_phase_spans({"t_submit": t0, "t_admit": t0 + 0.001,
                                    "t_first": t0 + 0.002,
                                    "t_done": t0 + 0.003})

        with pkg.trace.use_trace(tr):
            threads = [threading.Thread(target=engine_side)
                       for _ in range(rng.randrange(0, 3))]
            for t in threads:
                t.start()
            nested(rng.randrange(1, 6))
            for t in threads:
                t.join(timeout=10)
        tr.close()
        assert not pkg.trace.well_formed_problems(tr.to_dict()), trial


def test_tracing_disabled_is_off_the_hot_path(pkg):
    tr = pkg.trace
    tr.configure(False)
    try:
        assert tr.begin_request_trace("x") is None
        s = tr.span("y")
        assert s is tr.NOOP
        with s:
            pass
        assert tr.annotate("z") is tr.NOOP
        tr.configure(True)
        assert tr.current_trace() is None
        assert tr.span("y") is tr.NOOP
    finally:
        tr.configure(True)


def test_begin_request_trace_continues_the_callers_trace(pkg):
    tid, sid = "12" * 16, "34" * 8
    tr = pkg.trace.begin_request_trace(
        "POST /generate", f"00-{tid}-{sid}-01", method="POST")
    assert tr.trace_id == tid and tr.remote_parent == sid
    assert tr.traceparent.startswith(f"00-{tid}-")
    fresh = pkg.trace.begin_request_trace("GET /", "garbage")
    assert fresh.trace_id != tid and fresh.remote_parent is None


def test_port_annotate_enters_a_profiler_range_only_while_profiling():
    # no profiler session: nothing is entered (the shared no-op)
    assert t_trace.annotate("engine.decode") is t_trace.NOOP
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t_trace.annotate("engine.decode"):
            torch.ones(4).add_(1)
        tr = t_trace.Trace("op")
        with t_trace.use_trace(tr), t_trace.span("tokenize"):
            torch.ones(4).mul_(2)
    names = {e.key for e in prof.key_averages()}
    assert {"engine.decode", "tokenize"} <= names
    assert t_trace.annotate("engine.decode") is t_trace.NOOP


# -- step telemetry and the flight recorder ----------------------------------

def test_bucket_histogram_cumulative_shape(pkg):
    h = pkg.steploop.BucketHistogram((0.1, 1.0))
    for v in (0.05, 0.5, 0.7, 5.0):
        h.observe(v)
    s = h.snapshot()
    assert s["count"] == 4
    assert s["sum"] == pytest.approx(6.25)
    assert s["buckets"] == [(0.1, 1), (1.0, 3), ("+Inf", 4)]


def test_step_telemetry_ring_is_bounded(pkg):
    t = pkg.steploop.StepTelemetry(total_blocks=10, max_steps=4)
    for i in range(9):
        t.record_step(kind="decode", duration_s=0.01, n_running=1,
                      n_waiting=i, n_chunking=0, blocks_free=5)
    recs = t.recent_steps()
    assert len(recs) == 4
    assert recs[-1]["step"] == 9 and recs[-1]["waiting"] == 8
    assert recs[-1]["kv_utilization"] == 0.5
    snap = t.snapshot()
    assert snap["steps"] == 9 and snap["waiting"] == 8.0
    t.count_preemption()
    t.count_recompile("decode")
    snap = t.snapshot()
    assert snap["preemptions"] == 1 and snap["recompiles"] == 1
    assert t.step_duration_p99() == 0.01


def test_flight_recorder_ring_and_dump(pkg):
    fr = pkg.flight.FlightRecorder(max_requests=3, max_steps=2)
    for i in range(5):
        fr.record_request({"trace_id": f"t{i}", "spans": []})
    d = fr.dump(step_source=lambda n: [{"step": 1}][:n])
    assert d["recorded_total"] == 5
    assert [r["trace"]["trace_id"] for r in d["requests"]] == \
        ["t2", "t3", "t4"]
    assert [r["trace_id"] for r in d["requests"]] == ["t2", "t3", "t4"]
    assert d["engine_steps"] == [{"step": 1}]
    assert fr.traces_for("t3") == [{"trace_id": "t3", "spans": []}]
    assert fr.traces_for("t0") == []   # evicted with its ring slot

    def boom(n):
        raise RuntimeError("engine gone")

    d = fr.dump(step_source=boom)
    assert "engine gone" in d["engine_steps_error"]
    assert d["requests"]
    assert fr.dump(n_requests=0)["requests"] == []
    assert len(fr.dump(n_requests=99)["requests"]) == 3


def test_port_watchdog_clock_is_the_last_retired_step():
    """A step that returns with a replay in flight stamps the watchdog's
    clock with its last readback, never later; the stamp never moves
    back."""
    t = t_steploop.StepTelemetry(total_blocks=4)
    base = time.monotonic()
    now = base + 10.0
    kw = dict(kind="decode", duration_s=0.01, n_running=1, n_waiting=0,
              n_chunking=0, blocks_free=2)
    t.record_step(completed_at=base + 5.0, **kw)
    assert t.last_step_age_s(now=now) == pytest.approx(5.0)
    t.record_step(completed_at=base + 9.0, **kw)
    assert t.last_step_age_s(now=now) == pytest.approx(1.0)
    t.record_step(completed_at=base + 7.0, **kw)   # an older readback
    assert t.last_step_age_s(now=now) == pytest.approx(1.0)
    t2 = t_steploop.StepTelemetry(total_blocks=4)
    t2.record_step(**kw)                           # completed at return
    assert t2.last_step_age_s() < 0.5


# -- HBM ledger --------------------------------------------------------------

def test_drift_detector_flags_monotonic_growth(pkg):
    d = pkg.hbm.DriftDetector(window=2, windows_needed=3, min_growth=10)
    flagged = False
    for v in (0, 0, 100, 100, 200, 200, 300, 300):
        flagged = d.feed(("idle",), v)
    assert flagged and d.leak_suspect
    assert d.leak_composition == ("idle",)
    d.feed(("idle",), 300)
    assert d.leak_suspect


def test_drift_detector_silent_on_flat_noise_and_survives_interleaving(pkg):
    d = pkg.hbm.DriftDetector(window=2, windows_needed=3, min_growth=10)
    for v in (50, 50, 51, 49, 55, 45, 50, 50, 52, 48):
        assert not d.feed(("idle",), v)
    d2 = pkg.hbm.DriftDetector(window=2, windows_needed=2, min_growth=10)
    flagged = False
    for comp, v in [(("idle",), 0), (("idle",), 0), (("busy",), 999),
                    (("busy",), 1234), (("idle",), 100), (("idle",), 100)]:
        flagged = d2.feed(comp, v)
    assert flagged


def test_hbm_ledger_accounting_and_fallback(pkg):
    led = pkg.hbm.HbmLedger(bytes_limit=1000.0, window=2, windows_needed=2,
                            min_growth=1)
    led.sample(pools={"weights": 600, "kv_pool": 200}, composition=(0,),
               drift_value=0.0)
    s = led.snapshot()
    assert s["weights_bytes"] == 600 and s["kv_pool_bytes"] == 200
    assert s["used_bytes"] == 800 and s["attributed_bytes"] == 800
    assert s["headroom_bytes"] == 200
    assert s["device_stats"] == 0.0 and s["unattributed_bytes"] == 0.0
    led.sample(pools={"weights": 600, "kv_pool": 200}, composition=(0,),
               bytes_in_use=900, largest_free=50, drift_value=100.0,
               extra={"kv_used_bytes": 10})
    s = led.snapshot()
    assert s["device_stats"] == 1.0
    assert s["unattributed_bytes"] == 100
    assert s["headroom_bytes"] == 100
    assert s["fragmentation_ratio"] == pytest.approx(0.5)
    assert s["kv_used_bytes"] == 10
    assert s["leak_suspect"] == 0.0


def test_hbm_ledger_leak_flag_reaches_snapshot(pkg):
    led = pkg.hbm.HbmLedger(bytes_limit=0.0, window=1, windows_needed=2,
                            min_growth=1)
    for drift in (0, 100, 200):
        led.sample(pools={"kv_pool": 100}, composition=(0, 0, 0),
                   drift_value=drift)
    assert led.leak_suspect
    assert led.snapshot()["leak_suspect"] == 1.0


# -- SLO burn ----------------------------------------------------------------

def test_slo_fast_and_slow_burn_breach(pkg):
    clk = Clock()
    eng = pkg.slo.SloEngine(pkg.slo.SloTargets(
        ttft_ms=100.0, budget_frac=0.01, min_events=10), clock=clk)
    for _ in range(20):
        eng.record_ttft(0.01)
    s = eng.snapshot()
    assert s["ttft_fast_burn"] == 0.0 and s["breach"] == 0.0
    for _ in range(20):
        clk.t += 1.0
        eng.record_ttft(0.5)
    s = eng.snapshot()
    assert s["ttft_fast_burn"] == pytest.approx(50.0)
    assert s["ttft_slow_burn"] == pytest.approx(50.0)
    assert s["ttft_breach"] == 1.0 and s["breach"] == 1.0
    clk.t += 600.0
    for _ in range(15):
        eng.record_ttft(0.01)
    s = eng.snapshot()
    assert s["ttft_fast_burn"] == 0.0
    assert s["ttft_slow_burn"] > 1.0
    assert s["breach"] == 0.0


def test_slo_min_events_gate_and_error_objective(pkg):
    eng = pkg.slo.SloEngine(pkg.slo.SloTargets(error_rate=0.05,
                                               min_events=10), clock=Clock())
    for _ in range(3):
        eng.record_outcome("timeout")
    s = eng.snapshot()
    assert s["error_fast_burn"] > 1.0 and s["error_breach"] == 0.0
    eng.record_outcome("cancelled")
    assert eng.snapshot()["error_events"] == 3.0
    for _ in range(8):
        eng.record_outcome("rejected")
    assert eng.snapshot()["error_breach"] == 1.0
    for _ in range(300):
        eng.record_outcome("eos")
    assert eng.snapshot()["error_fast_burn"] < 14.4


def test_env_knobs_are_lenient_not_boot_crashes(pkg, monkeypatch):
    monkeypatch.setenv("SHAI_HBM_WINDOW", "8.5")
    monkeypatch.setenv("SHAI_HBM_WINDOWS", "oops")
    led = pkg.hbm.HbmLedger()
    assert led._drift.window == 8 and led._drift.windows_needed == 4
    monkeypatch.setenv("SHAI_SLO_TTFT_MS", "fast")
    assert pkg.slo.SloEngine.maybe_from_env(None) is None
    monkeypatch.setenv("SHAI_PERF_PROJECTED_TOK_S", "warp")
    assert pkg.sentinel.PerfSentinel.from_env() is None


def test_slo_targets_env_overrides_unit_config(pkg, monkeypatch):
    base = pkg.slo.SloTargets(ttft_ms=500.0)
    monkeypatch.setenv("SHAI_SLO_TTFT_MS", "250")
    monkeypatch.setenv("SHAI_SLO_MIN_EVENTS", "3")
    t = pkg.slo.SloTargets.from_env(base)
    assert t.ttft_ms == 250.0 and t.min_events == 3
    monkeypatch.delenv("SHAI_SLO_TTFT_MS")
    monkeypatch.delenv("SHAI_SLO_MIN_EVENTS")
    assert pkg.slo.SloEngine.maybe_from_env(None) is None
    assert pkg.slo.SloEngine.maybe_from_env(base) is not None


# -- perf sentinel -----------------------------------------------------------

def test_sentinel_conformance_and_degraded_transition(pkg):
    clk = Clock()
    sen = pkg.sentinel.PerfSentinel(1000.0, min_conformance=0.8,
                                    window_s=60.0, min_tokens=8, clock=clk)
    for _ in range(4):
        clk.t += 0.01
        assert not sen.record_step(kind="decode", duration_s=0.004,
                                   tokens=4)
    s = sen.snapshot()
    assert s["conformance"] == pytest.approx(1.0, rel=0.01)
    assert s["degraded"] == 0.0
    assert not sen.record_step(kind="idle", duration_s=5.0, tokens=0)
    assert sen.snapshot()["window_busy_s"] == pytest.approx(0.016)
    clk.t += 120.0
    flipped = []
    for _ in range(4):
        clk.t += 0.1
        flipped.append(sen.record_step(kind="spec", duration_s=0.04,
                                       tokens=4))
    assert flipped.count(True) == 1
    s = sen.snapshot()
    assert s["conformance"] == pytest.approx(0.1, rel=0.05)
    assert s["degraded"] == 1.0
    sen.diagnose({"step_gap_mean_ms": 1.0})
    assert sen.diagnoses == 1
    clk.t += 120.0
    s = sen.snapshot()
    assert s["window_tokens"] == 0.0
    assert s["conformance"] == 1.0 and s["degraded"] == 0.0


def test_sentinel_needs_min_tokens_before_degrading(pkg):
    clk = Clock()
    sen = pkg.sentinel.PerfSentinel(1000.0, min_tokens=100, clock=clk)
    clk.t += 1.0
    assert not sen.record_step(kind="decode", duration_s=1.0, tokens=1)
    s = sen.snapshot()
    assert s["degraded"] == 0.0
    assert s["conformance"] == 1.0
    assert s["live_per_s"] == 1.0


def test_sentinel_from_env_resolution(pkg, tmp_path, monkeypatch):
    for k in PERF_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SHAI_PERF_PROJECTED_TOK_S", "123.5")
    sen = pkg.sentinel.PerfSentinel.from_env()
    assert sen is not None and sen.projected_per_s == 123.5
    monkeypatch.delenv("SHAI_PERF_PROJECTED_TOK_S")
    pm = tmp_path / "projections.json"
    pm.write_text(json.dumps({"projections": {
        "llama1b_gen": {"work_unit": "tokens", "projected_per_s": 377.2}}}))
    monkeypatch.setenv("SHAI_PERF_MODEL", str(pm))
    monkeypatch.setenv("SHAI_PERF_PROJECTION", "llama1b_gen")
    sen = pkg.sentinel.PerfSentinel.from_env()
    assert sen is not None and sen.projected_per_s == pytest.approx(377.2)
    assert sen.key == "llama1b_gen"
    monkeypatch.setenv("SHAI_PERF_PROJECTION", "no_such_key")
    assert pkg.sentinel.PerfSentinel.from_env() is None
    monkeypatch.delenv("SHAI_PERF_PROJECTION")
    assert pkg.sentinel.PerfSentinel.from_env(default_key="") is None


def test_port_sentinel_takes_no_projection_unless_given(monkeypatch):
    """With no env the port's sentinel is None, even though the repo's
    ``PERF_MODEL.json`` (TPU projections) sits beside the packages and the
    JAX package's sentinel resolves the same key from it."""
    for k in PERF_ENV:
        monkeypatch.delenv(k, raising=False)
    assert j_sentinel.load_projections().get("llama1b_gen")
    jsen = j_sentinel.PerfSentinel.from_env(default_key="llama1b_gen")
    assert jsen is not None and jsen.projected_per_s > 0
    assert t_sentinel.perf_model_path() is None
    assert t_sentinel.load_projections() == {}
    assert t_sentinel.PerfSentinel.from_env(
        default_key="llama1b_gen") is None
    key = t_sentinel.default_projection_key("llama-1b-geometry")
    assert t_sentinel.PerfSentinel.from_env(default_key=key) is None


@pytest.mark.parametrize("model,kw,want", [
    ("meta-llama/Llama-3.2-1B", {}, "llama1b_gen"),
    ("llama-1b-geometry", {"quantized": True}, "llama1b_int8_gen"),
    ("llama-3b-geometry", {}, "llama3b_gen"),
    ("Llama-3.2-11B-Vision", {}, "mllama_decode_b1_tpot"),
    ("llama-70b", {"tp": 8}, "vllm_decode_70b_tp8_tpot"),
    ("llama-70b", {"tp": 1}, ""),
    ("tiny", {}, "")])
def test_default_projection_key_heuristics(pkg, model, kw, want):
    assert pkg.sentinel.default_projection_key(model, **kw) == want


# -- scripted parity: equal snapshots ----------------------------------------

def _telemetry_script(ns):
    t = ns.steploop.StepTelemetry(total_blocks=16, max_steps=5)
    for i in range(7):
        t.record_step(kind="decode" if i % 3 else "idle",
                      duration_s=0.001 * (i + 1), n_running=i % 4,
                      n_waiting=7 - i, n_chunking=i % 2,
                      blocks_free=16 - 2 * i, finished=i % 2,
                      finished_ids=[i] if i % 2 else [],
                      tenants={"a": (i, 1), "": (0, i % 3)})
        t.count_pad(10 * i, i, phase="decode")
        t.count_flush("admission" if i % 2 else "idle")
        t.ttft.observe(0.01 * i)
        t.count_tenant_request("a" if i % 2 else "", "normal")
        t.note_tenant_ttft("a", 0.02 * i)
    steps = [{k: v for k, v in r.items() if k != "ts"}
             for r in t.recent_steps()]
    return {"snapshot": t.snapshot(), "steps": steps,
            "p99": t.step_duration_p99(), "tenants": t.tenant_snapshot(),
            "tenant_hists": t.tenant_histograms(),
            "pad": t.pad_phase_snapshot(), "hists": t.histograms(),
            "flushes": t.flush_reasons()}


def _hbm_script(ns):
    led = ns.hbm.HbmLedger(bytes_limit=10_000.0, window=2, windows_needed=3,
                           min_growth=5)
    out = []
    for i in range(10):
        led.sample(pools={"weights": 4000, "kv_pool": 2000,
                          "resident": 10 * i, "inflight": 0},
                   composition=(i % 2, 0, 0),
                   bytes_in_use=6500 + 40 * i if i % 3 else None,
                   peak_bytes=7000, largest_free=1000 if i % 2 else None,
                   drift_value=25.0 * i,
                   extra={"kv_used_bytes": 100 * i})
        out.append(led.snapshot())
    return out


def _slo_script(ns):
    clk = Clock()
    eng = ns.slo.SloEngine(ns.slo.SloTargets(
        ttft_ms=50.0, tpot_ms=5.0, error_rate=0.02, min_events=4),
        clock=clk)
    out = []
    for i in range(40):
        clk.t += 7.0
        eng.record_ttft(0.01 * (i % 9))
        eng.record_tpot(0.001 * (i % 11))
        eng.record_outcome(("eos", "timeout", "length", "cancelled",
                            "rejected")[i % 5])
        if i % 8 == 0:
            out.append(eng.snapshot())
    return out


def _sentinel_script(ns):
    clk = Clock()
    sen = ns.sentinel.PerfSentinel(200.0, min_conformance=0.8,
                                   window_s=5.0, min_tokens=16, clock=clk)
    out = []
    for i in range(30):
        clk.t += 0.4
        flipped = sen.record_step(kind=("decode", "idle", "spec")[i % 3],
                                  duration_s=0.01 * (1 + i % 7),
                                  tokens=4)
        out.append((flipped, sen.snapshot(), sen.degraded))
    return out


def _flight_script(ns):
    fr = ns.flight.FlightRecorder(max_requests=4, max_steps=3)
    for i in range(7):
        fr.record_request({"trace_id": f"t{i % 3}", "spans": [i]})
    d = fr.dump(step_source=lambda n: list(range(10))[:n], n_requests=3)
    for r in d["requests"]:
        r.pop("recorded_at")
    return {"dump": d, "t1": fr.traces_for("t1"), "n": fr.n_recorded}


@pytest.mark.parametrize("script", [
    _telemetry_script, _hbm_script, _slo_script, _sentinel_script,
    _flight_script], ids=lambda f: f.__name__.strip("_"))
def test_parity_scripted(script):
    assert script(PKGS["jax"]) == script(PKGS["torch"])
