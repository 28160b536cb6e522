"""The operating layer's engine hooks on the ``tiny`` engine, on the CPU,
port and JAX package side by side.

After ``tests/test_conformance.py:418-521`` and ``tests/test_obs.py:227-330``,
each case runs on both engines (``side`` is ``jax`` or ``torch``; the same
flax weights, the port reading them through ``params_from_jax``):

- a KV block leaked on every release flags the HBM ledger, the same
  traffic released correctly stays silent;
- an ``engine.step`` delay degrades the perf sentinel, once;
- unit-config SLO targets reach the engine and breach (or not) on real
  traffic;
- step records carry the finished request ids;
- the preemption timing cases: one timeline across a preemption, a
  resume booked from the request's own first token, a rejected request's
  wait booked as queue;
- ``engine.compile`` fires before the function is built: on the port,
  before its graph is captured (the capture is spied on), so no capture
  is ever left open;
- ``engine.kv_reserve`` rejects a request terminally when nothing runs.

Beside them, port-only: the async step's record stamps the watchdog's
clock with its last readback, and the HBM tick feeds the ledger host
numbers only.
"""

import dataclasses
import time

import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
)
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    Request as JRequest,
)
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.resilience import faults as jfaults
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine import graphs
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    Request,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.resilience import faults

ENGINE_KW = dict(max_model_len=64, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16)
ENV = ("SHAI_HBM_WINDOW", "SHAI_HBM_WINDOWS", "SHAI_HBM_MIN_GROWTH",
       "SHAI_PERF_PROJECTED_TOK_S", "SHAI_PERF_MIN_TOKENS",
       "SHAI_SLO_MIN_EVENTS", "SHAI_SLO_TTFT_MS", "SHAI_FAULTS")


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


class Side:
    """One package's engine factory and its classes."""

    def __init__(self, name, tiny):
        self.name = name
        jcfg, params, tcfg, model = tiny
        if name == "jax":
            self.faults, self.Params, self.Request = jfaults, JParams, JRequest
            self._make = lambda kw: JEngine(jcfg, params,
                                            jconfig.EngineConfig(**kw))
        else:
            self.faults, self.Params, self.Request = (faults, SamplingParams,
                                                      Request)
            self._make = lambda kw: LLMEngine(
                tcfg, model, tconfig.EngineConfig(**kw), device="cpu")

    def engine(self, **over):
        return self._make(dict(ENGINE_KW, **over))


@pytest.fixture(params=["jax", "torch"])
def side(request, tiny, monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    s = Side(request.param, tiny)
    s.faults.reset()
    yield s
    s.faults.reset()


def _run_requests(side, eng, n, prompt=(1, 5, 9, 11), max_new=6,
                  idle_steps=2):
    for _ in range(n):
        [fin] = eng.generate([list(prompt)], side.Params(
            temperature=0.0, max_new_tokens=max_new))
        assert fin.stop_reason == "length"
        for _ in range(idle_steps):   # quiescent samples between bursts
            eng.step()


def test_engine_hbm_leak_detector_flags_kv_block_leak(side, monkeypatch):
    monkeypatch.setenv("SHAI_HBM_WINDOW", "2")
    monkeypatch.setenv("SHAI_HBM_WINDOWS", "2")
    monkeypatch.setenv("SHAI_HBM_MIN_GROWTH", "1")
    eng = side.engine()
    _run_requests(side, eng, 3)
    snap = eng.obs.hbm.snapshot()
    assert snap["kv_leaked_bytes"] == 0.0 and snap["kv_used_bytes"] == 0.0
    assert snap["leak_suspect"] == 0.0 and snap["samples"] > 0
    assert snap["weights_bytes"] > 0 and snap["kv_pool_bytes"] > 0
    assert snap["device_stats"] == 0.0   # the CPU: the accounted view
    eng = side.engine()
    cache = eng.cache

    def leaky_release(seq_id):
        alloc = cache._seqs.pop(seq_id)
        cache.allocator.free(alloc.blocks[1:])  # block [0] never freed

    monkeypatch.setattr(cache, "release", leaky_release)
    _run_requests(side, eng, 4)
    snap = eng.obs.hbm.snapshot()
    assert snap["kv_leaked_bytes"] > 0.0
    assert snap["leak_suspect"] == 1.0, snap
    assert eng.obs.hbm.leak_suspect


def test_engine_sentinel_degrades_under_slowed_step_loop(side, monkeypatch):
    monkeypatch.setenv("SHAI_PERF_PROJECTED_TOK_S", "50")
    monkeypatch.setenv("SHAI_PERF_MIN_TOKENS", "4")
    eng = side.engine()
    assert eng.obs.sentinel is not None
    # warm the executables first: a step that built one is warmup and
    # stays out of the window on both engines
    _run_requests(side, eng, 1, max_new=8, idle_steps=0)
    eng = side.engine()
    try:
        side.faults.configure("engine.step=delay(0.1)")
        _run_requests(side, eng, 1, max_new=8, idle_steps=0)
    finally:
        side.faults.reset()
    s = eng.obs.sentinel.snapshot()
    assert s["window_tokens"] >= 4
    assert s["conformance"] < 0.8 and s["degraded"] == 1.0, s
    assert eng.obs.sentinel.diagnoses == 1


def test_engine_sentinel_conformant_when_healthy(side, monkeypatch):
    # a projection any healthy engine meets, even on a CPU shared by
    # several test workers (the tiny engine there can take 0.4 s a step)
    monkeypatch.setenv("SHAI_PERF_PROJECTED_TOK_S", "0.2")
    monkeypatch.setenv("SHAI_PERF_MIN_TOKENS", "4")
    eng = side.engine()
    # first calls pay one-time costs on a loaded CPU: warm, then a fresh
    # window over warm steps only
    _run_requests(side, eng, 1, max_new=8, idle_steps=0)
    eng.obs.sentinel = type(eng.obs.sentinel).from_env()
    _run_requests(side, eng, 2, max_new=8, idle_steps=0)
    s = eng.obs.sentinel.snapshot()
    assert s["window_tokens"] >= 4
    assert s["conformance"] > 0.8 and s["degraded"] == 0.0, s


def test_engine_slo_wired_end_to_end(side, monkeypatch):
    monkeypatch.setenv("SHAI_SLO_MIN_EVENTS", "2")
    eng = side.engine(slo_ttft_ms=10_000.0)
    _run_requests(side, eng, 2, idle_steps=0)
    s = eng.obs.slo.snapshot()
    assert s["ttft_events"] >= 2.0 and s["breach"] == 0.0
    eng = side.engine(slo_ttft_ms=0.000001)
    _run_requests(side, eng, 2, idle_steps=0)
    s = eng.obs.slo.snapshot()
    assert s["ttft_fast_burn"] >= 14.4 and s["breach"] == 1.0
    assert side.engine().obs.slo is None


def test_engine_step_records_carry_finished_ids(side):
    eng = side.engine()
    [fin] = eng.generate([[1, 5, 9, 11]], side.Params(temperature=0.0,
                                                      max_new_tokens=4))
    recs = eng.obs.recent_steps()
    finishing = [r for r in recs if r["finished_ids"]]
    assert finishing and fin.req_id in finishing[-1]["finished_ids"]
    assert {r["kind"] for r in recs} <= {"decode", "idle"}
    snap = eng.obs.snapshot()
    assert snap["steps"] == len(recs) == eng._step_count
    assert snap["ttft_count"] == 1 and snap["queue_wait_count"] == 1
    t = fin.timing
    assert t["queue_s"] >= 0 and t["prefill_s"] >= 0 and t["decode_s"] >= 0
    assert t["total_s"] == pytest.approx(t["t_done"] - t["t_submit"],
                                         abs=1e-4)


def test_preemption_path_counts_and_keeps_timing(side):
    eng = side.engine(num_blocks=7)
    prompts = [[1, 5, 9, 11], [1, 200, 300], [2, 7, 9, 13, 15]]
    fins = eng.generate(prompts, side.Params(temperature=0.0,
                                             max_new_tokens=16))
    assert [f.stop_reason for f in fins] == ["length"] * 3
    assert all(len(f.token_ids) == 16 for f in fins)
    assert eng.obs.preemptions >= 1
    assert eng.obs.recent_steps()[-1]["preemptions_total"] == \
        eng.obs.preemptions
    for f in fins:
        t = f.timing
        assert t["t_done"] >= t["t_first"] >= t["t_admit"] >= t["t_submit"]


def test_resumed_request_timing_uses_original_first_token(side):
    eng = side.engine()
    now = time.monotonic()
    req = side.Request(0, [1, 2, 3], side.Params(max_new_tokens=4),
                       already_generated=[5, 6], t_submit=now - 10.0,
                       t_admit=now - 9.5, t_first=now - 9.0)
    t = eng._timing_of(req, t_first=now - 1.0)
    assert t["t_first"] == req.t_first
    assert t["prefill_s"] == pytest.approx(0.5, abs=0.1)
    assert t["decode_s"] >= 8.9


def test_rejected_request_books_wait_as_queue_not_decode(side):
    eng = side.engine(num_blocks=4, max_num_seqs=1)
    [fin] = eng.generate([[1] * 32], side.Params(max_new_tokens=4))
    assert fin.stop_reason == "rejected"
    t = fin.timing
    assert t["prefill_s"] == 0.0 and t["decode_s"] == 0.0
    assert t["queue_s"] == pytest.approx(t["total_s"], abs=1e-4)


def test_kv_reserve_fault_rejects_terminally_when_idle(side):
    """``engine.kv_reserve``: the injected dry pool takes the real
    ladder; with nothing running the request is rejected, and the next
    one (fault spent) serves."""
    eng = side.engine()
    side.faults.configure("engine.kv_reserve=error#1")
    [fin] = eng.generate([[1, 5, 9]], side.Params(temperature=0.0,
                                                  max_new_tokens=4))
    assert fin.stop_reason == "rejected" and fin.token_ids == []
    [ok] = eng.generate([[1, 5, 9]], side.Params(temperature=0.0,
                                                 max_new_tokens=4))
    assert ok.stop_reason == "length" and len(ok.token_ids) == 4
    snap = side.faults.get().snapshot()["clauses"][0]
    assert snap["fired"] == 1 and snap["draws"] >= 2
    assert eng.cache.leaked_blocks == 0


def test_step_fault_raises_out_of_step(side):
    eng = side.engine()
    eng.add_request([1, 5, 9], side.Params(max_new_tokens=2))
    side.faults.configure("engine.step=error#1")
    with pytest.raises(side.faults.FaultError):
        eng.step()
    side.faults.reset()
    done = []
    while eng.has_work:
        done += eng.step()
    assert [f.stop_reason for f in done] == ["length"]


def test_compile_fault_fires_before_the_build(side):
    """An ``engine.compile`` error at a decode key's first build leaves no
    executable behind; on the port, no graph was constructed or captured,
    so a capture can never be left open. The retry builds it."""
    eng = side.engine()
    side.faults.configure("engine.compile=error#1")
    with pytest.raises(side.faults.FaultError):
        eng._decode_for(1, 2)
    side.faults.reset()
    assert eng.n_executables == 0
    eng._decode_for(1, 2)
    assert eng.n_executables == 1


def test_port_compile_site_precedes_graph_capture(tiny, monkeypatch):
    """The site fires before ``DecodeGraph`` is built and before its
    ``capture`` (where ``torch.cuda.graph`` opens on the card), for the
    decode keys and the fused keys alike, and in the warmup that builds
    the closed set."""
    events = []
    real_init = graphs.DecodeGraph.__init__
    real_capture = graphs.DecodeGraph.capture

    def spy_init(self, key, *a, **kw):
        events.append(("build", key))
        real_init(self, key, *a, **kw)

    def spy_capture(self):
        events.append(("capture", self.key))
        real_capture(self)

    monkeypatch.setattr(graphs.DecodeGraph, "__init__", spy_init)
    monkeypatch.setattr(graphs.DecodeGraph, "capture", spy_capture)
    side = Side("torch", tiny)
    faults.reset()
    try:
        for env in ({}, {"SHAI_RAGGED_ATTENTION": "1",
                         "SHAI_FUSED_STEP": "1"}):
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            eng = side.engine()
            events.clear()
            faults.configure("engine.compile=error")
            with pytest.raises(faults.FaultError):
                eng.warm_executables()
            with pytest.raises(faults.FaultError):
                eng._decode_for(1, 2)
            assert events == [] and eng.n_executables == 0
            faults.reset()
            eng.warm_executables()
            builds = [k for e, k in events if e == "build"]
            assert builds and [k for e, k in events if e == "capture"] == \
                builds
    finally:
        faults.reset()


def test_port_async_record_stamps_the_last_readback(tiny, monkeypatch):
    """A steady async step returns with the next replay in flight: its
    record stamps the watchdog's clock with the readback it retired, not
    with its own return."""
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1")
    eng = Side("torch", tiny).engine()
    eng.add_request([1, 5, 9, 11], SamplingParams(temperature=0.0,
                                                  max_new_tokens=8))
    stamps = []
    real = eng.obs.record_step

    def spy(**kw):
        stamps.append((kw["completed_at"], eng._pipe is not None,
                       eng._t_fetch))
        real(**kw)

    eng.obs.record_step = spy
    while eng.has_work:
        eng.step()
    in_flight = [(c, f) for c, p, f in stamps if p]
    assert in_flight and all(c == f for c, f in in_flight)
    assert all(c is None for c, p, _ in stamps if not p)


def test_port_hbm_tick_reads_host_numbers_only(tiny):
    """On the CPU the tick attributes the pools from the engine's own
    tensors; the graph pool and split scratch ride ``extra`` (0 here) and
    the resident pool is the decode graphs' static inputs."""
    eng = Side("torch", tiny).engine()
    eng.generate([[1, 5, 9, 11]], SamplingParams(temperature=0.0,
                                                 max_new_tokens=4))
    snap = eng.obs.hbm.snapshot()
    weights = sum(p.nbytes for p in eng.model.parameters())
    assert snap["weights_bytes"] == weights
    assert snap["kv_pool_bytes"] == eng.cache.pool_bytes
    assert snap["resident_bytes"] == sum(
        sum(t.nbytes for t in g.inputs.values()) + g.uniforms.nbytes
        for g in eng._decode_fns.values()) > 0
    assert snap["graph_pool_bytes"] == snap["split_scratch_bytes"] == 0.0
    assert snap["used_bytes"] == snap["attributed_bytes"]
    assert snap["limit_bytes"] == 0.0 and isinstance(eng.obs.hbm.bytes_limit,
                                                     float)
    assert torch.is_tensor(eng.cache.kv[0]["k"])
