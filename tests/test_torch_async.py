"""The port's async pipelined decode against its lock-step oracle and the
JAX engine, on the CPU.

Port of ``tests/test_engine_async.py``. ``SHAI_ASYNC_DECODE=1`` (the
default) pipelines decode one step ahead of the host readback, with the
batch inputs resident in the decode graphs' static buffers and step N's
tokens fed back on the device; it must be TOKEN-EXACT against the port's
lock-step path (``SHAI_ASYNC_DECODE=0``): the same token streams, stop
reasons and streaming order, and a whole pool, over every scheduling shape
here. Both disciplines draw their uniforms from one generator in the same
order, so sampled rows are exact between them too; against the JAX engine
(same weights, ``params_from_jax``) sampled rows agree in distribution
only (``tests/test_torch_ops.py``), and greedy rows are held with
``tests/parity.py``'s ``assert_greedy_parity`` (equal, or diverging only
at a bf16 tie of the reference's top-2 logits), against both of the JAX
engine's disciplines; the JAX engine decodes through its Pallas paged
kernel in interpret mode (``SHAI_PAGED_DECODE=1``), as
``tests/test_torch_engine.py`` runs it.
"""

import dataclasses
import logging
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.resident import (
    ResidentBatch,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ENGINE_KW = dict(max_model_len=64, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


def _port(tiny, monkeypatch, async_on, env=(), **over):
    _, _, tcfg, model = tiny
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_on else "0")
    for k, v in dict(env).items():
        monkeypatch.setenv(k, v)
    eng = LLMEngine(tcfg, model,
                    tconfig.EngineConfig(**dict(ENGINE_KW, **over)),
                    device="cpu")
    assert eng._async is async_on
    return eng


def _jax(tiny, monkeypatch, async_on, env=(), **over):
    jcfg, params, _, _ = tiny
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_on else "0")
    # the Pallas paged-decode kernel in interpret mode: the decode path the
    # port's B2 follows, as the other engine parity tests run it
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    for k, v in dict(env).items():
        monkeypatch.setenv(k, v)
    eng = JEngine(jcfg, params,
                  jconfig.EngineConfig(**dict(ENGINE_KW, **over)))
    assert eng._async is async_on
    return eng


def _assert_pool_whole(eng):
    assert eng.cache.leaked_blocks == 0
    assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1


def _assert_finished_equal(a, b):
    assert a.req_id == b.req_id
    assert a.token_ids == b.token_ids, (a.req_id, a.token_ids, b.token_ids)
    assert a.stop_reason == b.stop_reason


def _run_schedule(eng, schedule, sp_of):
    """Drive ``eng`` through a deterministic ``{step: [action]}`` schedule
    (``("add", prompt)`` or ``("cancel", add_index)``). Returns the
    finished requests and the streams by request id, and the ids."""
    fins, streams, rids = {}, {}, []
    step = 0
    while True:
        for action in schedule.get(step, ()):
            if action[0] == "add":
                toks = []
                rid = eng.add_request(action[1], sp_of(len(rids)),
                                      on_token=toks.append)
                rids.append(rid)
                streams[rid] = toks
            elif action[1] < len(rids):
                fin = eng.cancel(rids[action[1]])
                if fin is not None:
                    fins[fin.req_id] = fin
        if eng.has_work:
            for f in eng.step():
                fins[f.req_id] = f
        step += 1
        if not eng.has_work and step > max(schedule, default=0):
            return fins, streams, rids


MIXED = {0: [("add", [1, 5, 9]), ("add", [2, 7])],
         3: [("add", [42, 43, 44, 45])],
         6: [("add", [9, 9, 9])]}
MIXED_NEW = (4, 9, 5, 7)
LONG = list(range(3, 43))   # 40 tokens: chunks 32 + 8 under buckets (16, 32)
# the continuation chunk runs at step 2 with nothing waiting: a chunking
# flush; [2, 7] joins later
CHUNKED = {0: [("add", [1, 5, 9]), ("add", LONG)],
           4: [("add", [2, 7])]}
CHUNKED_NEW = (9, 6, 5)

# (schedule, new tokens per request, engine switches)
CASES = {
    "join-finish": (MIXED, MIXED_NEW, {}),
    "chunked": (CHUNKED, CHUNKED_NEW, {}),
    "ragged": (CHUNKED, CHUNKED_NEW, {"SHAI_RAGGED_ATTENTION": "1"}),
    "int8": (MIXED, MIXED_NEW, {"SHAI_KV_QUANT": "int8"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_async_greedy_matches_lockstep_and_jax(tiny, monkeypatch, case):
    """Staggered joins and finishes recompose the batch mid-pipeline, a
    40-token prompt chunks beside decoding rows, and the two switches
    take their decode paths: the async engine's tokens and streams equal
    the lock-step engine's, and hold greedy parity with the JAX engine's
    under both of its disciplines."""
    schedule, new, env = CASES[case]

    def port_sp(i):
        return SamplingParams(temperature=0.0, max_new_tokens=new[i])

    def jax_sp(i):
        return JParams(temperature=0.0, logprobs=2, max_new_tokens=new[i])

    out = {}
    for mode in (True, False):
        eng = _port(tiny, monkeypatch, mode, env)
        out[mode] = _run_schedule(eng, schedule, port_sp)
        _assert_pool_whole(eng)
        if mode:
            assert eng.obs.pipeline_flushes > 0
            assert set(eng.obs.flush_reasons()) <= {
                "admission", "chunking", "recompose", "drained"}
        if schedule is CHUNKED:
            assert [k for k in eng._prefill if k[0] in ("cont", "rcont")]
            if mode:
                assert eng.obs.flush_reasons().get("chunking", 0) > 0
    (fa, sa, ra), (fb, sb, rb) = out[True], out[False]
    assert ra == rb
    for rid in ra:
        _assert_finished_equal(fa[rid], fb[rid])
        assert sa[rid] == sb[rid]
        assert sa[rid] == fa[rid].token_ids
        assert len(fa[rid].token_ids) == new[ra.index(rid)]
    for jmode in ((True, False) if case == "join-finish" else (True,)):
        jeng = _jax(tiny, monkeypatch, jmode, env)
        jf, _, jr = _run_schedule(jeng, schedule, jax_sp)
        assert jeng.cache.leaked_blocks == 0
        assert_greedy_parity([fa[r] for r in ra], [jf[r] for r in jr],
                             label=f"{case} jax async={jmode}")


def test_async_streaming_order_matches_lockstep(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    streams = {}
    for mode in (True, False):
        eng = _port(tiny, monkeypatch, mode)
        toks = []
        eng.add_request([3, 4, 5], sp, on_token=toks.append)
        while eng.has_work:
            eng.step()
        streams[mode] = toks
    assert streams[True] == streams[False]
    assert len(streams[True]) == 6


def test_async_sampled_rows_match_lockstep(tiny, monkeypatch):
    """Sampled rows (top-k and top-p) beside a greedy one: both
    disciplines draw the same uniforms in the same order, so the tokens
    are equal; the draws change from step to step (two sampled runs of
    the same prompt differ)."""
    prompts = [[1, 5, 9], [1, 200, 300, 400, 17, 23], [2, 2, 7, 7]]
    sps = [SamplingParams(temperature=0.9, top_k=5, max_new_tokens=8),
           SamplingParams(temperature=0.7, top_p=0.8, max_new_tokens=8),
           SamplingParams(temperature=0.0, max_new_tokens=8)]
    out = {}
    for mode in (True, False):
        eng = _port(tiny, monkeypatch, mode)
        ids = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
        fins = {}
        while eng.has_work:
            for f in eng.step():
                fins[f.req_id] = f
        out[mode] = [fins[i].token_ids for i in ids]
        _assert_pool_whole(eng)
    assert out[True] == out[False]
    assert len(set(map(tuple, out[True][:2]))) == 2
    assert len(set(out[True][0])) > 1


def test_async_preemption_parity_and_pool_balance(tiny, monkeypatch,
                                                  caplog):
    """A pool sized to force recompute-preemption: the async path flushes
    around the preempting grow path and still matches lock-step token for
    token (and the JAX engine at greedy parity)."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=12)
    prompts = [[11 + i, 7, 9, 3] for i in range(3)]
    out = {}
    for mode in (True, False):
        caplog.clear()
        eng = _port(tiny, monkeypatch, mode, num_blocks=6)
        with caplog.at_level(logging.WARNING):
            fins = eng.generate(prompts, sp)
        out[mode] = (fins, sum("preempting seq" in r.getMessage()
                               for r in caplog.records))
        _assert_pool_whole(eng)
        if mode:
            assert eng.obs.flush_reasons().get("kv_pressure", 0) > 0
    (fa, pa), (fb, pb) = out[True], out[False]
    assert pa == pb and pa > 0, "the schedule did not preempt"
    for x, y in zip(fa, fb):
        _assert_finished_equal(x, y)
    jeng = _jax(tiny, monkeypatch, False, num_blocks=6)
    want = jeng.generate(prompts, JParams(temperature=0.0, logprobs=2,
                                          max_new_tokens=12))
    assert_greedy_parity(fa, want, label="preemption")
    assert jeng.cache.leaked_blocks == 0


def test_async_cancel_mid_decode_flush_conserves_blocks(tiny, monkeypatch):
    """Cancel with the lookahead step in flight: the flush discards the
    extra computed token (never emitted, never returned) and frees its
    blocks in the same call; the partials match a lock-step cancel at the
    same step."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=14)
    out = {}
    for mode in (True, False):
        eng = _port(tiny, monkeypatch, mode)
        streams = {}
        rid = eng.add_request([3, 4, 5], sp,
                              on_token=streams.setdefault(0, []).append)
        keep = eng.add_request([8, 8, 9], sp,
                               on_token=streams.setdefault(1, []).append)
        for _ in range(5):
            eng.step()
        if mode:
            assert eng._pipe is not None, "the lookahead should be in flight"
        fin = eng.cancel(rid)
        assert fin is not None and fin.stop_reason == "cancelled"
        assert eng._pipe is None
        fins = {rid: fin}
        while eng.has_work:
            for f in eng.step():
                fins[f.req_id] = f
        _assert_pool_whole(eng)
        assert streams[0] == fin.token_ids
        assert streams[1] == fins[keep].token_ids
        if mode:
            assert eng.obs.flush_reasons().get("cancelled") == 1
        out[mode] = fins, rid, keep
    (fa, rid, keep), (fb, _, _) = out[True], out[False]
    _assert_finished_equal(fa[rid], fb[rid])
    _assert_finished_equal(fa[keep], fb[keep])


def test_finish_pending_retires_trailing_inflight(tiny, monkeypatch):
    """When every slot finishes at a commit, the final lookahead dispatch
    stays in flight; ``finish_pending`` (the engine loop's idle hook)
    retires it without disturbing state, and is a no-op thereafter."""
    eng = _port(tiny, monkeypatch, True)
    eng.generate([[1, 2, 3]], SamplingParams(temperature=0.0,
                                             max_new_tokens=5))
    assert eng._pipe is not None
    eng.finish_pending()
    assert eng._pipe is None
    _assert_pool_whole(eng)
    flushes = eng.obs.pipeline_flushes
    assert eng.obs.flush_reasons()["idle"] == 1
    eng.finish_pending()
    assert eng.obs.pipeline_flushes == flushes
    [fin] = eng.generate([[7, 7, 2]], SamplingParams(temperature=0.0,
                                                     max_new_tokens=4))
    assert len(fin.token_ids) == 4
    _assert_pool_whole(eng)


def test_resident_tables_track_block_identity_not_count():
    """The allocator's free list is LIFO: a shrink-then-regrow cycle can
    hand two slots each other's freed blocks with every per-row block
    COUNT unchanged. The resident batch must upload tables again on a
    block IDENTITY change, into the same static tensor the graph reads;
    a new graph gets the whole marshal."""
    M = 4

    class _Seq:
        def __init__(self, blocks):
            self.blocks = blocks

        def table(self, m):
            t = np.zeros((m,), np.int32)
            t[:len(self.blocks)] = self.blocks
            return t

    def _graph():
        return types.SimpleNamespace(inputs={
            "tables": torch.zeros(2, M, dtype=torch.int32),
            "temp": torch.ones(2), "topk": torch.zeros(2, dtype=torch.int32),
            "topp": torch.ones(2)})

    seqs = {0: _Seq([1]), 1: _Seq([2])}
    marshals = []

    def marshal(running, Bb):
        marshals.append(Bb)
        return {"tables": np.stack([seqs[s.req.req_id].table(M)
                                    for s in running]),
                "temp": np.full((Bb,), 0.5, np.float32),
                "topk": np.zeros((Bb,), np.int32),
                "topp": np.ones((Bb,), np.float32)}

    eng = types.SimpleNamespace(
        cache=types.SimpleNamespace(seq=lambda rid: seqs[rid]),
        ecfg=types.SimpleNamespace(blocks_per_seq=M),
        _marshal_running=marshal)
    running = [types.SimpleNamespace(req=types.SimpleNamespace(req_id=i),
                                     slot=i) for i in range(2)]
    g = _graph()
    static = g.inputs["tables"]
    res = ResidentBatch()
    a1 = res.refresh(eng, running, 2, g)
    assert a1["tables"].tolist() == [[1, 0, 0, 0], [2, 0, 0, 0]]
    assert a1["temp"].tolist() == [0.5, 0.5]
    # swap block identities, counts unchanged: the LIFO churn shape
    seqs[0].blocks, seqs[1].blocks = [2], [1]
    a2 = res.refresh(eng, running, 2, g)
    assert a2["tables"] is static
    assert static.tolist() == [[2, 0, 0, 0], [1, 0, 0, 0]]
    assert marshals == [2]          # tables alone went up again
    res.refresh(eng, running, 2, g)
    assert marshals == [2]          # nothing changed: nothing moved
    g2 = _graph()
    assert res.refresh(eng, running, 2, g2)["tables"].tolist() == \
        [[2, 0, 0, 0], [1, 0, 0, 0]]
    assert marshals == [2, 2]       # another graph: the whole marshal


def test_async_gate_off_is_lockstep(tiny, monkeypatch):
    eng = _port(tiny, monkeypatch, False)
    eng.generate([[1, 2, 3]], SamplingParams(temperature=0.0,
                                             max_new_tokens=4))
    assert eng._pipe is None
    assert eng.obs.pipeline_flushes == 0
    monkeypatch.delenv("SHAI_ASYNC_DECODE")
    assert LLMEngine(tiny[2], tiny[3], tconfig.EngineConfig(**ENGINE_KW),
                     device="cpu")._async is True
