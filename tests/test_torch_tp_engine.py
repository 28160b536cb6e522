"""The port's paged engine over tensor-parallel ranks (``engine/ranks.py``,
``parallel/distributed.py``), held on the CPU against the port's own
one-device engine and the JAX engine's sharded path.

One two-rank gloo group is spawned for the module (``spawn_ranks`` over a
``FileStore``, with a timeout): each rank loads its shard of the tiny
Llama (4 heads over 2 kv heads, from a flax init through
``params_from_jax``) and runs every case of ``tests/tp_rank_cases.py`` in
turn, rank 0 driving and rank 1 following through the step mirror. While
the ranks run, this process runs the same cases on tp=1 engines and the
JAX engine at tp=2 on two of the 8 virtual devices (``tests/
test_engine.py``'s ``_tp_engine``).

- the group's collectives equal ``LoopbackGroup``'s, bit for bit;
- greedy tokens at tp=2, lock-step and async, a chunked prompt included,
  equal the port's tp=1 and meet the JAX engine at tp=2 under
  ``assert_greedy_parity``; ragged + int8 KV, int8 weights, the CoW
  ``n = 2`` fan-out over a prefix hit, ``[ngram]`` speculation with k=4,
  the fused step and the soft prefix each meet tp=1 under the same
  switches (token-equal, or parting only at a bf16 tie, logprobs within
  6e-2 where equal); ``warm_executables`` (0 recompiles on each rank) and
  a 1-kv-head model widened to tp equal tp=1;
- every case ends with both ranks holding equal digests (checked every
  ``CHECK_EVERY`` steps and at the end), no leaked block and the whole
  pool free;
  temperature 0.8 gives equal streams on both ranks; a cancel and a
  deadline mid-stream leave the ranks equal, and so does a step that rank
  0's chaos site crashes;
- the refusals: a tp without a matching group, mllama under a group, the
  host tier off under TP with its warnings; a rank that raises fails the
  parent with its traceback inside the timeout, and no rank outlives its
  test; ``launch_engine`` serves through ``EngineLoop`` on the CPU.
"""

import concurrent.futures
import dataclasses
import multiprocessing
import os
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_hw_agnostic_inference_tpu.core.mesh import build_mesh
from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.parallel.sharding import shard_pytree
from scalable_hw_agnostic_inference_tpu_torch.engine import engine as pengine
from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
    EngineConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.loop import EngineLoop
from scalable_hw_agnostic_inference_tpu_torch.engine.ranks import (
    launch_engine,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as pllama
from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
    quantize_state_dict,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.distributed import (
    spawn_ranks,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.loopback import (
    LoopbackGroup,
    run_ranks,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tp_rank_cases as cases  # noqa: E402
from parity import assert_greedy_parity  # noqa: E402

#: the spawned group's limit: every case of both ranks, with room for a
#: loaded machine
SPAWN_TIMEOUT_S = 240.0
#: logprob agreement with tp=1 (``tests/test_torch_logprobs.py``'s)
LP_TOL = 6e-2


def _tp1_runs(cfgs, states):
    """Every case on a tp=1 engine under its switches."""
    out = {}
    for name, (env, _, _, key) in cases.CASES.items():
        cases.set_env(env)
        out[name] = cases.tp1_run(name, cfgs[key], states[key])
    cases.set_env({})
    return out


def _jax_tp2(jcfg, params):
    mesh = build_mesh("tp=2", devices=jax.devices()[:2])
    sharded = shard_pytree(params, mesh, jllama.tp_rules())
    eng = JEngine(jcfg, sharded, jconfig.EngineConfig(
        **dict(cases.ENGINE_KW, tensor_parallel_size=2)), mesh=mesh)
    return eng.generate(cases.PROMPTS, JParams(**cases.GREEDY))


def _launched(cfg, state):
    """``launch_engine`` at tp=2 on the CPU (rank 0 here, rank 1 a
    follower process), its requests through ``EngineLoop``."""
    eng = launch_engine(cfg, state, EngineConfig(
        **dict(cases.ENGINE_KW, tensor_parallel_size=2)), 2, "gloo", "cpu",
        timeout_s=60.0)
    [follower] = eng.mirror.followers
    loop = EngineLoop(eng).start()
    try:
        futs = [loop.submit(p, pengine.SamplingParams(**cases.GREEDY))
                for p in cases.PROMPTS]
        tokens = [f.result(timeout=60).token_ids for f in futs]
    finally:
        loop.stop()
        eng.close()
    return types.SimpleNamespace(tokens=tokens, follower=follower,
                                 leaked=eng.cache.leaked_blocks,
                                 checks=eng.mirror.checks)


def _failing_rank():
    """A group whose rank 1 raises: the error, and the seconds to it."""
    t0 = time.monotonic()
    try:
        spawn_ranks(cases.raise_on_rank_1, 2, "gloo", 60.0)
    except RuntimeError as e:
        return e, time.monotonic() - t0
    return None, time.monotonic() - t0


@pytest.fixture(scope="module")
def tp():
    """The spawned group's results beside the tp=1 and JAX runs, the
    launched engine's and the failing group's: the spawns overlap (each
    rank pays an interpreter and a torch import)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = pllama.LlamaConfig(**dataclasses.asdict(jcfg))
    state = pllama.params_from_jax(params, tcfg)
    kv1 = dataclasses.replace(tcfg, n_kv_heads=1)
    cfgs = {"bf16": tcfg, "int8": tcfg, "kv1": kv1}
    states = {"bf16": state, "int8": quantize_state_dict(state),
              "kv1": pllama.random_params(kv1, 3, std=0.05,
                                          dtype=torch.float32,
                                          device="cpu")}
    saved = {k: v for k, v in os.environ.items() if k.startswith("SHAI_")}
    try:
        cases.set_env({})
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            ranks = pool.submit(spawn_ranks, cases.run_cases, 2, "gloo",
                                SPAWN_TIMEOUT_S,
                                (cfgs, states, list(cases.CASES)))
            failing = pool.submit(_failing_rank)
            # the launched engine reads the (clear) switches at start; the
            # tp=1 runs set theirs only after it has finished
            launched = pool.submit(_launched, tcfg, state)
            jax_tp2 = _jax_tp2(jcfg, params)
            launched = launched.result()
            tp1 = _tp1_runs(cfgs, states)
            rank0, rank1 = ranks.result()
            failed = failing.result()
    finally:
        cases.set_env(saved)
        torch.set_num_threads(n_threads)
    return types.SimpleNamespace(cfgs=cfgs, states=states, tp1=tp1,
                                 jax_tp2=jax_tp2, ranks=(rank0, rank1),
                                 launched=launched, failed=failed)


def _tokens(res):
    return [toks for _, toks, _ in res["finished"]]


def _assert_tie_rule(got, want, label):
    """``got``'s tokens equal ``want``'s, or part only where ``want``'s
    top-2 logprob gap is a bf16 tie (``tests/parity.py``)."""
    assert_greedy_parity(
        [types.SimpleNamespace(token_ids=t) for t in _tokens(got)],
        [types.SimpleNamespace(token_ids=t, logprobs=[
            {"top_logprobs": top} for top in tops])
         for t, tops in zip(_tokens(want), want["top2"])], label=label)


def _assert_ranks_whole(tp, name):
    """Both ranks finished the same requests, checked equal digests, and
    hold a whole pool."""
    r0, r1 = (r[name] for r in tp.ranks)
    assert r0["finished"] == r1["finished"]
    for r in (r0, r1):
        assert r["leaked"] == 0 and r["whole"]
        assert r["checks"] >= 1 and r["steps"] == r0["steps"]


def _assert_lps_close(got, want):
    assert [len(x) for x in got] == [len(x) for x in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=LP_TOL)


def test_dist_group_collectives_equal_the_loopback_group(tp):
    group = LoopbackGroup(2)

    def fn(rank):
        x = torch.randn((3, 5, 8), generator=torch.Generator().manual_seed(
            rank)).to(torch.bfloat16)
        return {"sum": group.all_reduce(x.clone()),
                "cat_last": group.all_gather(x, dim=-1),
                "cat_1": group.all_gather(x, dim=1)}

    want = run_ranks(fn, group)
    for rank in (0, 1):
        got = tp.ranks[rank]["collectives"]
        for key in ("sum", "cat_last", "cat_1"):
            assert got[key].dtype == torch.bfloat16
            assert torch.equal(got[key], want[rank][key]), (rank, key)


@pytest.mark.parametrize("name", ["sync", "async"])
def test_greedy_tp2_equals_tp1_and_meets_the_jax_engine(tp, name):
    r0 = tp.ranks[0][name]
    _assert_ranks_whole(tp, name)
    assert _tokens(r0) == _tokens(tp.tp1[name])
    assert [len(t) for t in _tokens(r0)] == [cases.NEW_TOKENS] * 3
    got = [types.SimpleNamespace(token_ids=t) for t in _tokens(r0)]
    assert_greedy_parity(got, tp.jax_tp2, label=f"tp=2 {name}")
    _assert_lps_close(r0["lps"], tp.tp1[name]["lps"])
    # each rank's pool holds its one kv head of two
    assert r0["pool"][2] == 1
    assert r0["tp"] == {"size": 2, "rank": 0, "backend": "gloo",
                        "graphs": "eager"}
    assert tp.ranks[1][name]["tp"]["rank"] == 1


@pytest.mark.parametrize("name", ["ragged_int8kv", "int8", "cow_prefix",
                                  "ngram", "fused", "prefix"])
def test_switches_meet_tp1(tp, name):
    """Token-equal to tp=1 under the same switches, or parting at a bf16
    tie: the ranks' bf16 partial sums differ from the one-device sums in
    their last bit, and int8 KV quantizes what it is given (the ragged
    int8-KV run on the tiny model parts at a top-2 gap of 0.0053)."""
    r0, want = tp.ranks[0][name], tp.tp1[name]
    _assert_ranks_whole(tp, name)
    _assert_tie_rule(r0, want, f"tp=2 {name}")
    if _tokens(r0) == _tokens(want):
        assert r0["finished"] == want["finished"]
        _assert_lps_close(r0["lps"], want["lps"])
    if name == "cow_prefix":
        assert r0["cow_forks"] == want["cow_forks"] == 1
        assert r0["cow_copies"] == want["cow_copies"] == 1
        assert r0["recomputed"] == want["recomputed"] < 24
    if name == "ngram":
        assert r0["accepted"] > 0
        if _tokens(r0) == _tokens(want):
            assert (r0["drafted"], r0["accepted"]) == (want["drafted"],
                                                       want["accepted"])


def test_sampled_streams_are_equal_on_every_rank(tp):
    _assert_ranks_whole(tp, "sampled")
    toks = _tokens(tp.ranks[0]["sampled"])
    assert [len(t) for t in toks] == [cases.NEW_TOKENS] * 2
    assert toks != _tokens(tp.tp1["async"])[:2]   # it did sample


def test_cancel_and_deadline_mid_stream_leave_the_ranks_equal(tp):
    _assert_ranks_whole(tp, "abort_deadline")
    r0 = tp.ranks[0]["abort_deadline"]
    keep, cut, late = r0["ids"]
    by_id = {rid: (toks, why) for rid, toks, why in r0["finished"]}
    assert by_id[keep][1] == "length" and len(by_id[keep][0]) == 12
    assert by_id[cut][1] == "cancelled" and 0 < len(by_id[cut][0]) < 12
    assert by_id[late][1] == "timeout" and 0 < len(by_id[late][0]) < 12


def test_a_step_crash_on_rank_0_leaves_the_ranks_in_step(tp):
    """The crashed step was run by no rank: the ranks then serve on with
    equal digests, and the tokens are tp=1's under the same crash."""
    _assert_ranks_whole(tp, "step_crash")
    r0 = tp.ranks[0]["step_crash"]
    assert r0["crashed"] and tp.tp1["step_crash"]["crashed"]
    assert r0["seconds"] < 60.0
    assert _tokens(r0) == _tokens(tp.tp1["step_crash"])
    assert [len(t) for t in _tokens(r0)] == [cases.NEW_TOKENS] * 2


def test_kv_heads_widened_to_tp(tp):
    """One kv head at tp=2: ``replicate_kv_heads`` widens it to two, one
    per rank, and the tokens stay the unwidened model's."""
    _assert_ranks_whole(tp, "gqa1")
    r0 = tp.ranks[0]["gqa1"]
    assert r0["pool"][2] == 1
    assert _tokens(r0) == _tokens(tp.tp1["gqa1"])


def test_warm_builds_the_same_closed_set_on_every_rank(tp):
    _assert_ranks_whole(tp, "warm")
    r0, r1 = (r["warm"] for r in tp.ranks)
    assert r0["warmed"] == tp.tp1["warm"]["warmed"]
    assert r0["n_executables"] == r1["n_executables"] == r0["warmed"]
    assert r0["recompiles"] == r1["recompiles"] == 0
    assert _tokens(r0) == _tokens(tp.tp1["warm"])


def test_refusals_and_the_tier_off_under_tp(tp):
    cfg, state = tp.cfgs["bf16"], tp.states["bf16"]
    model = pllama.LlamaForCausalLM.from_state_dict(cfg, state)
    two = EngineConfig(**dict(cases.ENGINE_KW, tensor_parallel_size=2))
    with pytest.raises(ValueError, match="parallel.distributed"):
        pengine.LLMEngine(cfg, model, two, device="cpu")
    # a group of 2 under tensor_parallel_size 1
    group = LoopbackGroup(2)
    with pytest.raises(ValueError, match="parallel.distributed"):
        pengine.LLMEngine(cfg, model, EngineConfig(**cases.ENGINE_KW),
                          device="cpu", group=group)
    # a model that is not the group's rank
    with pytest.raises(ValueError, match="model's group"):
        pengine.LLMEngine(cfg, model, two, device="cpu", group=group)
    mcfg = dataclasses.replace(cfg, n_layers=3, cross_attention_layers=(1,))
    with pytest.raises(ValueError, match="A7.2b"):
        pllama.LlamaForCausalLM(mcfg, dtype=torch.float32, device="cpu",
                                group=group)
    mllama = pllama.LlamaForCausalLM(mcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="A7.2b"):
        pengine.LLMEngine(mcfg, mllama, two, device="cpu", group=group,
                          cross_seq_len=4)
    # SHAI_KVTIER under TP: no tier on either rank, the reference's
    # prefill-role warning and the tier's own
    for rank in tp.ranks:
        res = rank["tier_off"]
        assert not res["tier"]
        assert pengine.NO_TIER_PREFILL in res["warnings"]
        assert any("host KV tier stays off" in w for w in res["warnings"])
    assert tp.tp1["tier_off"]["finished"] == tp.ranks[0]["tier_off"][
        "finished"]


def _rank_children():
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("tp-rank-")]


def test_a_failing_rank_fails_the_parent_with_its_traceback(tp):
    err, seconds = tp.failed
    assert err is not None and seconds < 60.0
    assert "rank 1 of 2 failed" in str(err)
    assert "ValueError: rank 1 refuses on purpose" in str(err)
    assert not _rank_children()


def test_launch_engine_serves_through_the_loop(tp):
    """Rank 0 in this process, rank 1 a follower process: requests through
    ``EngineLoop`` give the spawned group's tokens; ``close`` checks the
    digests and ends the follower."""
    run = tp.launched
    assert run.tokens == _tokens(tp.ranks[0]["async"])
    assert run.follower.exitcode == 0 and not _rank_children()
    assert run.leaked == 0 and run.checks >= 1
