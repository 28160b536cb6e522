"""The port's per-token logprobs against the JAX engine and against its
own lock-step run, on the CPU.

Port of the logprob half of ``tests/test_engine_async.py`` and of the
engine's ``logprobs`` contract (``engine/logprobs.py``, the readout of
``runner.token_logprobs`` inside every decode graph). The JAX engine and
the port's share weights (``params_from_jax``); the JAX engine decodes
through its Pallas paged kernel in interpret mode (``SHAI_PAGED_DECODE=1``),
as ``tests/test_torch_async.py`` runs it. What is held:

- greedy tokens equal the JAX engine's, or part only at a bf16 tie
  (``tests/parity.py``), under lock-step and async, bucketed and ragged,
  with a chunked prompt and joins mid-decode;
- each entry's ``logprob`` and ``top_logprobs`` within :data:`LP_ATOL` of
  the JAX engine's while the two share a context, and its top ids equal
  except where the reference's values are within :data:`LP_ATOL` of a
  neighbour (``torch.topk`` and ``jax.lax.top_k`` order near-equal values
  apart); one entry per returned token;
- the async engine's entries EQUAL the lock-step engine's (the same graph
  readouts, a finished slot's lookahead entry dropped), sampled rows too;
- an EOS pops its entry; a recompute preemption keeps the entries already
  produced (``already_lp``).

``LP_ATOL`` = 6e-2 is the logit tolerance of ``tests/test_torch_chunked.py``
(one or two bf16 ulps at ``|logit| < 5``): both engines round bf16
activations, in different orders, and a log-softmax moves with its
logits. On these schedules the two differ by at most 0.031.
"""

import dataclasses
import logging
import sys
from pathlib import Path

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
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

LP_ATOL = 6e-2
ENGINE_KW = dict(max_model_len=64, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16)
LONG = list(range(3, 43))   # 40 tokens: chunks 32 + 8 under buckets (16, 32)
# a chunked prompt beside a decoding row, a join while it chunks, a join
# after it finished; (prompt, new tokens, logprobs asked)
REQUESTS = {0: [([1, 5, 9], 9, 5), (LONG, 6, 2)],
            4: [([2, 7], 5, 5)],
            9: [([42, 43, 44, 45], 4, 1)]}


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
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    for k, v in dict(env).items():
        monkeypatch.setenv(k, v)
    return JEngine(jcfg, params,
                   jconfig.EngineConfig(**dict(ENGINE_KW, **over)))


def _run(eng, make_params, requests=REQUESTS):
    """Drive ``eng`` through ``{step: [(prompt, new, logprobs)]}``;
    returns the finished requests in submission order."""
    rids, fins, step = [], {}, 0
    while True:
        for prompt, new, lp in requests.get(step, ()):
            rids.append(eng.add_request(prompt, make_params(new, lp)))
        if eng.has_work:
            for f in eng.step():
                fins[f.req_id] = f
        step += 1
        if not eng.has_work and step > max(requests):
            return [fins[r] for r in rids]


def _port_sp(new, lp):
    return SamplingParams(temperature=0.0, max_new_tokens=new, logprobs=lp)


def _jax_sp(new, lp):
    return JParams(temperature=0.0, max_new_tokens=new, logprobs=5)


def _assert_entries_whole(fin, n_top):
    """One entry per returned token, naming it, with ``n_top``
    alternatives in descending order."""
    assert len(fin.logprobs) == len(fin.token_ids)
    for e, tok in zip(fin.logprobs, fin.token_ids):
        assert e["token"] == tok
        assert len(e["top_ids"]) == len(e["top_logprobs"]) == n_top
        assert e["top_logprobs"] == sorted(e["top_logprobs"], reverse=True)
        assert e["logprob"] <= e["top_logprobs"][0] + 1e-6


def _assert_entries_close(got, want, n_top):
    """``got`` (port) against ``want`` (JAX, five alternatives) while the
    two share a context: every entry up to and including the first token
    where the streams part."""
    n = next((i for i, (a, b) in enumerate(zip(got.token_ids, want.token_ids))
              if a != b), min(len(got.token_ids), len(want.token_ids)) - 1)
    for i in range(n + 1):
        g, w = got.logprobs[i], want.logprobs[i]
        wl = w["top_logprobs"]
        for j, (gv, wv) in enumerate(zip(g["top_logprobs"], wl)):
            assert abs(gv - wv) <= LP_ATOL, (i, j, gv, wv)
            if g["top_ids"][j] != w["top_ids"][j]:
                near = [abs(wl[j] - wl[k]) for k in (j - 1, j + 1)
                        if 0 <= k < len(wl)]
                assert min(near) <= LP_ATOL, (
                    f"entry {i}: top id {j} {g['top_ids']} != "
                    f"{w['top_ids'][:n_top]} with no near-tie in {wl}")
        if got.token_ids[i] == want.token_ids[i]:
            assert abs(g["logprob"] - w["logprob"]) <= LP_ATOL


MODES = {"lockstep-bucketed": (False, {}),
         "lockstep-ragged": (False, {"SHAI_RAGGED_ATTENTION": "1"}),
         "async-bucketed": (True, {}),
         "async-ragged": (True, {"SHAI_RAGGED_ATTENTION": "1"})}


@pytest.mark.parametrize("mode", list(MODES))
def test_logprobs_match_the_jax_engine(tiny, monkeypatch, mode):
    async_on, env = MODES[mode]
    eng = _port(tiny, monkeypatch, async_on, env)
    got = _run(eng, _port_sp)
    assert eng.cache.leaked_blocks == 0
    jeng = _jax(tiny, monkeypatch, async_on, env)
    want = _run(jeng, _jax_sp)
    assert_greedy_parity(got, want, label=mode)
    asked = [lp for reqs in REQUESTS.values() for _, _, lp in reqs]
    for g, w, n_top in zip(got, want, asked):
        _assert_entries_whole(g, n_top)
        _assert_entries_close(g, w, n_top)
        # a greedy row's token is its readout's best
        for e in g.logprobs:
            assert e["token"] == e["top_ids"][0]
            assert e["logprob"] == e["top_logprobs"][0]


@pytest.mark.parametrize("ragged", [False, True], ids=["bucketed", "ragged"])
def test_async_entries_equal_lockstep(tiny, monkeypatch, ragged):
    """Greedy and sampled rows with and without logprobs, joins and
    finishes mid-pipeline: the async engine's entries are the lock-step
    engine's, bit for bit."""
    env = {"SHAI_RAGGED_ATTENTION": "1"} if ragged else {}

    def sp(new, lp):
        # the rows asking 5 and 1 sample, the others are greedy
        return SamplingParams(temperature=0.8 if lp in (1, 5) else 0.0,
                              top_k=20, max_new_tokens=new, logprobs=lp)

    requests = {0: [([1, 5, 9], 9, 5), (LONG, 6, 0)],
                3: [([2, 7], 5, 2)], 7: [([42, 43, 44, 45], 4, 1)]}
    out = {}
    for mode in (True, False):
        eng = _port(tiny, monkeypatch, mode, env)
        out[mode] = _run(eng, sp, requests)
        assert eng.cache.leaked_blocks == 0
    for a, b in zip(out[True], out[False]):
        assert a.token_ids == b.token_ids
        assert a.logprobs == b.logprobs
    assert out[True][1].logprobs is None
    for f, n_top in ((out[True][0], 5), (out[True][2], 2),
                     (out[True][3], 1)):
        _assert_entries_whole(f, n_top)


@pytest.mark.parametrize("async_on", [True, False], ids=["async", "lockstep"])
def test_eos_pops_its_entry(tiny, monkeypatch, async_on):
    """A request that stops on EOS returns no entry for it: its entries are
    the probe run's up to the EOS. The JAX engine, run the same way, keeps
    greedy parity and close entries (here the two part at a bf16 tie
    before the EOS, so the JAX run may go on to its length)."""
    eng = _port(tiny, monkeypatch, async_on)
    [probe] = eng.generate([[1, 17, 42]], _port_sp(8, 3))
    eos = probe.token_ids[3]
    cut = probe.token_ids.index(eos)
    [fin] = eng.generate([[1, 17, 42]], SamplingParams(
        temperature=0.0, max_new_tokens=8, logprobs=3, eos_id=eos))
    assert fin.stop_reason == "eos"
    assert fin.token_ids == probe.token_ids[:cut]
    assert fin.logprobs == probe.logprobs[:cut]
    jeng = _jax(tiny, monkeypatch, async_on)
    [jfin] = jeng.generate([[1, 17, 42]], JParams(
        temperature=0.0, max_new_tokens=8, logprobs=5, eos_id=eos))
    assert eos not in jfin.token_ids
    assert len(jfin.logprobs) == len(jfin.token_ids)
    assert_greedy_parity([fin], [jfin], label="eos")
    _assert_entries_close(fin, jfin, 3)


def test_preemption_keeps_already_lp(tiny, monkeypatch, caplog):
    """A pool sized to force recompute-preemption: each preempted request
    keeps the entries it had (``already_lp``) and gets one per token after
    resuming, equal between the two disciplines and close to the JAX
    engine's."""
    prompts = [[11 + i, 7, 9, 3] for i in range(3)]
    out = {}
    for mode in (True, False):
        caplog.clear()
        eng = _port(tiny, monkeypatch, mode, num_blocks=6)
        with caplog.at_level(logging.WARNING):
            fins = eng.generate(prompts, _port_sp(12, 4))
        preempted = sum("preempting seq" in r.getMessage()
                        for r in caplog.records)
        assert preempted > 0, "the schedule did not preempt"
        assert eng.obs.preemptions == preempted
        assert eng.cache.leaked_blocks == 0
        out[mode] = fins
    for a, b in zip(out[True], out[False]):
        assert a.token_ids == b.token_ids and a.logprobs == b.logprobs
        _assert_entries_whole(a, 4)
        assert len(a.token_ids) == 12
    jeng = _jax(tiny, monkeypatch, False, num_blocks=6)
    want = jeng.generate(prompts, _jax_sp(12, 5))
    assert_greedy_parity(out[True], want, label="preemption")
    for g, w in zip(out[True], want):
        _assert_entries_close(g, w, 4)
