"""The cases ``tests/test_torch_tp_engine.py`` runs on each rank of one
two-rank gloo group, and the functions that send their requests, shared
with the tp=1 engines it holds them against.

This module imports torch and the port only (no JAX): every spawned rank
imports it to unpickle :func:`run_cases`. Rank 0 drives each case's
engine; rank 1 follows it (``engine.ranks.follow``). A case returns, per
rank, the requests it finished ``(id, tokens, stop reason)`` and the
rank's pool and mirror state.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from scalable_hw_agnostic_inference_tpu_torch.engine import ranks
from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
    EngineConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
    LlamaForCausalLM,
)
from scalable_hw_agnostic_inference_tpu_torch.resilience import faults

#: the engines' shape (``tests/test_engine.py``'s ``_tp_engine``, with a
#: longer window: the third prompt chunks past the 32-token bucket)
ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16)
PROMPTS = [[1, 17, 42, 99, 7], [3, 5], list(range(2, 47))]
NEW_TOKENS = 8
GREEDY = dict(temperature=0.0, max_new_tokens=NEW_TOKENS, logprobs=2)

#: each case: (SHAI_* switches, EngineConfig overrides, the function that
#: sends its requests, state key)
CASES: Dict[str, tuple] = {}


def _case(name, env=None, kw=None, state="bf16"):
    def put(drive):
        CASES[name] = (dict(env or {}), dict(kw or {}), drive, state)
        return drive
    return put


def finished(fins) -> List[tuple]:
    return sorted((f.req_id, list(f.token_ids), f.stop_reason)
                  for f in fins)


def _run(eng: LLMEngine, prompts, params) -> List[Any]:
    return eng.generate(prompts, SamplingParams(**params))


def greedy_result(fins) -> Dict[str, Any]:
    """A greedy case's result: the finished requests, each one's sampled
    logprobs and its top-2 logprobs at every step (what
    ``tests/parity.py`` reads to tell a bf16 tie from a fault)."""
    fins = sorted(fins, key=lambda f: f.req_id)
    return {"finished": finished(fins),
            "lps": [[e["logprob"] for e in (f.logprobs or [])]
                    for f in fins],
            "top2": [[[float(v) for v in e["top_logprobs"][:2]]
                      for e in (f.logprobs or [])] for f in fins]}


@_case("sync", env={"SHAI_ASYNC_DECODE": "0"})
@_case("async")
@_case("ragged_int8kv", env={"SHAI_RAGGED_ATTENTION": "1",
                             "SHAI_KV_QUANT": "int8"})
@_case("int8", kw={"quantization": "int8"}, state="int8")
@_case("fused", env={"SHAI_RAGGED_ATTENTION": "1", "SHAI_FUSED_STEP": "1"})
def drive_greedy(eng: LLMEngine) -> Dict[str, Any]:
    return greedy_result(_run(eng, PROMPTS, GREEDY))


@_case("cow_prefix", env={"SHAI_KV_COW": "1"},
       kw={"enable_prefix_caching": True})
def drive_cow(eng: LLMEngine) -> Dict[str, Any]:
    """An ``n = 2`` group over a 22-token prompt (two full blocks and a
    shared partial tail) prefills once and forks; then a prompt extending
    it is admitted on its two cached blocks (a prefix hit)."""
    head = list(range(60, 82))
    p = SamplingParams(**GREEDY)
    lead = eng.add_request(head, p, parent_rid=-2)
    eng.add_request(head, p, parent_rid=lead)
    fins = []
    while eng.has_work:
        fins.extend(eng.step())
    [hit] = _run(eng, [head + [7, 9]], GREEDY)
    return dict(greedy_result(fins + [hit]), cow_forks=eng.cache.cow_forks,
                cow_copies=eng.cache.cow_copies,
                recomputed=hit.timing["recompute_tokens"])


@_case("ngram", kw={"speculative_model": "[ngram]",
                    "num_speculative_tokens": 4})
def drive_ngram(eng: LLMEngine) -> Dict[str, Any]:
    fins = _run(eng, [[5, 6, 7, 8] * 6, [9, 10, 11] * 4, PROMPTS[0]],
                dict(GREEDY, max_new_tokens=12))
    return dict(greedy_result(fins), drafted=eng.spec.drafted,
                accepted=eng.spec.accepted)


@_case("sampled")
def drive_sampled(eng: LLMEngine) -> Dict[str, Any]:
    fins = _run(eng, PROMPTS[:2], dict(temperature=0.8, top_k=40,
                                       max_new_tokens=NEW_TOKENS))
    return {"finished": finished(fins)}


#: the soft prefix ``[P, dim]`` of the prefix case (seeded)
PREFIX = np.random.default_rng(4).standard_normal((6, 64)).astype(
    np.float32)


@_case("prefix")
def drive_prefix(eng: LLMEngine) -> Dict[str, Any]:
    rid = eng.add_request([5, 9, 11], SamplingParams(**GREEDY),
                          prefix=PREFIX)
    fins = []
    while eng.has_work:
        fins.extend(eng.step())
    return dict(greedy_result(fins), rid=rid)


@_case("abort_deadline")
def drive_abort(eng: LLMEngine) -> Dict[str, Any]:
    """Three requests decoding; one cancelled after two steps, one whose
    deadline passes mid-stream (rank 0's clock), one running out."""
    p = SamplingParams(temperature=0.0, max_new_tokens=12)
    keep = eng.add_request(PROMPTS[0], p)
    cut = eng.add_request(PROMPTS[1], p)
    late = eng.add_request([4, 8, 15, 16, 23, 42], p,
                           deadline_at=time.monotonic() + 0.3)
    fins = []
    for _ in range(3):
        fins.extend(eng.step())
    fins.append(eng.cancel(cut))
    time.sleep(0.35)
    while eng.has_work:
        fins.extend(eng.step())
    return {"finished": finished(fins), "ids": (keep, cut, late)}


@_case("step_crash")
def drive_step_crash(eng: LLMEngine) -> Dict[str, Any]:
    """Rank 0's ``engine.step`` chaos site crashes one step mid-stream
    (before rank 0 tells the other ranks to run it): no rank runs that
    step, and the next steps find the ranks still in step."""
    p = SamplingParams(**GREEDY)
    for prompt in PROMPTS[:2]:
        eng.add_request(prompt, p)
    fins = eng.step() + eng.step()
    prev = faults.get()
    faults.configure("engine.step=error#1")
    try:
        eng.step()
        crashed = False
    except faults.FaultError:
        crashed = True
    finally:
        faults.configure(prev.spec, prev.seed)
    while eng.has_work:
        fins.extend(eng.step())
    return dict(greedy_result(fins), crashed=crashed)


@_case("warm")
def drive_warm(eng: LLMEngine) -> Dict[str, Any]:
    n = eng.warm_executables()
    return dict(greedy_result(_run(eng, PROMPTS, GREEDY)), warmed=n)


@_case("tier_off", env={"SHAI_KVTIER": "1"},
       kw={"enable_prefix_caching": True, "role": "prefill"})
def drive_tier_off(eng: LLMEngine) -> Dict[str, Any]:
    return greedy_result(_run(eng, PROMPTS[:1], GREEDY))


@_case("gqa1", state="kv1")
def drive_gqa1(eng: LLMEngine) -> Dict[str, Any]:
    return drive_greedy(eng)


def _pool_whole(eng: LLMEngine) -> bool:
    """Every allocated block is the prefix cache's (none, without one):
    no sequence holds a block after its end, and none leaked."""
    cache = eng.cache
    used = (cache.total_blocks - 1) - cache.allocator.n_free
    return not cache.active and used == len(cache._block2hash)


def set_env(env: Dict[str, str]) -> None:
    """Make ``env`` the process's ``SHAI_*`` switches."""
    for k in [k for k in os.environ if k.startswith("SHAI_")]:
        del os.environ[k]
    os.environ.update(env)


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _collectives(group) -> Dict[str, torch.Tensor]:
    """The group's collectives on seeded bf16 inputs, one per rank."""
    x = torch.randn((3, 5, 8), generator=torch.Generator().manual_seed(
        group.rank)).to(torch.bfloat16)
    return {"sum": group.all_reduce(x.clone()),
            "cat_last": group.all_gather(x, dim=-1),
            "cat_1": group.all_gather(x, dim=1)}


def run_cases(group, cfgs: Dict[str, Any], states: Dict[str, Any],
              names: List[str]) -> Dict[str, Any]:
    """Every case of ``names`` on this rank, in order: rank 0 drives, the
    others follow. Returns ``{case: result}`` and the collectives'."""
    torch.set_num_threads(1)
    out: Dict[str, Any] = {"collectives": _collectives(group)}
    warn = _Warnings()
    logging.getLogger(
        "scalable_hw_agnostic_inference_tpu_torch.engine.engine"
    ).addHandler(warn)
    for name in names:
        env, kw, drive, key = CASES[name]
        set_env(env)
        warn.messages.clear()
        t0 = time.monotonic()
        ecfg = EngineConfig(**dict(ENGINE_KW, tensor_parallel_size=group.size,
                                   **kw))
        eng = ranks.rank_engine(cfgs[key], states[key], ecfg, group, "cpu")
        if group.rank == 0:
            res = drive(eng)
            eng.close()
        else:
            res = {"finished": finished(ranks.follow(eng))}
        res.update(
            seconds=time.monotonic() - t0, leaked=eng.cache.leaked_blocks,
            whole=_pool_whole(eng),
            checks=eng.mirror.checks, steps=eng.mirror.steps,
            tier=eng.cache.tier is not None, warnings=list(warn.messages),
            pool=tuple(eng.cache.kv[0]["k"].shape),
            n_executables=eng.n_executables,
            recompiles=eng.obs.recompiles,
            tp=eng.obs.snapshot().get("tp"))
        out[name] = res
    set_env({})
    return out


def tp1_run(name: str, cfg, state) -> Dict[str, Any]:
    """Case ``name`` on a one-device engine on the CPU (the caller sets the
    case's switches)."""
    env, kw, drive, _ = CASES[name]
    model = LlamaForCausalLM.from_state_dict(cfg, state)
    eng = LLMEngine(cfg, model, EngineConfig(**dict(ENGINE_KW, **kw)),
                    device="cpu")
    res = drive(eng)
    res["leaked"] = eng.cache.leaked_blocks
    return res


def raise_on_rank_1(group) -> int:
    """Rank 1 fails; rank 0 waits in a collective that never pairs."""
    if group.rank == 1:
        raise ValueError("rank 1 refuses on purpose")
    group.all_reduce(torch.ones(4))
    return 0
