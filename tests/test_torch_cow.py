"""The port's copy-on-write ``n > 1`` fan-out (``SHAI_KV_COW``) against the
JAX package's, on the CPU.

Port of the copy-on-write half of ``tests/test_fused_cow.py``. Both
packages read the same weights (a flax init carried over with
``params_from_jax``; the tiny config). What is held:

- the cache: refcounted blocks, ``fork_sequence``, the +1 copy block
  ``blocks_to_extend`` prices, and ``extend`` copying a shared partial
  tail before the first divergent write give the JAX cache's block ids,
  refcounts and counters (``cow_forks``, ``cow_copies``) step for step; the
  copy lands in the pool tensors in place (their addresses unchanged, as
  a captured graph needs), every leaf byte for byte, an int8 pool's scale
  rows included; ``leaked_blocks`` stays 0 with refcounts of 3 live;
- the engine: a fan-out group is TOKEN-EXACT against K independent
  requests (tokens, stop reasons; logprob entries within ``LP_ATOL``,
  1e-5, as the oracle holds them), greedy, top-k and
  top-p, async and lock-step, and under the fused step: the group samples
  its first tokens from the one logits row tiled to the ``Kp`` layout,
  drawing what the ``Kp``-row batched admission of K identical prompts
  draws; greedy tokens are held to the JAX engine under the same switch
  with ``tests/parity.py``'s ``assert_greedy_parity``;
- the pool is whole (``leaked_blocks == 0``) after a seeded fuzz of
  fan-out groups, fillers and cancels on a small pool; finished members
  leave the group maps; cancelling any member through the loop aborts the
  group; ``submit_group`` is token-exact against n ``submit`` calls; a
  group whose members arrive split admits them on their own;
- over sockets: a JAX pod and a port pod under ``SHAI_KV_COW=1`` answer
  ``/v1/completions`` with ``n=3`` greedy with the same text (or parting
  only at a bf16 tie), the port's group admitted as one prefill.
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.cache import (
    PagedKVCache as JCache,
)
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.serve.app import (
    create_app as jcreate_app,
)
from scalable_hw_agnostic_inference_tpu.serve.httpd import Server as JServer
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import PagedKVCache
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.loop import EngineLoop
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402
from test_torch_openai import (  # noqa: E402
    _http,
    _port_service,
    _same_or_tie,
    _wait_ready,
)

# the oracle's engine shapes, with four slots for a group of three
ENGINE_KW = dict(max_model_len=128, max_num_seqs=4, block_size=8,
                 context_encoding_buckets=(16, 32),
                 token_generation_buckets=(32, 64), max_new_tokens=16)
PROMPT = [7, 3] * 9            # 18 tokens: a shared partial tail block
# the group's first logprobs come from a one-row prefill, the independent
# requests' from a Kp-row one: fp32 logits a few ulps apart (the oracle's
# own tolerance)
LP_ATOL = 1e-5
SAMPLING = {
    "greedy": dict(temperature=0.0, max_new_tokens=8, logprobs=2),
    "topk": dict(temperature=0.9, top_k=5, max_new_tokens=8),
    "topp": dict(temperature=0.7, top_p=0.8, max_new_tokens=8),
}


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


def _switches(monkeypatch, cow, fused, quant, async_on):
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_on else "0")
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "1")
    monkeypatch.setenv("SHAI_FUSED_STEP", "1" if fused else "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8" if quant else "")
    monkeypatch.setenv("SHAI_KV_COW", "1" if cow else "0")
    # the JAX engine's pool kernels in interpret mode
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")


def _port(tiny, monkeypatch, cow=True, fused=False, quant=False,
          async_on=True, **over):
    _, _, tcfg, model = tiny
    _switches(monkeypatch, cow, fused, quant, async_on)
    eng = LLMEngine(tcfg, model,
                    tconfig.EngineConfig(**dict(ENGINE_KW, **over)),
                    device="cpu")
    assert eng._kv_cow is cow and eng._fused is fused
    return eng


def _jax(tiny, monkeypatch, cow=True, **over):
    jcfg, params, _, _ = tiny
    _switches(monkeypatch, cow, False, False, True)
    eng = JEngine(jcfg, params,
                  jconfig.EngineConfig(**dict(ENGINE_KW, **over)))
    assert eng._kv_cow is cow
    return eng


def _run(eng, rids):
    want, done = set(rids), {}
    while want - set(done):
        for f in eng.step():
            done[f.req_id] = f
    return [done[r] for r in rids]


def _fanout(eng, prompt, sp, k):
    rid0 = eng.add_request(prompt, sp, parent_rid=-2)
    return [rid0] + [eng.add_request(prompt, sp, parent_rid=rid0)
                     for _ in range(k - 1)]


def _assert_pool_whole(eng):
    assert eng.cache.leaked_blocks == 0
    assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1


def _assert_finished_equal(a, b):
    """Tokens and stop reasons equal; logprob entries name the same tokens
    with values within ``LP_ATOL``."""
    assert a.token_ids == b.token_ids, (a.req_id, a.token_ids, b.token_ids)
    assert a.stop_reason == b.stop_reason
    if a.logprobs is None or b.logprobs is None:
        assert a.logprobs == b.logprobs
        return
    assert len(a.logprobs) == len(b.logprobs)
    for e1, e2 in zip(a.logprobs, b.logprobs):
        assert e1["token"] == e2["token"]
        assert e1["logprob"] == pytest.approx(e2["logprob"], abs=LP_ATOL)


# -- the cache -----------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_fork_and_copy_on_write_match_the_jax_cache(quant):
    """Fork a 12-token sequence (a full block and a partial tail) twice,
    grow every holder, release them all: the same blocks, refcounts and
    counters as the JAX cache; each copy in place, byte for byte."""
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=16, total_blocks=10,
              block_size=8, blocks_per_seq=4, quant=quant)
    t = PagedKVCache(**kw, device="cpu")
    j = JCache(**kw)
    gen = torch.Generator().manual_seed(0)
    for lay in t.kv:
        for x in lay.values():
            x.copy_(torch.randint(-100, 100, x.shape, generator=gen)
                    .to(x.dtype))
    ptrs = [x.data_ptr() for lay in t.kv for x in lay.values()]

    def same():
        for sid in (0, 1, 2):
            if sid in j._seqs:
                assert t.seq(sid).blocks == j.seq(sid).blocks
                assert t.seq(sid).n_tokens == j.seq(sid).n_tokens
        for b in range(kw["total_blocks"]):
            assert t.allocator.refcount(b) == j.allocator.refcount(b)
        assert (t.cow_forks, t.cow_copies) == (j.cow_forks, j.cow_copies)
        assert t.allocator.n_free == j.allocator.n_free
        assert t.leaked_blocks == j.leaked_blocks == 0

    for c in (t, j):
        c.admit(0, 12)
        c.fork_sequence(0, 1)
        c.fork_sequence(0, 2)
    same()
    assert t.allocator.refcount(t.seq(0).blocks[1]) == 3
    # a shared partial tail: the first write prices and makes a copy
    assert t.blocks_to_extend(1, 1) == j.blocks_to_extend(1, 1) == 1
    src = t.seq(1).blocks[1]
    for c in (t, j):
        c.extend(1, 1)
    same()
    dst = t.seq(1).blocks[1]
    assert dst != src
    for lay in t.kv:
        for x in lay.values():
            assert torch.equal(x[dst], x[src])
    for c in (t, j):
        c.extend(2, 1)      # the second writer copies too
        c.extend(0, 1)      # the last holder writes in place
        c.extend(0, 8)      # and grows a fresh block
    same()
    assert t.cow_copies == 2 and t.seq(0).blocks[1] == src
    assert [x.data_ptr() for lay in t.kv for x in lay.values()] == ptrs
    for sid in (1, 0, 2):
        for c in (t, j):
            c.release(sid)
    assert t.allocator.n_free == kw["total_blocks"] - 1
    assert t.leaked_blocks == 0


def test_forked_full_blocks_are_never_copied():
    """A prompt of whole blocks: the first write opens a fresh block, so
    no holder copies."""
    t = PagedKVCache(1, 1, 16, 8, 8, 4, device="cpu")
    t.admit(0, 16)
    t.fork_sequence(0, 1)
    assert t.blocks_to_extend(1, 1) == 1
    t.extend(1, 1)
    t.extend(0, 1)
    assert t.cow_copies == 0 and t.cow_forks == 1
    assert t.seq(0).blocks[:2] == t.seq(1).blocks[:2]
    assert t.seq(0).blocks[2] != t.seq(1).blocks[2]


# -- the engine -----------------------------------------------------------------

@pytest.mark.parametrize("async_on", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("mode", list(SAMPLING))
def test_cow_fanout_matches_independent(tiny, monkeypatch, mode, async_on):
    sp = SamplingParams(**SAMPLING[mode])
    a = _port(tiny, monkeypatch, cow=True, async_on=async_on)
    fa = _run(a, _fanout(a, PROMPT, sp, 3))
    b = _port(tiny, monkeypatch, cow=False, async_on=async_on)
    fb = _run(b, [b.add_request(PROMPT, sp) for _ in range(3)])
    for x, y in zip(fa, fb):
        _assert_finished_equal(x, y)
    # one prefill: the group shared the prompt and copied its tail lazily
    assert (a.cache.cow_forks, a.cache.cow_copies) == (2, 2)
    assert (32, 1) in a._prefill
    _assert_pool_whole(a)
    _assert_pool_whole(b)


def test_cow_fanout_greedy_matches_jax(tiny, monkeypatch):
    sp = SAMPLING["greedy"]
    t = _port(tiny, monkeypatch)
    got = _run(t, _fanout(t, PROMPT, SamplingParams(**sp), 3))
    j = _jax(tiny, monkeypatch)
    want = _run(j, _fanout(j, PROMPT, JParams(**sp), 3))
    assert_greedy_parity(got, want, label="CoW fan-out")
    assert t.cache.cow_forks == j.cache.cow_forks == 2
    assert t.cache.cow_copies == j.cache.cow_copies
    _assert_pool_whole(t)
    assert j.cache.leaked_blocks == 0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_cow_fanout_under_fused_step(tiny, monkeypatch, quant):
    """The two halves compose: a fan-out group on the fused engine against
    independent requests on the laddered one, sampled rows exact."""
    sp = SamplingParams(**SAMPLING["topk"])
    a = _port(tiny, monkeypatch, cow=True, fused=True, quant=quant)
    fa = _run(a, _fanout(a, PROMPT, sp, 3))
    b = _port(tiny, monkeypatch, cow=False, quant=quant)
    fb = _run(b, [b.add_request(PROMPT, sp) for _ in range(3)])
    for x, y in zip(fa, fb):
        _assert_finished_equal(x, y)
    assert a.cache.cow_forks == 2
    _assert_pool_whole(a)


@pytest.mark.parametrize("fused", [False, True], ids=["laddered", "fused"])
def test_cow_fanout_pool_exact_under_cancel_evict_fuzz(tiny, monkeypatch,
                                                       fused):
    """Seeded fuzz on a small pool: fan-out groups and fillers, long
    prompts that chunk, random cancels of members; the refcounted shared
    blocks release pool-exactly whatever order their holders die in."""
    rng = np.random.default_rng(42)
    sp = SamplingParams(temperature=0.8, top_k=4, max_new_tokens=10)
    eng = _port(tiny, monkeypatch, fused=fused, num_blocks=24)
    live, forks = [], 0
    for _ in range(60):
        if rng.random() < 0.35 and len(live) < 8:
            prompt = rng.integers(3, 200, int(rng.integers(3, 40))).tolist()
            if rng.random() < 0.6:
                live += _fanout(eng, prompt, sp, int(rng.integers(2, 4)))
            else:
                live.append(eng.add_request(prompt, sp))
        if rng.random() < 0.2 and live:
            eng.cancel(live[int(rng.integers(len(live)))])
        for f in eng.step():
            if f.req_id in live:
                live.remove(f.req_id)
        forks = eng.cache.cow_forks
        assert eng.cache.leaked_blocks == 0
    while eng.has_work:
        eng.step()
    eng.finish_pending()
    assert forks > 0
    _assert_pool_whole(eng)
    assert not eng._fanout_groups and not eng._rid_parent


def test_fanout_siblings_and_finish_prune(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    for eng in (_port(tiny, monkeypatch), _jax(tiny, monkeypatch)):
        if isinstance(eng, JEngine):
            sp = JParams(temperature=0.0, max_new_tokens=4)
        rids = _fanout(eng, [7, 3] * 5, sp, 3)
        assert eng.fanout_siblings(rids[1]) == sorted(rids)
        assert eng.fanout_siblings(12345) == [12345]  # non-member: itself
        _run(eng, rids)
        # finishing pruned the group maps: no unbounded growth
        assert not eng._fanout_groups and not eng._rid_parent


def test_cancel_of_any_member_aborts_group_via_loop(tiny, monkeypatch):
    """One ``n > 1`` request is one deliverable: cancelling any member's
    future aborts the whole group, pool-exactly."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=16)
    eng = _port(tiny, monkeypatch)
    loop = EngineLoop(eng).start()
    try:
        futs = loop.submit_group([5, 2] * 8, [sp] * 3)
        deadline = time.monotonic() + 10
        while not eng.has_work and time.monotonic() < deadline:
            time.sleep(0.01)  # wait for admission
        loop.cancel(futs[1])
        fins = [f.result(timeout=60) for f in futs]
        assert all(f.stop_reason == "cancelled" for f in fins)
        deadline = time.monotonic() + 10
        while eng.has_work and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.cache.leaked_blocks == 0
        assert not eng._fanout_groups and not eng._rid_parent
    finally:
        loop.stop()


def test_group_deadline_expires_every_member(tiny, monkeypatch):
    """A group's members share its deadline: all finish as ``timeout``."""
    eng = _port(tiny, monkeypatch)
    loop = EngineLoop(eng).start()
    try:
        futs = loop.submit_group(PROMPT, [SamplingParams(
            temperature=0.0, max_new_tokens=16)] * 3,
            deadline_at=time.monotonic() - 1.0)
        fins = [f.result(timeout=60) for f in futs]
        assert [f.stop_reason for f in fins] == ["timeout"] * 3
        assert eng.cache.leaked_blocks == 0 and not eng._rid_parent
    finally:
        loop.stop()


@pytest.mark.parametrize("cow", [True, False], ids=["cow", "no-cow"])
def test_submit_group_token_exact_vs_n_submits(tiny, monkeypatch, cow):
    """The serving seam: one group submit equals n independent submits,
    token for token, sampled rows included (with the switch off the group
    still rides one queue item and joins one batch)."""
    sp = SamplingParams(**SAMPLING["topk"])
    a = _port(tiny, monkeypatch, cow=cow)
    la = EngineLoop(a).start()
    try:
        fa = [f.result(timeout=120) for f in la.submit_group(PROMPT,
                                                             [sp] * 3)]
    finally:
        la.stop()
    b = _port(tiny, monkeypatch, cow=False)
    lb = EngineLoop(b).start()
    try:
        fb = [f.result(timeout=120)
              for f in [lb.submit(PROMPT, sp) for _ in range(3)]]
    finally:
        lb.stop()
    for x, y in zip(fa, fb):
        assert x.token_ids == y.token_ids and x.stop_reason == y.stop_reason
    assert a.cache.cow_forks == (2 if cow else 0)


def test_fanout_not_admitted_when_prompts_arrive_split(tiny, monkeypatch):
    """Group admission needs the whole group queued: a member arriving
    after its leader was admitted is admitted on its own."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    prompt = [7, 3] * 5
    eng = _port(tiny, monkeypatch)
    rid0 = eng.add_request(prompt, sp, parent_rid=-2)
    eng.step()  # the leader admits alone
    rid1 = eng.add_request(prompt, sp, parent_rid=rid0)
    fins = _run(eng, [rid0, rid1])
    assert fins[0].token_ids == fins[1].token_ids  # greedy, same prompt
    assert eng.cache.cow_forks == 0
    _assert_pool_whole(eng)


# -- over sockets -----------------------------------------------------------------

def test_openai_n3_matches_the_jax_pod_under_cow(tmp_path, monkeypatch):
    """A JAX pod and a port pod, both under ``SHAI_KV_COW=1``: ``n=3``
    greedy completions give the same three texts, the port's group admitted
    as one prefill with two forks."""
    monkeypatch.setenv("SHAI_KV_COW", "1")
    jcfg = JServeConfig(app="vllm", device="cpu", model_id="tiny",
                        batch_size=4, max_new_tokens=32,
                        vllm_config=str(tmp_path / "absent.yaml"))
    jsrv = JServer(jcreate_app(jcfg, get_model("vllm")(jcfg)),
                   host="127.0.0.1", port=0)
    cfg, service = _port_service(tmp_path)
    tsrv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    jh, jp = jsrv.start_background()
    th, tp = tsrv.start_background()
    ref, port = f"http://{jh}:{jp}", f"http://{th}:{tp}"
    try:
        _wait_ready(ref)
        _wait_ready(port)
        eng = service._engine
        assert eng._kv_cow
        body = {"prompt": "the quick brown fox", "max_tokens": 8,
                "temperature": 0, "n": 3}
        status, want = _http(ref + "/v1/completions", body)
        assert status == 200, want
        status, got = _http(port + "/v1/completions", body)
        assert status == 200, got
        texts = [c["text"] for c in got["choices"]]
        assert len(texts) == 3 and len(set(texts)) == 1   # greedy siblings
        assert got["usage"] == want["usage"]
        _same_or_tie(ref, port, body["prompt"], 8, texts[0],
                     want["choices"][0]["text"], "n=3 under CoW")
        assert eng.cache.cow_forks == 2
        assert eng.cache.leaked_blocks == 0
    finally:
        tsrv.stop()
        jsrv.stop()
