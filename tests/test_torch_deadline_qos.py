"""Deadlines and QoS in the port's engine against the JAX engine, on the
CPU.

Port of the engine halves of ``tests/test_resilience.py`` (deadlines) and
``tests/test_qos.py`` (the weighted-fair dequeue and the priority-keyed
preemption victim). What is held:

- a request past its deadline finishes as ``"timeout"`` from the queue,
  from mid-chunk and from decode, under both disciplines, with the tokens
  it had and its blocks released (``leaked_blocks == 0``); the JAX engine
  cuts the same request at the same step with the same tokens;
- with the lookahead in flight, a due deadline flushes the pipeline under
  the reason ``deadline``, once, as in the JAX engine;
- under ``SHAI_QOS=1`` a queue tagged high, normal and low is admitted in
  the same order by both engines (not FIFO), and FIFO without it;
- the recompute-preemption victim is the lowest priority under
  ``SHAI_QOS=1`` and the most recent request without it, in both engines;
- ``EngineLoop.submit`` carries the deadline and the tag to the engine.
"""

import dataclasses
import sys
import time
from pathlib import Path

import pytest

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
from scalable_hw_agnostic_inference_tpu_torch.engine.loop import EngineLoop
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.resilience import qos

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401

ENGINE_KW = dict(max_model_len=64, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16)
LONG = list(range(3, 43))   # 40 tokens: chunks 32 + 8 under buckets (16, 32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


def _engines(tiny, monkeypatch, async_on, qos_on=False, **over):
    """The port's and the JAX engine under the same switches."""
    jcfg, params, tcfg, model = tiny
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_on else "0")
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    if qos_on:
        monkeypatch.setenv("SHAI_QOS", "1")
    else:
        monkeypatch.delenv("SHAI_QOS", raising=False)
    kw = dict(ENGINE_KW, **over)
    port = LLMEngine(tcfg, model, tconfig.EngineConfig(**kw), device="cpu")
    ref = JEngine(jcfg, params, jconfig.EngineConfig(**kw))
    return port, ref


def _sp(cls, new=12):
    return cls(temperature=0.0, max_new_tokens=new)


def _expire(eng, rid):
    """Move request ``rid``'s deadline into the past, wherever it is."""
    for r in eng.waiting:
        if r.req_id == rid:
            r.deadline_at = time.monotonic() - 1e-3
    for s in eng.slots:
        if s is not None and s.req.req_id == rid:
            s.req.deadline_at = time.monotonic() - 1e-3


def _cut_at(eng, params, where):
    """Drive ``eng``: a short request beside the victim (a short prompt,
    or a 40-token one for ``chunk``); the victim's deadline passes while
    it is queued, mid-chunk, or after four decode steps. Returns the
    victim's Finished and the step it finished at, and the other's."""
    keep = eng.add_request([1, 5, 9], params)
    prompt = LONG if where == "chunk" else [2, 7, 11]
    far = time.monotonic() + 3600.0
    if where == "queue":
        rid = eng.add_request(prompt, params,
                              deadline_at=time.monotonic() - 1e-3)
    else:
        rid = eng.add_request(prompt, params, deadline_at=far)
    cut_step = {"queue": 0, "chunk": 2, "decode": 4}[where]
    fins, step = {}, 0
    while eng.has_work:
        if step == cut_step and where != "queue":
            if where == "chunk":
                assert eng.n_chunking == 1, "the victim is not mid-chunk"
            _expire(eng, rid)
        for f in eng.step():
            fins[f.req_id] = (f, step)
        step += 1
    return fins[rid], fins[keep]


@pytest.mark.parametrize("async_on", [True, False], ids=["async", "lockstep"])
@pytest.mark.parametrize("where", ["queue", "chunk", "decode"])
def test_expired_deadline_finishes_as_timeout(tiny, monkeypatch, where,
                                              async_on):
    port, ref = _engines(tiny, monkeypatch, async_on)
    (fin, at), (kept, _) = _cut_at(port, _sp(SamplingParams), where)
    assert fin.stop_reason == "timeout"
    assert kept.stop_reason == "length" and len(kept.token_ids) == 12
    if where in ("queue", "chunk"):
        assert fin.token_ids == []
    else:
        # steps 0 to 3 each committed one token (step 0 the prefill's)
        assert len(fin.token_ids) == 4
    assert port.cache.leaked_blocks == 0
    assert port.cache.allocator.n_free == port.ecfg.total_blocks - 1
    (jfin, jat), (jkept, _) = _cut_at(ref, _sp(JParams), where)
    assert jfin.stop_reason == "timeout" and jat == at
    assert jfin.token_ids == fin.token_ids
    assert jkept.token_ids == kept.token_ids
    if async_on and where != "queue":
        assert port.obs.flush_reasons().get("deadline") == 1
        assert ref.obs.flush_reasons().get("deadline") == 1


def test_loop_submit_carries_the_deadline_and_the_tag(tiny, monkeypatch):
    port, _ = _engines(tiny, monkeypatch, True)
    seen = []
    add = port.add_request

    def spy(ids, params=None, on_token=None, **kw):
        seen.append(kw)
        return add(ids, params, on_token=on_token, **kw)

    port.add_request = spy
    loop = EngineLoop(port).start()
    try:
        late = loop.submit([1, 2, 3], _sp(SamplingParams),
                           deadline_at=time.monotonic() - 1e-3,
                           priority=qos.PRIORITY_HIGH, tenant="acme")
        ok = loop.submit([4, 5], _sp(SamplingParams, 4))
        assert late.result(timeout=60).stop_reason == "timeout"
        assert ok.result(timeout=60).stop_reason == "length"
    finally:
        loop.stop()
    assert seen[0]["priority"] == qos.PRIORITY_HIGH
    assert seen[0]["tenant"] == "acme"
    assert seen[1] == {"deadline_at": 0.0, "priority": qos.PRIORITY_NORMAL,
                       "tenant": ""}
    assert port.cache.leaked_blocks == 0


def _admission_order(eng, cls, prios):
    """Queue one request per priority before any step, one slot: the
    order in which they reach the slot."""
    for i, p in enumerate(prios):
        eng.add_request([3 + i, 9], _sp(cls, 2), priority=p)
    order = []
    while eng.has_work:
        eng.step()
        for s in eng.slots:
            if s is not None and s.req.req_id not in order:
                order.append(s.req.req_id)
    return order


PRIOS = [2, 2, 1, 0, 2, 0, 1, 2]


@pytest.mark.parametrize("qos_on", [True, False], ids=["qos", "fifo"])
def test_tagged_queue_admits_in_the_same_order(tiny, monkeypatch, qos_on):
    port, ref = _engines(tiny, monkeypatch, True, qos_on, max_num_seqs=1)
    assert (port._sched is not None) is qos_on
    got = _admission_order(port, SamplingParams, PRIOS)
    want = _admission_order(ref, JParams, PRIOS)
    assert got == want
    fifo = list(range(len(PRIOS)))
    assert (got != fifo) is qos_on
    if qos_on:
        # the stride scheduler serves the high class first
        assert PRIOS[got[0]] == qos.PRIORITY_HIGH
    assert port.cache.leaked_blocks == 0


@pytest.mark.parametrize("qos_on", [True, False], ids=["qos", "fifo"])
def test_preemption_victim_follows_priority_only_under_qos(
        tiny, monkeypatch, qos_on):
    """Two requests decoding, the older one low priority: under QoS the
    low one is preempted, otherwise the most recent; both engines pick the
    same victim, and it goes back to the queue head (untagged in both:
    the reference's resume request carries no priority)."""
    picks = []
    for eng in _engines(tiny, monkeypatch, False, qos_on):
        cls = SamplingParams if isinstance(eng, LLMEngine) else JParams
        low = eng.add_request([3, 4, 5], _sp(cls), priority=qos.PRIORITY_LOW)
        high = eng.add_request([6, 7, 8], _sp(cls),
                               priority=qos.PRIORITY_HIGH)
        eng.step()
        assert sum(s is not None for s in eng.slots) == 2
        eng._preempt_lowest()
        victim = eng.waiting[0]
        assert victim.req_id == (low if qos_on else high)
        picks.append((victim.req_id, victim.priority, victim.tenant))
        while eng.has_work:
            eng.step()
        assert eng.cache.leaked_blocks == 0
    assert picks[0] == picks[1]


def test_weighted_fair_scheduler_matches_the_reference():
    """The port's copy of the stride scheduler picks what the reference's
    picks, over a long contended run with aging."""
    from scalable_hw_agnostic_inference_tpu.resilience import qos as jqos

    a = qos.WeightedFairScheduler(aging_rounds=5)
    b = jqos.WeightedFairScheduler(aging_rounds=5)
    classes = [[0, 1, 2], [1, 2], [0, 2], [2], [0, 1, 2]] * 40
    assert [a.select(c) for c in classes] == [b.select(c) for c in classes]
    assert a.aged_picks == b.aged_picks
    for raw in ("high", "LOW", "1", "7", "bogus", None):
        assert qos.parse_priority(raw) == jqos.parse_priority(raw)
    assert qos.sanitize_tenant("a b/c\nd" * 20) == \
        jqos.sanitize_tenant("a b/c\nd" * 20)
