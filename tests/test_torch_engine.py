"""The port's engine against the JAX package's ``LLMEngine``, on the CPU.

Both engines serve the same weights (a flax init carried over with
``params_from_jax``). The JAX engine runs lock-step (``SHAI_ASYNC_DECODE=0``,
its own oracle discipline) with its Pallas paged-decode kernel in interpret
mode (``SHAI_PAGED_DECODE=1``), as ``tests/test_engine.py`` runs it; the port
decodes through B2's plain version. Greedy tokens are held to the reference
with ``tests/parity.py``'s ``assert_greedy_parity``: equal, or diverging only
where the reference's top-2 logit gap is under 3e-2 (a bf16 tie). Block
accounting is exact: no leaked block, the whole pool free at the end.
"""

import dataclasses
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine import types as jtypes
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine import types as ttypes
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import (
    BlockAllocator,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.loop import EngineLoop
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=16,
                 context_encoding_buckets=(16, 32, 64),
                 token_generation_buckets=(32, 64), max_new_tokens=16)


def _both(tiny, monkeypatch, prompts, new_tokens, **over):
    """Run the same greedy requests through both engines."""
    jcfg, params, tcfg, model = tiny
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "0")
    kw = dict(ENGINE_KW, **over)
    jeng = JEngine(jcfg, params, jconfig.EngineConfig(**kw))
    want = jeng.generate(prompts, JParams(temperature=0.0, logprobs=2,
                                          max_new_tokens=new_tokens))
    teng = LLMEngine(tcfg, model, tconfig.EngineConfig(**kw), device="cpu")
    got = teng.generate(prompts, SamplingParams(temperature=0.0,
                                                max_new_tokens=new_tokens))
    return teng, got, jeng, want


def _assert_pool_whole(eng):
    assert eng.cache.leaked_blocks == 0
    assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1


def test_engine_greedy_matches_jax_engine(tiny, monkeypatch):
    """3 prompts of mixed length: two share a prefill bucket and are
    admitted as one batched prefill, the third takes the next bucket; the
    decode batch and context buckets change as they run."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, n).tolist() for n in (5, 12, 40)]
    teng, got, jeng, want = _both(tiny, monkeypatch, prompts, 10)
    assert [len(f.token_ids) for f in got] == [10, 10, 10]
    assert [f.stop_reason for f in got] == [f.stop_reason for f in want]
    assert [f.n_prompt for f in got] == [5, 12, 40]
    assert_greedy_parity(got, want, label="engine")
    _assert_pool_whole(teng)
    assert jeng.cache.leaked_blocks == 0


def test_engine_preemption_matches_jax_engine(tiny, monkeypatch, caplog):
    """A pool of 5 usable blocks cannot hold 3 sequences past their first
    block: the engine recompute-preempts, and every request still finishes
    with the reference's tokens and a whole pool."""
    prompts = [[1, 5, 9, 11], [1, 200, 300], [2, 7, 9, 13, 15]]
    with caplog.at_level(logging.WARNING):
        teng, got, jeng, want = _both(tiny, monkeypatch, prompts, 20,
                                      block_size=8, max_model_len=64,
                                      context_encoding_buckets=(16, 32),
                                      token_generation_buckets=(),
                                      num_blocks=6, max_new_tokens=20)
    assert any("preempting seq" in r.getMessage() for r in caplog.records
               if r.name.endswith("engine.engine")
               and "tpu_torch" in r.name)
    assert [f.stop_reason for f in got] == ["length"] * 3
    assert all(len(f.token_ids) == 20 for f in got)
    assert_greedy_parity(got, want, label="preemption")
    _assert_pool_whole(teng)


def test_engine_eos_and_cancel(tiny):
    _, _, tcfg, model = tiny
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                    device="cpu")
    [probe] = eng.generate([[1, 17, 42]], SamplingParams(temperature=0.0,
                                                         max_new_tokens=3))
    [fin] = eng.generate([[1, 17, 42]], SamplingParams(
        temperature=0.0, max_new_tokens=8, eos_id=probe.token_ids[0]))
    assert fin.stop_reason == "eos" and fin.token_ids == []
    rid = eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=8))
    queued = eng.add_request([4, 5], SamplingParams(max_new_tokens=8))
    eng.step()
    assert eng.cancel(queued).stop_reason == "cancelled"
    fin = eng.cancel(rid)
    assert fin.stop_reason == "cancelled" and eng.cancel(rid) is None
    _assert_pool_whole(eng)


def test_engine_refuses_what_later_slices_bring(tiny):
    _, _, tcfg, model = tiny
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                    device="cpu")
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng.add_request(list(range(3, 3 + 65)))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request([])
    with pytest.raises(ValueError, match="logprobs"):
        eng.add_request([1, 2], SamplingParams(logprobs=2))
    with pytest.raises(ValueError, match="not ported yet"):
        LLMEngine(tcfg, model, tconfig.EngineConfig(
            **dict(ENGINE_KW, enable_prefix_caching=True)), device="cpu")


def test_engine_sampled_requests_finish(tiny):
    """Sampling (temperature, top-k, top-p) draws from the engine's seeded
    generator: the same seed gives the same tokens."""
    _, _, tcfg, model = tiny
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                        max_new_tokens=6)
    runs = []
    for _ in range(2):
        eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                        device="cpu")
        runs.append([f.token_ids for f in eng.generate([[1, 2, 3], [9]], sp)])
        _assert_pool_whole(eng)
    assert runs[0] == runs[1]
    assert all(len(t) == 6 for t in runs[0])


def test_engine_loop_submit_cancel_drain(tiny):
    _, _, tcfg, model = tiny
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                    device="cpu")
    loop = EngineLoop(eng).start()
    try:
        sp = SamplingParams(temperature=0.0, max_new_tokens=5)
        streamed = []
        futs = [loop.submit([1, 2, 3], sp, on_token=streamed.append),
                loop.submit([7, 8], sp)]
        fins = [f.result(timeout=60) for f in futs]
        assert [len(f.token_ids) for f in fins] == [5, 5]
        assert streamed == fins[0].token_ids
        slow = loop.submit([4, 4], SamplingParams(max_new_tokens=16))
        loop.cancel(slow)
        assert slow.result(timeout=60).stop_reason in ("cancelled", "length")
        with pytest.raises(ValueError):
            loop.submit([], sp).result(timeout=60)
        assert loop.drain(budget_s=30.0)
        with pytest.raises(RuntimeError, match="stopped|draining"):
            loop.submit([1], sp)
    finally:
        loop.stop()
    assert not loop.alive and not loop._thread.is_alive()
    _assert_pool_whole(eng)


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = "<required>"
    return out


@pytest.mark.parametrize("jcls,tcls", [
    (jconfig.EngineConfig, tconfig.EngineConfig),
    (jtypes.SamplingParams, ttypes.SamplingParams),
    (jtypes.Request, ttypes.Request),
    (jtypes.Finished, ttypes.Finished),
    (jtypes._Running, ttypes._Running),
])
def test_engine_types_match_reference_field_for_field(jcls, tcls):
    assert _fields(tcls) == _fields(jcls)


def test_engine_config_contract_matches_reference():
    d = {"model": "m", "max_model_len": 256, "block_size": 16,
         "max_num_seqs": 4, "context_encoding_buckets": [32, 128],
         "device": "neuron", "tensor_parallel_size": 2}
    j, t = jconfig.EngineConfig.from_dict(d), tconfig.EngineConfig.from_dict(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.ignored_keys == j.ignored_keys == ("device",)
    assert (t.blocks_per_seq, t.total_blocks) == (16, 64)
    for bad in (dict(max_model_len=100), dict(context_encoding_buckets=(30,),
                                              max_model_len=64)):
        with pytest.raises(ValueError):
            jconfig.EngineConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.EngineConfig(**bad)
    sp = ttypes.SamplingParams(top_k=500, logprobs=9, max_new_tokens=999)
    assert dataclasses.asdict(sp.clamp(t)) == dataclasses.asdict(
        jtypes.SamplingParams(top_k=500, logprobs=9,
                              max_new_tokens=999).clamp(j))


def test_block_allocator_lifecycle():
    a = BlockAllocator(8)
    assert a.n_free == 7  # block 0 reserved
    blocks = a.alloc(3)
    assert len(set(blocks)) == 3 and 0 not in blocks
    with pytest.raises(MemoryError):
        a.alloc(5)
    a.free(blocks)
    assert a.n_free == 7
    with pytest.raises(ValueError):
        a.free(blocks)  # double free
    with pytest.raises(ValueError):
        a.free([0])


def test_paged_cache_accounting():
    from scalable_hw_agnostic_inference_tpu_torch.engine.cache import (
        PagedKVCache,
    )

    c = PagedKVCache(2, 2, 16, total_blocks=9, block_size=4,
                     blocks_per_seq=4, device=torch.device("cpu"))
    assert c.kv[0]["k"].shape == (9, 4, 2, 16)
    assert c.kv[0]["k"].dtype == torch.bfloat16
    a = c.admit(1, 5)                      # 2 blocks
    assert len(a.blocks) == 2 and c.blocks_to_extend(1, 3) == 0
    assert c.blocks_to_extend(1, 4) == 1
    c.extend(1, 7)                         # 12 tokens: 3 blocks
    assert len(c.seq(1).blocks) == 3
    with pytest.raises(MemoryError, match="max_model_len"):
        c.extend(1, 5)
    assert list(c.seq(1).table(4)[:3]) == c.seq(1).blocks
    c.admit(2, 1)
    assert c.n_available == 4 and c.leaked_blocks == 0
    c.release(1)
    c.release(2)
    assert c.n_available == 8 and c.leaked_blocks == 0
