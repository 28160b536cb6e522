"""The port's host KV tier against the JAX package's, on the CPU.

Port of ``tests/test_kvtier.py``. The tier changes WHERE KV bytes come
from, never what is generated, nor the pool's arithmetic. What is held:

- the host pool (``kvtier/pool.py``): bounded-LRU accounting, the
  byte-exact round trip, a zero capacity refusing and counting, probe
  hits and misses, the async copy-out worker, ``close`` joining it and
  turning late demotions into counted drops, a second close; a bf16 pool
  stores 16-bit words whose dtype carries the wire name ``bfloat16``;
- the movers (``kvtier/restore.py``): the demotion gather gives the JAX
  package's ``make_tier_gather`` bytes on the same pool, bf16 and int8
  (the scale rows beside the blocks), into fresh tensors; the restore
  writes the pool tensors IN PLACE (their addresses unchanged) and gives
  ``make_tier_restore``'s pools byte for byte, padding rows into block 0;
- the engine: tier on equals tier off token for token (greedy eviction
  replays, both decode disciplines, preemption, the async copy-out
  worker), a restore equals the device hit it replaces sampled rows
  included under one seed, a replay after eviction restores instead of
  prefilling, preemption offloads to the tier, a failing restore
  degrades to recompute, and a seeded cancel/evict fuzz ends with exact
  device and host accounting (``leaked_blocks == 0``); greedy tokens with
  the tier on are held to the JAX engine with the tier on with
  ``tests/parity.py``'s ``assert_greedy_parity``; chunked prefill
  registers its blocks per chunk;
- telemetry: the engine snapshot's ``host_kv_*`` gauges, the
  ``shai_kvtier_*`` families with the JAX collector's names, types and
  help (the port's text parsed with ``prometheus_client``), the HBM
  ledger's host pool outside the device attribution; the affinity digest
  equals the JAX package's and the tracker is a bounded LRU.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from prometheus_client.parser import text_string_to_metric_families

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.kvtier import affinity as jaff
from scalable_hw_agnostic_inference_tpu.kvtier import restore as jrestore
from scalable_hw_agnostic_inference_tpu.kvtier.pool import (
    HostKVTier as JTier,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.obs.steploop import (
    StepTelemetry as JTelemetry,
)
from scalable_hw_agnostic_inference_tpu.serve.metrics import (
    EngineTelemetryCollector,
)
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import PagedKVCache
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.kvnet import frames
from scalable_hw_agnostic_inference_tpu_torch.kvtier import restore
from scalable_hw_agnostic_inference_tpu_torch.kvtier.affinity import (
    AffinityTracker,
    prompt_affinity,
)
from scalable_hw_agnostic_inference_tpu_torch.kvtier.pool import HostKVTier
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.obs.hbm import HbmLedger
from scalable_hw_agnostic_inference_tpu_torch.obs.steploop import (
    StepTelemetry,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.metrics import (
    Exposition,
    engine_families,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402

# the oracle's engine shapes (tests/test_kvtier.py)
ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=16,
                 enable_prefix_caching=True)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


def make_engine(tiny, monkeypatch, tier=True, tier_async=False,
                async_decode=None, **over):
    _, _, tcfg, model = tiny
    monkeypatch.setenv("SHAI_KVTIER", "1" if tier else "0")
    monkeypatch.setenv("SHAI_KVTIER_ASYNC", "1" if tier_async else "0")
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "")
    monkeypatch.setenv("SHAI_FUSED_STEP", "0")
    if async_decode is not None:
        monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_decode else "0")
    return LLMEngine(tcfg, model,
                     tconfig.EngineConfig(**dict(ENGINE_KW, **over)),
                     device="cpu")


def _prompts(seed, n, length=40):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(2, 500, length)] for _ in range(n)]


def _run_all(eng, prompts, sp):
    ids = [eng.add_request(list(p), sp) for p in prompts]
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    eng.finish_pending()
    return [done[i] for i in ids]


def _assert_pool_exact(eng):
    """Device accounting closes (every allocated block is the prefix
    cache's, none leaks); host accounting closes (``used_bytes == entries
    * block_nbytes``)."""
    cache = eng.cache
    assert cache.active == []
    used = (cache.total_blocks - 1) - cache.allocator.n_free
    assert used == len(cache._block2hash)
    assert cache.leaked_blocks == 0
    if cache.tier is not None:
        cache.tier.drain()
        snap = cache.tier.snapshot()
        assert snap["used_bytes"] == snap["entries"] * snap["block_nbytes"]
        assert snap["used_bytes"] <= snap["capacity_bytes"]


def _differential(tiny, monkeypatch, sp, seed=2, n=4, rounds=2,
                  tier_async=False, async_decode=None, **over):
    prompts = _prompts(seed, n)
    off = make_engine(tiny, monkeypatch, tier=False,
                      async_decode=async_decode, **over)
    want = [[f.token_ids for f in _run_all(off, prompts, sp)]
            for _ in range(rounds)]
    on = make_engine(tiny, monkeypatch, tier=True, tier_async=tier_async,
                     async_decode=async_decode, **over)
    got = [[f.token_ids for f in _run_all(on, prompts, sp)]
           for _ in range(rounds)]
    assert got == want
    _assert_pool_exact(on)
    return on


# -- the engine: tier on == tier off --------------------------------------------

def test_differential_greedy_eviction_replay(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    eng = _differential(tiny, monkeypatch, sp, num_blocks=16, max_num_seqs=1)
    snap = eng.cache.tier.snapshot()
    assert snap["stores"] > 0 and snap["restored"] > 0


def test_differential_sampled_restore_vs_device_hit(tiny, monkeypatch):
    """A host-tier restore is byte-identical to the device hit it replaces:
    the same admission path and draws, so sampled tokens match an engine
    whose pool never evicted (under one seed)."""
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                        max_new_tokens=6)
    prompts = _prompts(3, 4)
    ref = make_engine(tiny, monkeypatch, tier=False, num_blocks=64,
                      max_num_seqs=1)
    want = [[f.token_ids for f in _run_all(ref, prompts, sp)]
            for _ in range(2)]
    eng = make_engine(tiny, monkeypatch, tier=True, num_blocks=16,
                      max_num_seqs=1)
    got = [[f.token_ids for f in _run_all(eng, prompts, sp)]
           for _ in range(2)]
    assert got == want
    assert eng.cache.tier.snapshot()["restored"] > 0
    _assert_pool_exact(eng)


def test_differential_preemption(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=12)
    prompts = [[11 + i, 7, 9, 3] for i in range(3)]
    off = make_engine(tiny, monkeypatch, tier=False, num_blocks=6,
                      max_model_len=64)
    want = [f.token_ids for f in _run_all(off, prompts, sp)]
    on = make_engine(tiny, monkeypatch, tier=True, num_blocks=6,
                     max_model_len=64)
    assert [f.token_ids for f in _run_all(on, prompts, sp)] == want
    assert on.obs.preemptions > 0
    _assert_pool_exact(on)


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["lockstep", "async"])
def test_differential_both_disciplines(tiny, monkeypatch, async_decode):
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    _differential(tiny, monkeypatch, sp, seed=5, async_decode=async_decode,
                  num_blocks=16, max_num_seqs=2)


def test_differential_async_copyout(tiny, monkeypatch):
    """The copy-out worker publishes off the engine thread: a restore may
    miss an in-flight entry (recompute) but never changes a token."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    eng = _differential(tiny, monkeypatch, sp, seed=6, rounds=3,
                        tier_async=True, num_blocks=16, max_num_seqs=1)
    eng.cache.tier.drain()
    assert eng.cache.tier.snapshot()["stores"] > 0
    assert eng.cache.tier._worker is not None


def test_warm_tier_hit_skips_prefill_blocks(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    eng = make_engine(tiny, monkeypatch, num_blocks=16, max_num_seqs=1)
    prompts = _prompts(7, 4)
    _run_all(eng, prompts, sp)
    _run_all(eng, prompts[1:], sp)
    assert len(eng.cache.cached_prefix(prompts[0])) < 4
    restored = eng.cache.tier.snapshot()["restored"]
    [f] = _run_all(eng, [prompts[0]], sp)
    assert eng.cache.tier.snapshot()["restored"] > restored
    assert f.timing["kv_restore_blocks"] > 0
    assert f.timing["recompute_tokens"] < len(prompts[0])


def test_preemption_offload_reaches_tier(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=20)
    eng = make_engine(tiny, monkeypatch, num_blocks=10, max_num_seqs=3)
    _run_all(eng, _prompts(8, 3, length=20), sp)
    assert eng.obs.preemptions > 0
    assert eng.cache.tier.snapshot()["stores"] > 0
    _assert_pool_exact(eng)


def test_tier_failure_degrades_to_recompute(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=6)
    prompts = _prompts(9, 3)
    off = make_engine(tiny, monkeypatch, tier=False, num_blocks=16,
                      max_num_seqs=1)
    want = [[f.token_ids for f in _run_all(off, prompts, sp)]
            for _ in range(2)]
    eng = make_engine(tiny, monkeypatch, num_blocks=16, max_num_seqs=1)

    def boom(*a, **k):
        raise RuntimeError("injected tier restore failure")

    eng.cache._tier_write = boom
    got = [[f.token_ids for f in _run_all(eng, prompts, sp)]
           for _ in range(2)]
    assert got == want
    _assert_pool_exact(eng)


def test_seeded_cancel_evict_fuzz(tiny, monkeypatch):
    """Add/step/cancel under a tiny pool (constant eviction, preemption and
    tier traffic): each request terminal exactly once, device and host
    accounting exact."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    eng = make_engine(tiny, monkeypatch, num_blocks=12, max_num_seqs=2)
    rng = np.random.default_rng(0xCAFE)
    prompts = _prompts(10, 6)
    live, done, submitted = set(), set(), 0
    for _ in range(120):
        if submitted < 12 and rng.random() < 0.4:
            live.add(eng.add_request(list(prompts[submitted % 6]), sp))
            submitted += 1
        if live and rng.random() < 0.15:
            victim = sorted(live)[int(rng.integers(len(live)))]
            if eng.cancel(victim) is not None:
                assert victim not in done
                done.add(victim)
                live.discard(victim)
        for f in eng.step():
            assert f.req_id not in done
            done.add(f.req_id)
            live.discard(f.req_id)
        if submitted >= 12 and not eng.has_work:
            break
    while eng.has_work:
        for f in eng.step():
            assert f.req_id not in done
            done.add(f.req_id)
            live.discard(f.req_id)
    eng.finish_pending()
    assert not live and len(done) == submitted
    _assert_pool_exact(eng)
    assert eng.cache.tier.snapshot()["errors"] == 0


def test_greedy_with_tier_matches_jax(tiny, monkeypatch):
    """Eviction replays with the tier on in both packages: greedy tokens
    held to the JAX engine, and both restore from the host tier."""
    jcfg, params, _, _ = tiny
    sp = dict(temperature=0.0, max_new_tokens=6, logprobs=2)
    prompts = _prompts(2, 4)
    over = dict(num_blocks=16, max_num_seqs=1)
    teng = make_engine(tiny, monkeypatch, **over)
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    jeng = JEngine(jcfg, params, jconfig.EngineConfig(**dict(ENGINE_KW,
                                                              **over)))
    got = [f for _ in range(2)
           for f in _run_all(teng, prompts, SamplingParams(**sp))]
    want = [f for _ in range(2)
            for f in _run_all(jeng, prompts, JParams(**sp))]
    assert_greedy_parity(got, want, label="tier on")
    assert teng.cache.tier.snapshot()["restored"] > 0
    assert jeng.cache.tier.snapshot()["restored"] > 0
    _assert_pool_exact(teng)


def test_chunked_prefill_registers_blocks_per_chunk(tiny, monkeypatch):
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    eng = make_engine(tiny, monkeypatch, tier=False)
    long_prompt = _prompts(11, 1, length=70)[0]   # past the bucket max 32
    eng.add_request(list(long_prompt), sp)
    eng.step()
    assert eng.n_chunking == 1
    assert len(eng.cache.cached_prefix(long_prompt)) >= 32 // 8
    eng.step()
    assert len(eng.cache.cached_prefix(long_prompt)) >= 64 // 8
    while eng.has_work:
        eng.step()
    free_before = eng.cache.allocator.n_free
    rid = eng.add_request(list(long_prompt), sp)
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    assert rid in done
    assert free_before - eng.cache.allocator.n_free < \
        eng.cache._blocks_needed(len(long_prompt))


# -- the movers -------------------------------------------------------------------

def _pools(quant):
    """One seeded pool as the port's cache (tensors) and as the JAX
    package's pytree (arrays), the same bytes."""
    cache = PagedKVCache(2, 2, 4, 12, 4, 3, dtype=torch.bfloat16,
                         device="cpu", quant=quant)
    rng = np.random.default_rng(21)
    jkv = []
    for lay in cache.kv:
        jl = {}
        for name, t in lay.items():
            if t.dtype == torch.int8:
                a = rng.integers(-127, 128, t.shape).astype(np.int8)
                t.copy_(torch.from_numpy(a))
                jl[name] = jnp.asarray(a)
            elif t.dtype == torch.float32:
                a = rng.random(t.shape).astype(np.float32)
                t.copy_(torch.from_numpy(a))
                jl[name] = jnp.asarray(a)
            else:
                a = rng.standard_normal(t.shape).astype(np.float32)
                t.copy_(torch.from_numpy(a).to(torch.bfloat16))
                jl[name] = jnp.asarray(a).astype(jnp.bfloat16)
        jkv.append(jl)
    return cache, jkv


def _bytes(a):
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_gather_and_restore_match_the_jax_movers(quant):
    cache, jkv = _pools(quant)
    idx = np.array([3, 7, 0, 0], np.int32)   # two blocks padded to 4
    got = restore.make_tier_gather(quant)(cache.kv, torch.from_numpy(
        idx.astype(np.int64)))
    want = jrestore.make_tier_gather(quant)(jkv, jnp.asarray(idx))
    assert len(got) == len(want) == (4 if quant else 2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.numpy().tobytes() == _bytes(w)
    # fresh tensors: a later write to the pool leaves the gather as it was
    snap = [g.clone() for g in got]
    cache.kv[0]["k"][3].zero_()
    assert all(torch.equal(a, b) for a, b in zip(snap, got))
    # the restore: the gathered rows into blocks 5 and 9 of every layer,
    # in place; the JAX restore's donated pools give the same bytes
    cache, jkv = _pools(quant)
    ptrs = [t.data_ptr() for lay in cache.kv for t in lay.values()]
    dst = np.array([5, 9, 0, 0], np.int32)
    rst = restore.make_tier_restore(quant)
    jrst = jrestore.make_tier_restore(quant)
    for li, lay in enumerate(cache.kv):
        rst(lay, torch.from_numpy(dst.astype(np.int64)),
            *(g[li] for g in got))
        host = [jnp.asarray(w[li]) for w in want]
        if quant:
            jl = jkv[li]
            (jl["k"], jl["v"], jl["ks"], jl["vs"]) = jrst(
                jl["k"], jl["v"], jl["ks"], jl["vs"], jnp.asarray(dst),
                *host)
        else:
            jkv[li]["k"], jkv[li]["v"] = jrst(
                jkv[li]["k"], jkv[li]["v"], jnp.asarray(dst), *host)
    assert [t.data_ptr() for lay in cache.kv for t in lay.values()] == ptrs
    for lay, jl in zip(cache.kv, jkv):
        for name, t in lay.items():
            mine = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            # block 0 takes the padding rows in an order neither package
            # fixes: compare every other block byte for byte
            assert mine[1:].numpy().tobytes() == _bytes(jl[name][1:]), name


def test_host_copy_waits_and_hands_numpy():
    t = torch.arange(12, dtype=torch.int16).reshape(3, 4)
    hc = restore.HostCopy([t])
    (a,) = hc.host_arrays()
    assert isinstance(a, np.ndarray) and a.tolist() == t.tolist()


# -- the host pool (kvtier/pool.py) -----------------------------------------------

def _tier(capacity_blocks=4, async_copy=False, dtype=np.float32):
    t = HostKVTier(n_layers=2, block_size=4, n_kv_heads=2, head_dim=4,
                   dtype=dtype, capacity_bytes=0, async_copy=async_copy)
    t.capacity_bytes = capacity_blocks * t.block_nbytes
    return t


def _blockdata(tier, n, seed=0):
    rng = np.random.default_rng(seed)
    shape = (tier.n_layers, n, tier.block_size, tier.n_kv_heads,
             tier.head_dim)
    return (rng.standard_normal(shape).astype(tier.dtype),
            rng.standard_normal(shape).astype(tier.dtype))


@pytest.mark.parametrize("Tier", [HostKVTier, JTier], ids=["port", "jax"])
def test_pool_accounting_and_lru_eviction(Tier):
    t = Tier(n_layers=2, block_size=4, n_kv_heads=2, head_dim=4,
             dtype=np.float32, capacity_bytes=0, async_copy=False)
    t.capacity_bytes = 2 * t.block_nbytes
    k, v = _blockdata(t, 3)
    t.store_batch([101, 102, 103], k, v, 3)
    snap = t.snapshot()
    assert snap["entries"] == 2 and snap["evictions"] == 1
    assert snap["used_bytes"] == 2 * t.block_nbytes
    assert not t.has(101) and t.has(102) and t.has(103)
    assert t.probe_run([102]) == 1
    t.store_batch([104], *_blockdata(t, 1, seed=1), 1)
    assert t.has(102) and t.has(104) and not t.has(103)
    # 101..103 were one stored run: evicting its head untracks it whole
    assert [a["head"] for a in t.advertisement()] == [104]


def test_pool_roundtrip_preserves_block_bytes():
    t = _tier(4)
    k, v = _blockdata(t, 2, seed=3)
    t.store_batch([7, 8], k, v, 2)
    run = t.get_run([7, 8, 9])
    assert [h for h, *_ in run] == [7, 8]
    np.testing.assert_array_equal(run[0][1], k[:, 0])
    np.testing.assert_array_equal(run[1][2], v[:, 1])


def test_bf16_pool_stores_words_under_the_wire_name():
    t = _tier(4, dtype="bfloat16")
    assert t.dtype == np.int16 and frames.wire_name(t.dtype) == "bfloat16"
    assert t.block_nbytes == 2 * 2 * 4 * 2 * 4 * 2
    words = np.arange(2 * 1 * 4 * 2 * 4, dtype=np.int16).reshape(
        2, 1, 4, 2, 4)
    t.store_batch([5], words, words + 1, 1)
    [(h, k, v)] = t.get_run([5])
    assert frames.wire_name(k.dtype) == "bfloat16"
    assert k.tobytes() == words[:, 0].tobytes()


def test_pool_zero_capacity_refuses_and_counts():
    t = _tier(0)
    assert not t.accepts(1)
    t.store_batch([1], *_blockdata(t, 1), 1)
    snap = t.snapshot()
    assert snap["entries"] == 0 and snap["dropped"] == 1


def test_pool_probe_counts_hits_and_misses():
    t = _tier(4)
    t.store_batch([1, 2], *_blockdata(t, 2), 2)
    assert t.probe_run([1, 2, 3]) == 2
    snap = t.snapshot()
    assert snap["hits"] == 2 and snap["misses"] == 1
    assert snap["hit_rate"] == pytest.approx(2 / 3, abs=1e-3)


def test_async_worker_publishes_after_drain():
    t = _tier(4, async_copy=True)
    k, v = _blockdata(t, 2)
    t.store_batch([11, 12], k, v, 2)
    t.drain()
    assert t.has(11) and t.has(12)
    np.testing.assert_array_equal(t.get_run([11, 12])[0][1], k[:, 0])


def test_close_joins_worker_and_refuses_late_demotions():
    t = _tier(4, async_copy=True)
    t.store_batch([21, 22], *_blockdata(t, 2), 2)
    assert t.close(timeout=5.0)
    assert t.has(21) and t.has(22)
    assert t._worker is not None and not t._worker.alive
    assert t.close(timeout=1.0)
    t.store_batch([23], *_blockdata(t, 1, seed=9), 1)
    snap = t.snapshot()
    assert not t.has(23) and snap["dropped"] == 1 and snap["errors"] == 0
    assert t.probe_run([21]) == 1


def test_close_without_worker_latches_and_double_close_drains():
    t = _tier(2, async_copy=True)
    assert t.close(timeout=0.1)
    t.store_batch([31], *_blockdata(t, 1), 1)
    assert t._worker is None and t.snapshot()["dropped"] == 1
    t2 = _tier(4, async_copy=True)
    t2.store_batch([41], *_blockdata(t2, 1), 1)
    assert t2.close(timeout=5.0) and t2.close(timeout=1.0)
    t2.drain()   # returns: nothing unfinished
    assert t2.has(41)


# -- telemetry ---------------------------------------------------------------------

def test_engine_snapshot_carries_host_kv_gauges(tiny, monkeypatch):
    snap = make_engine(tiny, monkeypatch).obs.snapshot()
    assert snap["host_kv_utilization"] == 0.0
    assert "host_kv_hit_rate" in snap and "host_kv_used_bytes" in snap
    assert "host_kv_utilization" not in make_engine(
        tiny, monkeypatch, tier=False).obs.snapshot()


def _families(text):
    return {f.name: (f.type, f.documentation)
            for f in text_string_to_metric_families(text)}


def test_kvtier_families_match_the_jax_collector():
    """The same stores and probes on both packages' tiers: the port's
    ``shai_kvtier_*`` families carry the JAX collector's names, types,
    help and values."""
    fams, values = [], []
    for Tele, Tier in ((StepTelemetry, HostKVTier), (JTelemetry, JTier)):
        tele = Tele(total_blocks=8)
        tele.kvtier = Tier(n_layers=2, block_size=4, n_kv_heads=2,
                           head_dim=4, dtype=np.float32,
                           capacity_bytes=4 * 512, async_copy=False)
        tele.kvtier.store_batch([42], *_blockdata(tele.kvtier, 1), 1)
        tele.kvtier.probe_run([42, 43])
        if Tele is StepTelemetry:
            out = Exposition()
            engine_families(out, tele, "t")
            text = out.text()
        else:
            from prometheus_client import CollectorRegistry, generate_latest

            reg = CollectorRegistry()
            reg.register(EngineTelemetryCollector(lambda: tele, "t"))
            text = generate_latest(reg).decode()
        parsed = _families(text)
        fams.append({k: v for k, v in parsed.items()
                     if k.startswith("shai_kvtier_")})
        values.append({s.name: s.value
                       for f in text_string_to_metric_families(text)
                       if f.name.startswith("shai_kvtier_")
                       for s in f.samples})
    assert fams[0] == fams[1] and len(fams[0]) == 13
    assert values[0] == values[1]


def test_hbm_ledger_host_pool_excluded_from_attribution():
    led = HbmLedger()
    led.sample(pools={"kv_pool": 1000.0}, composition=(1, 0, 0),
               host_pools={"host_kv": 555.0})
    snap = led.snapshot()
    assert snap["host_kv_bytes"] == 555.0
    assert snap["used_bytes"] == 1000.0 == snap["attributed_bytes"]


def test_affinity_digest_equals_the_jax_package_and_tracker_is_lru():
    rng = np.random.default_rng(1)
    for n in (0, 5, 255, 256, 257, 1000):
        text = "".join(chr(int(c)) for c in rng.integers(32, 0x3000, n))
        assert prompt_affinity(text) == jaff.prompt_affinity(text)
        assert prompt_affinity(text, 16) == jaff.prompt_affinity(text, 16)
    head = "x" * 256
    assert prompt_affinity(head + "a") == prompt_affinity(head + "b")
    tr = AffinityTracker(max_entries=3)
    for d in ("a", "b", "c", "a", "d"):
        tr.note(d)
    assert tr.snapshot() == ["c", "a", "d"]
