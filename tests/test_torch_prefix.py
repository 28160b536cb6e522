"""The port's prefix cache against the JAX package's, on the CPU.

Port of ``tests/test_cache_alloc.py`` and ``tests/test_prefix_cache.py``,
each case run on both packages' ``PagedKVCache`` / ``LLMEngine`` (the JAX
engine and the port's read the same weights: a flax init carried over
with ``params_from_jax``; the tiny config). What is held:

- the chain hashes (blake2b-64 over little-endian int64 ids, seeded
  ``0x5351``) are the JAX package's, as integers, on seeded token lists
  of every length around the block boundaries: they key blocks on the
  wire between pods;
- the allocator and the prefix LRU: refcount edges, release after
  register keeping the cache's reference, eviction then stale reuse
  detected, shared blocks freed only after every holder, the copy-on-
  write cases over registered blocks and under eviction pressure,
  leaf-first eviction: the same block ids, refcounts and counters in
  both caches, step for step (``shrink``'s case is replayed with the
  speculative tests, ``tests/test_torch_speculative.py``);
- the engine: a cached admission shares the registered blocks (fewer
  fresh blocks than a cold admission) and gives the tokens of an engine
  with the cache off, exactly, in the port; greedy tokens are held to the
  JAX engine with the cache on with ``tests/parity.py``'s
  ``assert_greedy_parity``; near-miss prompts do not share; a full pool
  evicts instead of failing; with the cache on, the warmed set is the JAX
  engine's key for key (bucketed, ragged and fused) and a cache hit after
  warmup builds nothing (0 recompiles); an int8 pool under the fused step
  falls through to plain admission and still serves.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine.cache import (
    BlockAllocator as JAllocator,
    PagedKVCache as JCache,
)
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import (
    BlockAllocator,
    PagedKVCache,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402

# the oracle's engine shapes (tests/test_prefix_cache.py)
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


def _switches(monkeypatch, ragged=False, fused=False, quant=False):
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "1" if ragged else "0")
    monkeypatch.setenv("SHAI_FUSED_STEP", "1" if fused else "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8" if quant else "")
    monkeypatch.setenv("SHAI_KVTIER", "0")
    monkeypatch.setenv("SHAI_KV_COW", "0")
    # the JAX engine's pool kernels in interpret mode
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")


def _port(tiny, monkeypatch, **over):
    _, _, tcfg, model = tiny
    return LLMEngine(tcfg, model,
                     tconfig.EngineConfig(**dict(ENGINE_KW, **over)),
                     device="cpu")


def _jax(tiny, **over):
    jcfg, params, _, _ = tiny
    return JEngine(jcfg, params,
                   jconfig.EngineConfig(**dict(ENGINE_KW, **over)))


def _prompt(seed, n=40):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(2, 500, n)]


# -- chain hashes --------------------------------------------------------------

def test_chain_hashes_equal_the_jax_package_as_integers():
    rng = np.random.default_rng(0x5351)
    for bs in (1, 4, 8, 16):
        for n in (0, bs - 1, bs, bs + 1, 3 * bs, 5 * bs + 3, 257):
            toks = [int(x) for x in rng.integers(0, 128256, n)]
            got = PagedKVCache._chain_hashes(toks, bs)
            assert got == JCache._chain_hashes(toks, bs)
            assert len(got) == n // bs
            assert all(isinstance(h, int) and -2**63 <= h < 2**63
                       for h in got)
    # a numpy int32 prompt hashes as its Python ints do
    toks = rng.integers(0, 500, 40).astype(np.int32)
    assert PagedKVCache._chain_hashes(toks, 8) == \
        JCache._chain_hashes([int(t) for t in toks], 8)


# -- the allocator and the prefix LRU (tests/test_cache_alloc.py) --------------

def _caches(**over):
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=4, total_blocks=16,
              block_size=4, blocks_per_seq=8, enable_prefix_caching=True)
    kw.update(over)
    return (PagedKVCache(dtype=torch.float32, device="cpu", **kw),
            JCache(dtype=jnp.float32, **kw))


def _state(cache):
    """Everything the two caches must agree on, block ids included."""
    return (sorted(cache.allocator._ref.items()),
            sorted(cache.allocator._free),
            {s: list(cache.seq(s).blocks) for s in cache.active},
            dict(cache._hash2block), list(cache._lru),
            dict(cache._parent), dict(cache._nchild),
            cache.cow_forks, cache.cow_copies, cache.leaked_blocks,
            cache.n_evictable)


def _both(fn):
    """Run ``fn(cache)`` on the port's and the JAX cache; returns both
    results after checking the two states equal."""
    t, j = _caches()
    out = fn(t), fn(j)
    assert _state(t) == _state(j)
    return out


@pytest.mark.parametrize("Alloc", [BlockAllocator, JAllocator],
                         ids=["port", "jax"])
def test_allocator_refcount_edges(Alloc):
    a = Alloc(8)
    [b] = a.alloc(1)
    a.incref(b)
    assert a.refcount(b) == 2
    a.free([b])
    assert a.refcount(b) == 1 and a.n_free == 6
    a.free([b])
    assert a.refcount(b) == 0 and a.n_free == 7
    with pytest.raises(ValueError, match="double free"):
        a.free([b])
    with pytest.raises(ValueError, match="unallocated"):
        a.incref(b)
    with pytest.raises(ValueError, match="reserved"):
        a.free([0])
    a.alloc(7)
    with pytest.raises(MemoryError):
        a.alloc(1)
    assert a.n_free == 0


def _admit_and_register(cache, seq_id, tokens):
    alloc = cache.admit(seq_id, len(tokens))
    cache.register_prefix(tokens, alloc.blocks)
    return alloc


def test_release_after_register_keeps_cache_reference():
    def case(cache):
        tokens = list(range(100, 108))
        full = _admit_and_register(cache, 0, tokens).blocks[:2]
        assert all(cache.allocator.refcount(b) == 2 for b in full)
        cache.release(0)
        assert all(cache.allocator.refcount(b) == 1 for b in full)
        assert cache.cached_prefix(tokens) == full
        return cache.n_evictable
    t, j = _both(case)
    assert t == j >= 2


def test_evict_then_stale_reuse_is_detected():
    def case(cache):
        tokens = list(range(200, 208))
        stale = list(_admit_and_register(cache, 0, tokens).blocks[:2])
        cache.release(0)
        assert cache._evict(2) == 2
        for b in stale:
            with pytest.raises(ValueError):
                cache.allocator.incref(b)
        return cache.cached_prefix(tokens)
    assert _both(case) == ([], [])


def test_shared_prefix_block_freed_only_after_every_holder():
    def case(cache):
        tokens = list(range(300, 308))
        shared = _admit_and_register(cache, 0, tokens).blocks[:2]
        cache.admit(1, len(tokens), reuse_blocks=shared)
        assert all(cache.allocator.refcount(b) == 3 for b in shared)
        cache.release(0)
        cache.release(1)
        free_before = cache.allocator.n_free
        assert cache._evict(2) == 2
        return cache.allocator.n_free - free_before
    assert _both(case) == (2, 2)


def test_fork_of_prefix_cached_block():
    def case(cache):
        tokens = list(range(500, 508))
        shared = list(_admit_and_register(cache, 0, tokens).blocks)
        cache.fork_sequence(0, 1)
        assert all(cache.allocator.refcount(b) == 3 for b in shared)
        cache.extend(1, 1)  # position 8 opens a new block: no copy
        assert cache.cow_copies == 0 and cache.seq(1).blocks[:2] == shared
        cache.release(1)
        cache.release(0)
        return cache.cached_prefix(tokens) == shared
    assert _both(case) == (True, True)


@pytest.mark.parametrize("order", [[0, 1, 2], [2, 1, 0], [1, 0, 2]])
def test_fork_release_order_independence(order):
    def case(cache):
        cache.admit(0, 6)
        cache.fork_sequence(0, 1)
        cache.fork_sequence(0, 2)
        cache.extend(1, 1)
        cache.extend(2, 1)
        cache.extend(0, 1)
        assert cache.cow_copies == 2
        for sid in order:
            cache.release(sid)
        return cache.allocator.n_free
    assert _both(case) == (15, 15)


def test_fork_under_eviction_pressure():
    """A copy-on-write copy from a dry free list evicts a cache-only
    block, never the shared source it copies."""
    def case(cache):
        _admit_and_register(cache, 0, list(range(600, 608)))
        cache.release(0)
        cache.admit(1, 6)
        cache.fork_sequence(1, 2)
        shared = list(cache.seq(1).blocks)
        n_fill = cache.allocator.n_free
        for i in range(n_fill):
            cache.admit(10 + i, cache.block_size)
        assert cache.allocator.n_free == 0 and cache.n_evictable == 2
        cache.extend(2, 1)
        assert cache.cow_copies == 1 and cache.n_evictable == 1
        assert cache.seq(1).blocks == shared
        for sid in [1, 2] + [10 + i for i in range(n_fill)]:
            cache.release(sid)
        return cache.leaked_blocks
    assert _both(case) == (0, 0)


def test_eviction_is_leaf_first_and_refills_in_lru_order():
    """Evicting one block drops a chain's TAIL (the surviving prefix
    still resolves); a later allocation that runs the pool dry evicts in
    LRU order, leaves first, in both caches alike."""
    def case(cache):
        a = list(range(40, 60))    # 5 full blocks
        b = list(range(80, 92))    # 3 full blocks
        _admit_and_register(cache, 0, a)
        _admit_and_register(cache, 1, b)
        cache.release(0)
        cache.release(1)
        assert cache._evict(1) == 1
        hit = len(cache.cached_prefix(a))
        cache.cached_prefix(b)     # b becomes most-recently-used
        cache.admit(2, 4 * 12)     # 12 blocks: 7 free, 5 evicted
        return hit, len(cache.cached_prefix(a)), len(cache.cached_prefix(b))
    t, j = _both(case)
    assert t == j and t[0] == 4


# -- the engine (tests/test_prefix_cache.py) -----------------------------------

def _greedy(eng, prompt, n=6, lp=0):
    Params = JParams if isinstance(eng, JEngine) else SamplingParams
    [fin] = eng.generate([prompt], Params(temperature=0.0, max_new_tokens=n,
                                          logprobs=lp))
    return fin


def test_cached_admission_shares_blocks_and_matches(tiny, monkeypatch):
    _switches(monkeypatch)
    prompt = _prompt(2)
    want = _greedy(_port(tiny, monkeypatch, enable_prefix_caching=False),
                   prompt).token_ids
    eng = _port(tiny, monkeypatch)
    assert _greedy(eng, prompt).token_ids == want
    assert eng.cache.n_evictable > 0
    # the second identical prompt reuses the registered blocks: fewer
    # fresh blocks than a cold admission needs, the same tokens
    free_before = eng.cache.allocator.n_free
    rid = eng.add_request(list(prompt), SamplingParams(temperature=0.0,
                                                       max_new_tokens=6))
    eng.step()
    fresh = free_before - eng.cache.allocator.n_free
    assert fresh < eng.cache._blocks_needed(len(prompt))
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    assert done[rid].token_ids == want
    assert eng.cache.leaked_blocks == 0


@pytest.mark.parametrize("ragged", [False, True], ids=["bucketed", "ragged"])
def test_cached_admission_greedy_matches_jax(tiny, monkeypatch, ragged):
    """A cold prompt, then a prompt extending it (cached admission at warm
    start 32) and the first again (a full hit): greedy tokens held to the
    JAX engine with the cache on, on the same admission paths."""
    _switches(monkeypatch, ragged=ragged)
    base = _prompt(3)
    prompts = [base, base + [5, 6, 7], base]
    teng, jeng = _port(tiny, monkeypatch), _jax(tiny)
    got = [_greedy(teng, p, lp=2) for p in prompts]
    want = [_greedy(jeng, p, lp=2) for p in prompts]
    assert_greedy_parity(got, want, label=f"cached admission ragged={ragged}")
    # the same admission paths: the later two reused the registered run
    assert teng.cache._hash2block.keys() == jeng.cache._hash2block.keys()
    assert teng.cache.leaked_blocks == jeng.cache.leaked_blocks == 0


def test_prefix_cache_differs_on_different_prefix(tiny, monkeypatch):
    _switches(monkeypatch)
    base = _prompt(3)
    other = list(base)
    other[0] = (other[0] + 1) % 500 + 2
    solo = [_greedy(_port(tiny, monkeypatch, enable_prefix_caching=False),
                    p).token_ids for p in (base, other)]
    eng = _port(tiny, monkeypatch)
    assert [_greedy(eng, p).token_ids for p in (base, other)] == solo


def test_prefix_cache_eviction_under_pressure(tiny, monkeypatch):
    _switches(monkeypatch)
    rng = np.random.default_rng(4)
    prompts = [[int(x) for x in rng.integers(2, 500, 40)] for _ in range(4)]
    eng = _port(tiny, monkeypatch, num_blocks=16, max_num_seqs=1)
    outs = [_greedy(eng, p).token_ids for p in prompts]
    off = _port(tiny, monkeypatch, enable_prefix_caching=False,
                num_blocks=16, max_num_seqs=1)
    assert [_greedy(off, p).token_ids for p in prompts] == outs
    assert eng.cache.leaked_blocks == 0


@pytest.mark.parametrize("mode", ["bucketed", "ragged", "fused"])
def test_warmed_set_is_the_jax_engines_key_for_key(tiny, monkeypatch, mode):
    """With the cache on, the warmed set holds every (warm start, chunk
    bucket) continuation the JAX engine warms (``("cont", start_blocks,
    bucket)``, or ``("rcont", bucket)``), and a cold prompt, a cache hit
    and a chunked prompt after warmup build nothing in either package."""
    _switches(monkeypatch, ragged=mode != "bucketed", fused=mode == "fused")
    teng, jeng = _port(tiny, monkeypatch), _jax(tiny)
    n = teng.warm_executables()
    assert n == jeng.warm_executables()
    # the JAX prefill keys are (bucket, prefix_len 0, batch); the port's
    # (bucket, batch)
    jkeys = {k if k[0] in ("cont", "rcont") else (k[0], k[2])
             for k in jeng._prefill}
    assert set(teng._prefill) == jkeys
    assert sorted(teng._fused_fns) == sorted(jeng._fused_fns)
    assert sorted(teng._decode_fns) == sorted(jeng._decode_fns)
    if mode == "bucketed":
        assert ("cont", 2, 16) in teng._prefill   # start 16, bucket 16
    base = _prompt(5)
    for eng, Params in ((teng, SamplingParams), (jeng, JParams)):
        sp = Params(temperature=0.0, max_new_tokens=4)
        eng.generate([base], sp)
        eng.generate([base + [9], base[:20] + _prompt(6, 50)], sp)
        assert eng.obs.recompiles == 0
    assert teng.n_executables == n
    assert teng.cache.leaked_blocks == 0


def test_fused_int8_with_prefix_cache_falls_through(tiny, monkeypatch):
    """An int8 pool under the fused step declines the cached path (its
    C-token window would re-quantize the tail block) and admits plainly."""
    _switches(monkeypatch, ragged=True, fused=True, quant=True)
    eng = _port(tiny, monkeypatch)
    prompt = [7, 3] * 10
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    eng.generate([prompt], sp)
    assert eng.cache.n_evictable > 0
    eng.add_request(prompt + [5], sp)
    assert eng._admit_cached() is False
    done = []
    while eng.has_work:
        done += eng.step()
    assert len(done[0].token_ids) == 4
    assert eng.cache.leaked_blocks == 0


def test_prefix_cache_vllm_config_key_and_engine_accepts_it(tiny,
                                                             monkeypatch):
    cfg = tconfig.EngineConfig.from_dict({
        "model": "m", "max_model_len": 256, "block_size": 16,
        "context_encoding_buckets": [32], "enable_prefix_caching": True,
        "role": "decode"})
    assert cfg.enable_prefix_caching and cfg.role == "decode"
    _switches(monkeypatch)
    eng = _port(tiny, monkeypatch, role="prefill")
    assert eng.cache.prefix_caching and eng.role == "prefill"
    # speculative decoding with the prefix cache (slice 13): the second
    # request is a cached admission sharing the first's registered blocks,
    # both verify, and the tokens are the cache-off engine's
    spec = dict(speculative_model="[ngram]", num_speculative_tokens=2)
    shared = _prompt(3, 32)
    prompts = [shared + [5, 6], shared + [7, 8, 9]]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    runs = []
    for caching in (True, False):
        eng = _port(tiny, monkeypatch, enable_prefix_caching=caching, **spec)
        assert eng.spec is not None and eng.cache.prefix_caching is caching
        fins = [eng.generate([p], sp)[0] for p in prompts]
        runs.append([f.token_ids for f in fins])
        assert eng.spec.verify_steps > 0 and eng.cache.leaked_blocks == 0
        if caching:
            assert len(eng.cache.cached_prefix(shared)) == 4
    assert runs[0] == runs[1]
