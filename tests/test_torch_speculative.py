"""The port's speculative decoding against the JAX package's, on the CPU.

Port of ``tests/test_speculative.py`` (and the ``shrink`` case of
``tests/test_cache_alloc.py``), each case held against the JAX package on
the same seeded inputs:

- the drafter, ``accept_drafts`` and ``SpecStats`` equal the JAX module's
  on the same contexts, draws and records;
- ``sample_excluding``: at temperature 0 it equals the JAX function
  exactly; at temperature > 0 it stays inside vanilla's top-k support, and
  its frequencies over ``N_DRAWS`` draws are within ``FREQ_ATOL`` of the
  JAX distribution with the hole (``FREQ_ATOL`` is 4.5 binomial standard
  deviations of the largest probability: a correct sampler fails it once
  in some 10^5 runs, a sampler that lets the hole back in or recomputes the
  masks after the exclusion misses by 0.1 or more);
- ``make_verify`` against the JAX ``make_verify`` on ``params_from_jax``
  weights, bucketed and ragged, bf16 and int8 KV, the JAX side through its
  gather path (its own default off the TPU): the greedy rows' ``o``,
  ``oex`` and ``accept_p`` equal wherever the JAX top logprobs are
  decisive (gaps of at least ``2 * LOGIT_ATOL``; below that the argmax is a
  bf16 tie), ``d_lp``, ``top_lp`` and the greedy rows' ``o_lp`` within
  ``LOGIT_ATOL`` (``tests/test_torch_runner.py``'s bound: bf16 rounding
  carried through the last norm and the unembedding), the sampled rows'
  ``accept_p`` within ``PROB_RTOL`` of the JAX value plus ``PROB_ATOL``
  (a logit moved by ``LOGIT_ATOL`` over a temperature of 0.8 moves a
  probability by up to 16% of itself);
- ``shrink`` replayed on both caches, state for state;
- the engine with speculation on, JAX against port (the JAX engine through
  its gather path), greedy, by ``tests/parity.py``'s tie rule: batched with
  staggered admissions, an EOS inside an accepted run, partial acceptance
  rolling the reservation back (the cache holds exactly the committed
  tokens after every step), block pressure that preempts, logprobs that
  align with the tokens, a repetitive workload committing more than one
  token per verify, ragged attention with int8 KV, and the prefix cache
  on; where the tokens are equal the ``SpecStats`` counters are equal too
  (the one JAX engine of each configuration is shared by the cases, so it
  is read by difference);
- in the port alone: async equal to lock-step with speculation (greedy and
  sampled), sampled requests finishing, ``SHAI_FUSED_STEP=1`` building no
  fused graph, the verify ladder warmed beside the decode ladder with 0
  recompiles after it, spec on equal to spec off on the greedy tokens;
- the tiny tier through the ``vllm`` unit over HTTP with the spec keys in
  its ConfigMap: ``/stats`` carries the counters, ``/metrics`` the
  ``shai_spec_*_total`` counters and the acceptance gauge under a JAX
  pod's family names and labels, and ``publish_spec`` pushes the JAX
  publisher's JSON lines.

The reference asserts spec-on equal to spec-off exactly on XLA; the port
holds greedy spec-on to spec-off exactly on the CPU too, and to the JAX
engine by the tie rule (the packages round bf16 in different places).
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from prometheus_client.parser import text_string_to_metric_families

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine import runner as jrunner
from scalable_hw_agnostic_inference_tpu.engine import speculative as jspec
from scalable_hw_agnostic_inference_tpu.engine.cache import (
    PagedKVCache as JCache,
)
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.ops import sampling as jsampling
from scalable_hw_agnostic_inference_tpu.serve import metrics as jmetrics
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine import runner as trunner
from scalable_hw_agnostic_inference_tpu_torch.engine import (
    speculative as tspec,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import (
    PagedKVCache,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.ops import sampling as tsampling
from scalable_hw_agnostic_inference_tpu_torch.serve import metrics as tmetrics

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

K = 4
# tests/test_speculative.py's engine shapes over a pool of 8 usable blocks:
# one sequence of max_model_len fits, three running together preempt
ENGINE_KW = dict(max_model_len=64, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32), max_new_tokens=32,
                 num_blocks=9, speculative_model="[ngram]",
                 num_speculative_tokens=K)
LOGIT_ATOL = 6e-2
PROB_RTOL = 0.16
PROB_ATOL = 1e-3
N_DRAWS = 20000
FREQ_ATOL = 4.5 * np.sqrt(0.25 / N_DRAWS)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


#: the switches both engines read at construction (and the JAX runner when
#: it builds an executable): the JAX side through its gather path
BASE_ENV = {"SHAI_PAGED_DECODE": "0", "SHAI_RAGGED_ATTENTION": "0",
            "SHAI_KV_QUANT": "", "SHAI_FUSED_STEP": "0", "SHAI_KVTIER": "0",
            "SHAI_KV_COW": "0", "SHAI_ASYNC_DECODE": "1"}


@contextlib.contextmanager
def _env(**over):
    values = dict(BASE_ENV, **over)
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _JaxSide:
    """One JAX engine of a configuration, shared by the cases (its
    executables compile once); every use runs under its switches."""

    def __init__(self, tiny, env, **over):
        self.env = env
        jcfg, params, _, _ = tiny
        with _env(**env):
            self.eng = JEngine(jcfg, params, jconfig.EngineConfig(
                **dict(ENGINE_KW, **over)))

    def run(self, prompts, stagger=False, **sp):
        with _env(**self.env):
            before = dataclasses.replace(self.eng.spec)
            fins = _drive(self.eng, prompts, JParams(**sp), stagger)
            after = self.eng.spec
        delta = {f.name: getattr(after, f.name) - getattr(before, f.name)
                 for f in dataclasses.fields(after)}
        return fins, delta


def _port(tiny, env=(), **over):
    _, _, tcfg, model = tiny
    with _env(**dict(env)):
        return LLMEngine(tcfg, model, tconfig.EngineConfig(
            **dict(ENGINE_KW, **over)), device="cpu")


def _drive(eng, prompts, sp, stagger=False, each_step=None):
    """Submit ``prompts`` (one per step with ``stagger``) and step until
    every request finished; the finished requests in submission order."""
    ids, done = [], {}
    pending = list(prompts)
    while pending or eng.has_work:
        if pending:
            batch = [pending.pop(0)] if stagger else pending
            ids += [eng.add_request(p, sp) for p in batch]
            if not stagger:
                pending = []
        for f in eng.step():
            done[f.req_id] = f
        if each_step is not None:
            each_step(eng)
    return [done[i] for i in ids]


def _port_run(eng, prompts, stagger=False, each_step=None, **sp):
    """The finished requests and the run's ``SpecStats`` advance."""
    before = dataclasses.asdict(eng.spec)
    fins = _drive(eng, prompts, SamplingParams(**sp), stagger, each_step)
    return fins, {k: v - before[k]
                  for k, v in dataclasses.asdict(eng.spec).items()}


def _fuzz_prompts(seed, n):
    """tests/test_speculative.py's prompts: repetition (drafting fires)
    and random tails (acceptance fails sometimes)."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n):
        base = rng.integers(3, 500, int(rng.integers(2, 6))).tolist()
        reps = int(rng.integers(2, 5))
        tail = rng.integers(3, 500, int(rng.integers(0, 4))).tolist()
        prompts.append((base * reps + tail)[:24])
    return prompts


def _assert_parity(got, want, tdelta, jdelta, label):
    """Tie rule on the tokens; where every stream is equal, the spec
    counters too."""
    assert_greedy_parity(got, want, label=label)
    if all(g.token_ids == w.token_ids for g, w in zip(got, want)):
        assert [g.stop_reason for g in got] == [w.stop_reason for w in want]
        assert tdelta == jdelta, label


# -- the drafter, the acceptance walk and the counters ------------------------

def _contexts():
    rng = np.random.default_rng(0x5EC)
    out = [[], [5], [1, 2, 3], [1, 2, 1, 2], [1, 2, 3, 4, 1, 2, 3, 4, 1, 2],
           [1, 2, 9, 1, 2, 7, 1, 2], [1, 2, 3, 4, 5, 6, 1, 2], [7] * 9]
    for _ in range(40):
        base = rng.integers(0, 6, int(rng.integers(1, 5))).tolist()
        out.append((base * int(rng.integers(1, 5))
                    + rng.integers(0, 6, int(rng.integers(0, 6))).tolist()))
    return out


@pytest.mark.parametrize("k,lmax,lmin", [(4, 4, 1), (3, 2, 1), (2, 2, 1),
                                         (4, 4, 3), (1, 1, 1), (5, 3, 2)])
def test_drafter_equals_the_jax_drafter(k, lmax, lmin):
    t = tspec.PromptLookupDrafter(k, lookup_max=lmax, lookup_min=lmin)
    j = jspec.PromptLookupDrafter(k, lookup_max=lmax, lookup_min=lmin)
    for ctx in _contexts():
        assert t.draft(ctx) == j.draft(ctx), ctx
    # tests/test_speculative.py's cases
    assert tspec.PromptLookupDrafter(4).draft(
        [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]) == [3, 4, 1, 2]
    assert tspec.PromptLookupDrafter(3, 2, 1).draft(
        [1, 2, 9, 1, 2, 7, 1, 2])[0] == 7


def test_drafter_validates_knobs_as_jax_does():
    for args in ((0,), (4, 2, 3), (4, 3, 0)):
        with pytest.raises(ValueError):
            jspec.PromptLookupDrafter(*args)
        with pytest.raises(ValueError):
            tspec.PromptLookupDrafter(*args)


def test_accept_drafts_and_spec_stats_equal_jax():
    rng = np.random.default_rng(7)
    tst, jst = tspec.SpecStats(), jspec.SpecStats()
    for _ in range(300):
        nd = int(rng.integers(0, K + 1))
        draft = rng.integers(0, 6, nd).tolist()
        o = rng.integers(0, 6, nd + 1)
        oex = rng.integers(0, 6, nd)
        accept_p = rng.random(nd)
        u = rng.random(nd)
        temp = float(rng.choice([0.0, 0.7, 1.0]))
        got = tspec.accept_drafts(draft, o, oex, accept_p, temp, u)
        assert got == jspec.accept_drafts(draft, o, oex, accept_p, temp, u)
        for st in (tst, jst):
            st.record_verify(nd, got[0], got[0] + 1)
            st.verify_steps += 1
            st.fallback_steps += int(nd == 0)
    assert tst.as_dict() == jst.as_dict()
    assert tspec.SpecStats().as_dict() == jspec.SpecStats().as_dict()
    # tests/test_speculative.py's walks
    o = np.array([5, 6, 8, 9])
    assert tspec.accept_drafts([5, 6, 7], o, o[:3], np.ones(3), 0.0,
                               np.zeros(3)) == (2, 8)
    assert tspec.accept_drafts([5, 6], np.array([5, 6, 99]),
                               np.array([11, 12]), np.array([1.0, 0.0]),
                               1.0, np.array([0.5, 0.5])) == (1, 12)


# -- sample_excluding ---------------------------------------------------------

def test_sample_excluding_greedy_equals_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, K, 64)).astype(np.float32)
    exclude = rng.integers(0, 64, (3, K)).astype(np.int32)
    exclude[0] = logits[0].argmax(-1)       # the hole at the argmax
    temp = np.zeros((3, K), np.float32)
    got = tsampling.sample_excluding(
        torch.from_numpy(logits), torch.Generator().manual_seed(0),
        torch.from_numpy(exclude), torch.from_numpy(temp), 5, 0.9)
    want = jax.jit(jsampling.sample_excluding, static_argnums=(4, 5))(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(exclude),
        jnp.asarray(temp), 5, 0.9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != exclude).all()


def test_sample_excluding_stays_inside_vanilla_support():
    """tests/test_speculative.py:86: top_k=2 with the rank-1 token
    rejected leaves only the rank-2 token; temperature 0 takes the argmax
    without the hole."""
    logits = torch.tensor([[5.0, 4.0, 3.0, 2.0]]).expand(256, 4)
    exclude = torch.zeros(256, dtype=torch.int32)
    tok = tsampling.sample_excluding(logits, torch.Generator().manual_seed(0),
                                     exclude, 1.0, 2, 1.0)
    assert (tok == 1).all()
    assert int(tsampling.sample_excluding(
        logits[:1], torch.Generator(), exclude[:1], 0.0, 0, 1.0)[0]) == 1


@pytest.mark.parametrize("temp,top_k,top_p,hole", [
    (1.0, 0, 1.0, 0), (0.7, 5, 1.0, 2), (1.3, 0, 0.8, 1), (0.9, 6, 0.9, 7)])
def test_sample_excluding_distribution_matches_jax(temp, top_k, top_p, hole):
    """``N_DRAWS`` draws of the port's sampler, given uniforms, against
    the JAX distribution it samples: the softmax of the JAX masked scaled
    logits with the hole at NEG_INF (computed, not drawn)."""
    logits = np.array([2.0, 1.6, 1.5, 0.9, 0.4, 0.3, -0.5, 1.9],
                      np.float32)
    masked = np.array(jsampling.masked_scaled_logits(
        jnp.asarray(logits)[None], temp, top_k, top_p))[0]
    masked[hole] = jsampling.NEG_INF
    want = np.exp(masked - masked.max())
    want /= want.sum()
    gen = torch.Generator().manual_seed(11)
    u = torch.rand((N_DRAWS, logits.size), generator=gen)
    tok = tsampling.sample_excluding(
        torch.from_numpy(logits).expand(N_DRAWS, -1), u,
        torch.full((N_DRAWS,), hole, dtype=torch.int32), temp, top_k, top_p)
    freq = np.bincount(tok.numpy(), minlength=logits.size) / N_DRAWS
    assert freq[want == 0].sum() == 0       # never outside the support
    np.testing.assert_allclose(freq, want, atol=FREQ_ATOL, rtol=0)
    # the precomputed masked logits give the same tokens
    m = tsampling.masked_scaled_logits(
        torch.from_numpy(logits).expand(N_DRAWS, -1), temp, top_k, top_p)
    again = tsampling.sample_excluding(
        torch.from_numpy(logits).expand(N_DRAWS, -1), u,
        torch.full((N_DRAWS,), hole, dtype=torch.int32), temp, top_k, top_p,
        masked=m)
    assert torch.equal(tok, again)


# -- make_verify --------------------------------------------------------------

BS, BPS, N_BLOCKS = 8, 8, 24


def _pools(cfg, quant):
    shape = (N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    dt = jnp.int8 if quant else jnp.bfloat16
    jkv = []
    for _ in range(cfg.n_layers):
        lay = {"k": jnp.zeros(shape, dt), "v": jnp.zeros(shape, dt)}
        if quant:
            lay["ks"] = jnp.zeros((N_BLOCKS, cfg.n_kv_heads), jnp.float32)
            lay["vs"] = jnp.zeros((N_BLOCKS, cfg.n_kv_heads), jnp.float32)
        jkv.append(lay)
    tkv = PagedKVCache(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, N_BLOCKS,
                       BS, BPS, device=torch.device("cpu"), quant=quant).kv
    return jkv, tkv


def _decisive(top_lp, rank=0):
    return top_lp[..., rank] - top_lp[..., rank + 1] >= 2 * LOGIT_ATOL


@pytest.mark.parametrize("ragged,quant", [(False, False), (True, False),
                                          (True, True)],
                         ids=["bucketed-bf16", "ragged-bf16", "ragged-int8"])
def test_make_verify_matches_jax(tiny, ragged, quant):
    """Four rows (two greedy, two sampled, their drafts part the JAX
    argmax, part random, one short draft zero-padded) after a 32-token
    bucketed prefill, then one verify over a 5-block context bucket (the
    full window when ragged); rows 1 and 3 cross into a fresh block."""
    jcfg, params, tcfg, model = tiny
    rng = np.random.default_rng(21 + 2 * ragged + quant)
    B = 4
    ids = rng.integers(3, jcfg.vocab_size, (B, 32)).astype(np.int32)
    n_text = np.array([9, 30, 13, 21], np.int32)
    for i, n in enumerate(n_text):
        ids[i, n:] = 0
    tables = np.zeros((B, BPS), np.int32)
    tables[:, :5] = rng.permutation(np.arange(1, N_BLOCKS))[:20].reshape(B, 5)
    jkv, tkv = _pools(jcfg, quant)
    jpre = jrunner.make_prefill(jcfg, BS, BPS, 32, n_seqs=B, kv_quant=quant)
    jkv, jlog = jpre(params, jkv, jnp.asarray(ids), jnp.asarray(n_text),
                     jnp.asarray(tables))
    tpre = trunner.make_prefill(tcfg, BS, BPS, 32, n_seqs=B, kv_quant=quant)
    with torch.inference_mode():
        tkv, _ = tpre(model, tkv, torch.from_numpy(ids),
                      torch.from_numpy(n_text), torch.from_numpy(tables))
    jlog = np.asarray(jlog)
    tokens = np.zeros((B, K + 1), np.int32)
    tokens[:, 0] = jlog.argmax(-1)
    tokens[:, 1:] = rng.integers(3, jcfg.vocab_size, (B, K))
    tokens[3, 3:] = 0                           # a 2-token draft, padded
    pos0 = n_text.copy()
    temp = np.array([0.0, 0.0, 0.8, 1.0], np.float32)
    topk = np.array([0, 0, 20, 0], np.int32)
    topp = np.array([1.0, 1.0, 1.0, 0.9], np.float32)
    m_ctx = BPS if ragged else 5
    jver = jrunner.make_verify(jcfg, BS, BPS, B, K, ctx_blocks=m_ctx,
                               paged=False, ragged=ragged, kv_quant=quant)
    # the JAX greedy token as the first draft of row 0
    jargs = (jnp.asarray(pos0), jnp.asarray(tables), jnp.ones((B,), bool),
             jax.random.PRNGKey(3), jnp.asarray(temp), jnp.asarray(topk),
             jnp.asarray(topp))
    _, jo, *_ = jver(params, jax.tree.map(jnp.copy, jkv),
                     jnp.asarray(tokens), *jargs)
    tokens[0, 1] = np.asarray(jo)[0, 0]
    jout = jver(params, jkv, jnp.asarray(tokens), *jargs)
    jo, joex, jacc, jo_lp, jd_lp, joex_lp, jtop_ids, jtop_lp = (
        np.asarray(x) for x in jout[1:])
    tver = trunner.make_verify(tcfg, BS, BPS, B, K, ctx_blocks=m_ctx,
                               ragged=ragged, kv_quant=quant)
    with torch.inference_mode():
        tout = tver(model, tkv, torch.from_numpy(tokens),
                    torch.from_numpy(pos0), torch.from_numpy(tables),
                    torch.Generator().manual_seed(3), torch.from_numpy(temp),
                    torch.from_numpy(topk), torch.from_numpy(topp))
    to, toex, tacc, to_lp, td_lp, toex_lp, ttop_ids, ttop_lp = (
        x.numpy() for x in tout[1:])
    assert to.shape == (B, K + 1) and toex.shape == (B, K)
    assert ttop_ids.shape == (B, K + 1, 5) and ttop_ids.dtype == np.int32
    assert np.isfinite(tacc).all() and np.isfinite(ttop_lp).all()
    # greedy rows: o at every position, oex and the point-mass accept_p at
    # the draft positions, wherever the JAX top logprobs are decisive
    g = slice(0, 2)
    dec = _decisive(jtop_lp[g])
    np.testing.assert_array_equal(to[g][dec], jo[g][dec])
    np.testing.assert_allclose(to_lp[g], jo_lp[g], atol=LOGIT_ATOL, rtol=0)
    d = tokens[g, 1:]
    hit = d == jtop_ids[g, :K, 0]
    dec_ex = np.where(hit, _decisive(jtop_lp[g, :K], 1),
                      _decisive(jtop_lp[g, :K]))
    np.testing.assert_array_equal(toex[g][dec_ex], joex[g][dec_ex])
    np.testing.assert_array_equal(tacc[g][dec[:, :K]], jacc[g][dec[:, :K]])
    assert set(np.unique(tacc[g])) <= {0.0, 1.0}
    assert (toex[g] != d).all() and tacc[0, 0] == 1.0
    # sampled rows: the acceptance probabilities; every row: the draft's
    # logprob and the top-5 logprobs
    s = slice(2, 4)
    np.testing.assert_allclose(tacc[s], jacc[s], rtol=PROB_RTOL,
                               atol=PROB_ATOL)
    np.testing.assert_allclose(td_lp, jd_lp, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(ttop_lp, jtop_lp, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(toex_lp[g][dec_ex], joex_lp[g][dec_ex],
                               atol=LOGIT_ATOL, rtol=0)
    # the readout names the tokens it scores: a greedy token's logprob is
    # the top one
    np.testing.assert_allclose(to_lp[g][dec], ttop_lp[g][..., 0][dec],
                               atol=1e-6)
    assert (toex[s] != tokens[s, 1:]).all()
    assert np.isfinite(toex_lp).all() and np.isfinite(to_lp).all()


def test_make_verify_refuses_what_the_reference_asserts(tiny):
    _, _, tcfg, _ = tiny
    with pytest.raises(ValueError, match="full window"):
        trunner.make_verify(tcfg, BS, BPS, 2, K, ctx_blocks=4, ragged=True)
    with pytest.raises(ValueError, match="< 1"):
        trunner.make_verify(tcfg, BS, BPS, 2, 0)


# -- shrink -------------------------------------------------------------------

def _caches(**kw):
    kw = dict(dict(n_layers=1, n_kv_heads=1, head_dim=4, total_blocks=16,
                   block_size=4, blocks_per_seq=8), **kw)
    return (PagedKVCache(**kw, dtype=torch.float32,
                         device=torch.device("cpu")),
            JCache(**kw, dtype=jnp.float32))


def _state(cache):
    return ({sid: (a.n_tokens, list(a.blocks))
             for sid, a in cache._seqs.items()},
            cache.allocator.n_free,
            [cache.allocator.refcount(b) for b in range(cache.total_blocks)],
            (cache.rollback_tokens, cache.rollback_calls,
             cache.rollback_blocks))


def test_shrink_rolls_back_trailing_blocks_as_jax_does():
    """tests/test_speculative.py:153 and :170 on both caches."""
    for ops in (
            [("admit", 0, 5), ("extend", 0, 7), ("shrink", 0, 6),
             ("shrink", 0, 0), ("release", 0)],
            [("admit", 0, 4), ("extend", 0, 4), ("shrink", 0, 3),
             ("extend", 0, 9), ("shrink", 0, 10), ("release", 0)]):
        caches = _caches()
        for op, sid, *n in ops:
            for c in caches:
                getattr(c, op)(sid, *n)
            assert _state(caches[0]) == _state(caches[1]), (op, sid, n)
    t, _ = _caches()
    t.admit(0, 5)
    t.extend(0, 7)
    free = t.allocator.n_free
    t.shrink(0, 6)
    assert (t.seq(0).n_tokens, len(t.seq(0).blocks)) == (6, 2)
    assert t.allocator.n_free == free + 1
    with pytest.raises(ValueError, match="below zero"):
        t.shrink(0, 7)


def test_shrink_never_touches_shared_prefix_blocks_as_jax_does():
    """tests/test_cache_alloc.py:126 on both caches: the reused prefix at
    the front keeps its refcounts; a forked tail copied on write is the
    sequence's own and rolls back like a fresh block."""
    caches = _caches(enable_prefix_caching=True)
    tokens = list(range(400, 408))
    for c in caches:
        alloc = c.admit(0, len(tokens))
        c.register_prefix(tokens, alloc.blocks)
        shared = alloc.blocks[:2]
        c.admit(1, len(tokens), reuse_blocks=shared)
        c.extend(1, 5)
        c.shrink(1, 5)
        assert all(c.allocator.refcount(b) == 3 for b in shared)
    assert _state(caches[0]) == _state(caches[1])
    for c in caches:
        c.release(1)
        c.release(0)
        assert all(c.allocator.refcount(b) == 1 for b in shared)
    assert _state(caches[0]) == _state(caches[1])
    # with the copy-on-write tail: a fork's divergent write copies the
    # shared partial block, and a rollback past it frees the copy
    caches = _caches()
    for c in caches:
        c.admit(0, 6)
        c.fork_sequence(0, 1)
        c.extend(1, 1 + K)
        c.shrink(1, K)
    assert _state(caches[0]) == _state(caches[1])
    t = caches[0]
    assert t.cow_copies == 1 and t.seq(1).n_tokens == 7
    t.shrink(1, 2)
    assert t.seq(1).blocks[1] != t.seq(0).blocks[1]
    assert t.allocator.refcount(t.seq(0).blocks[0]) == 2


# -- the engine, JAX against port ---------------------------------------------

@pytest.fixture(scope="module")
def jax_base(tiny):
    return _JaxSide(tiny, {})


def test_spec_greedy_batched_matches_jax(tiny, jax_base):
    """Staggered admissions with speculation: the JAX engine's tokens by
    the tie rule and its counters where equal; the port's spec-on tokens
    equal its spec-off engine's exactly."""
    prompts = _fuzz_prompts(7, 3)
    sp = dict(temperature=0.0, max_new_tokens=12, logprobs=2)
    want, jdelta = jax_base.run(prompts, stagger=True, **sp)
    got, tdelta = _port_run(_port(tiny), prompts, stagger=True, **sp)
    _assert_parity(got, want, tdelta, jdelta, "batched")
    assert tdelta["verify_steps"] > 0
    off = _drive(_port(tiny, speculative_model=""), prompts,
                 SamplingParams(**sp), stagger=True)
    assert [f.token_ids for f in got] == [f.token_ids for f in off]


def test_spec_eos_inside_an_accepted_run_matches_jax(tiny, jax_base):
    p = _fuzz_prompts(3, 1)
    [probe], _ = jax_base.run(p, temperature=0.0, max_new_tokens=16,
                              logprobs=2)
    assert len(probe.token_ids) >= 3
    sp = dict(temperature=0.0, max_new_tokens=16, logprobs=2,
              eos_id=probe.token_ids[2])
    want, jdelta = jax_base.run(p, **sp)
    got, tdelta = _port_run(_port(tiny), p, **sp)
    _assert_parity(got, want, tdelta, jdelta, "eos")
    if got[0].token_ids == want[0].token_ids:
        assert got[0].stop_reason == "eos" and len(got[0].token_ids) <= 2


def test_spec_partial_acceptance_rolls_back_like_jax(tiny, jax_base):
    """After every step the cache holds exactly the committed tokens: the
    rejected drafts' reservations went back to the pool."""
    p = _fuzz_prompts(4, 1)      # 6 of 10 drafts accepted
    sp = dict(temperature=0.0, max_new_tokens=24, logprobs=2)
    bs = ENGINE_KW["block_size"]

    def exact(eng):
        for s in eng.slots:
            if s is None or s.prefill_cursor is not None:
                continue
            alloc = eng.cache.seq(s.req.req_id)
            n = s.req.orig_n_prompt + len(s.generated)
            assert alloc.n_tokens == n
            assert len(alloc.blocks) == max(1, -(-n // bs))

    eng = _port(tiny)
    got, tdelta = _port_run(eng, p, each_step=exact, **sp)
    want, jdelta = jax_base.run(p, **sp)
    _assert_parity(got, want, tdelta, jdelta, "partial")
    assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1
    assert eng.obs.preemptions == 0
    assert 0 < tdelta["accepted"] < tdelta["drafted"]
    assert eng.cache.rollback_tokens == tdelta["drafted"] - tdelta["accepted"]
    assert eng.cache.rollback_calls > 0
    rec = eng.obs.recent_steps(64)
    assert sum(r["rollback_tokens"] for r in rec) == eng.cache.rollback_tokens
    assert rec[-1]["spec"] == eng.spec.as_dict()
    assert eng.obs.snapshot()["spec_acceptance_rate"] == \
        eng.spec.as_dict()["spec_acceptance_rate"]
    assert eng.obs.pad_phase_snapshot()["verify"]["real"] > 0


def test_spec_logprobs_align_with_tokens_and_jax(tiny, jax_base):
    """Every emitted token carries its own entry, accepted drafts too,
    within LOGIT_ATOL of the JAX engine's; the port's spec-off run gives
    the same entries within 1e-5 (the verify rows and the decode row round
    alike on the CPU)."""
    p = _fuzz_prompts(0, 1)
    sp = dict(temperature=0.0, max_new_tokens=10, logprobs=3)
    want, jdelta = jax_base.run(p, **sp)
    got, tdelta = _port_run(_port(tiny), p, **sp)
    _assert_parity(got, want, tdelta, jdelta, "logprobs")
    [fs] = got
    assert len(fs.logprobs) == len(fs.token_ids)
    assert [e["token"] for e in fs.logprobs] == fs.token_ids
    [fw] = want
    n = next((i for i, (a, b) in enumerate(zip(fs.token_ids, fw.token_ids))
              if a != b), len(fs.token_ids))
    for a, b in zip(fs.logprobs[:n], fw.logprobs[:n]):
        assert a["token"] == b["token"]
        assert abs(a["logprob"] - b["logprob"]) <= LOGIT_ATOL
    [fv] = _drive(_port(tiny, speculative_model=""), p, SamplingParams(**sp))
    assert fv.token_ids == fs.token_ids
    for a, b in zip(fs.logprobs, fv.logprobs):
        assert a["token"] == b["token"] and a["top_ids"] == b["top_ids"]
        assert abs(a["logprob"] - b["logprob"]) <= 1e-5


def test_spec_commits_several_tokens_per_verify_like_jax(tiny, jax_base):
    """tests/test_speculative.py's acceptance benchmark: over its seeds of
    repetitive prompts the engine reaches at least 2 tokens per verify;
    that run held against the JAX engine."""
    sp = dict(temperature=0.0, max_new_tokens=32, logprobs=2)
    best = 0.0
    for seed in range(5):
        rng = np.random.default_rng(seed)
        prompt = (rng.integers(3, 500, 4).tolist() * 6)[:24]
        eng = _port(tiny)
        got, tdelta = _port_run(eng, [prompt], **sp)
        best = max(best, eng.spec.tokens_per_verify)
        if best >= 2.0:
            break
    assert best >= 2.0, f"tokens/verify peaked at {best:.2f}"
    want, jdelta = jax_base.run([prompt], **sp)
    _assert_parity(got, want, tdelta, jdelta, "repetitive")


def test_spec_block_pressure_preempts_like_jax(tiny, jax_base):
    """1 + k reservations per step over the 8-block pool: preemption
    (inside the verify step's reservation too) drains every request at
    full length and the pool comes back whole."""
    prompts = [[1, 5, 9, 11], [1, 200, 300], [2, 7, 9, 13, 15]]
    sp = dict(temperature=0.0, max_new_tokens=24, logprobs=2)
    want, jdelta = jax_base.run(prompts, **sp)
    eng = _port(tiny)
    got, tdelta = _port_run(eng, prompts, **sp)
    _assert_parity(got, want, tdelta, jdelta, "pressure")
    assert [len(f.token_ids) for f in got] == [24] * 3
    assert eng.obs.preemptions > 0
    assert eng.cache.allocator.n_free == 8 and eng.cache.leaked_blocks == 0


def test_spec_ragged_int8_matches_jax(tiny):
    env = {"SHAI_RAGGED_ATTENTION": "1", "SHAI_KV_QUANT": "int8"}
    prompts = _fuzz_prompts(5, 2)
    sp = dict(temperature=0.0, max_new_tokens=12, logprobs=2)
    want, jdelta = _JaxSide(tiny, env).run(prompts, **sp)
    eng = _port(tiny, env)
    assert eng._ragged and eng._kv_quant
    got, tdelta = _port_run(eng, prompts, **sp)
    _assert_parity(got, want, tdelta, jdelta, "ragged-int8")
    assert tdelta["verify_steps"] > 0 and eng.cache.leaked_blocks == 0


def test_spec_with_the_prefix_cache_matches_jax(tiny):
    """Two requests sharing a 16-token prefix one after the other: the
    second is a cached admission, then verifies over the shared blocks;
    the rollback never touches them."""
    rng = np.random.default_rng(4)
    shared = (rng.integers(3, 500, 4).tolist() * 4)
    prompts = [shared + [7, 8, 9], shared + [7, 8, 10, 11]]
    sp = dict(temperature=0.0, max_new_tokens=12, logprobs=2)
    jax_side = _JaxSide(tiny, {}, enable_prefix_caching=True)
    eng = _port(tiny, enable_prefix_caching=True)
    for p in prompts:
        want, jdelta = jax_side.run([p], **sp)
        got, tdelta = _port_run(eng, [p], **sp)
        _assert_parity(got, want, tdelta, jdelta, "prefix")
    assert eng.spec.verify_steps > 0
    assert eng.cache.leaked_blocks == 0
    assert len(eng.cache.cached_prefix(shared + [1])) == 2


# -- the port alone -----------------------------------------------------------

def test_spec_async_equals_lock_step_and_sampled_rows_finish(tiny):
    prompts = _fuzz_prompts(5, 3)
    for sp in (dict(temperature=0.0, max_new_tokens=12, logprobs=2),
               dict(temperature=1.0, top_k=8, max_new_tokens=16)):
        runs = []
        for async_on in ("1", "0"):
            eng = _port(tiny, {"SHAI_ASYNC_DECODE": async_on})
            assert eng._async is (async_on == "1")
            fins, stats = _port_run(eng, prompts, stagger=True, **sp)
            runs.append(([(f.token_ids, f.stop_reason, f.logprobs)
                          for f in fins], stats))
            assert all(len(f.token_ids) == sp["max_new_tokens"]
                       for f in fins)
            assert eng.cache.leaked_blocks == 0
            if async_on == "1":
                assert eng.obs.flush_reasons().get("spec", 0) > 0
        assert runs[0] == runs[1]
        st = runs[0][1]
        assert st["committed"] >= st["accepted"] and st["verify_steps"] > 0


def test_spec_warms_the_verify_ladder_and_keeps_fused_off(tiny):
    """The verify ladder mirrors decode's (ctx, batch) grid and is
    captured (run, on the CPU) before readiness; nothing builds after it.
    ``SHAI_FUSED_STEP=1`` stays off under speculation."""
    eng = _port(tiny)
    n = eng.warm_executables()
    assert set(eng._verify_fns) == set(eng._decode_fns)
    assert n == eng.n_executables == eng.obs.warmed_executables
    assert all(g.key == ("verify",) + key and g.verify_k == K
               and g.replays == 1 for key, g in eng._verify_fns.items())
    _drive(eng, _fuzz_prompts(9, 3), SamplingParams(temperature=0.0,
                                                    max_new_tokens=20))
    assert eng.obs.recompiles == 0 and eng.n_executables == n
    fused = _port(tiny, {"SHAI_RAGGED_ATTENTION": "1",
                         "SHAI_FUSED_STEP": "1"})
    assert fused._ragged and not fused._fused
    fused.warm_executables()
    assert not fused._fused_fns and fused._fused_chunk is None
    assert set(fused._verify_fns) == set(fused._decode_fns)
    with pytest.raises(ValueError, match="tensor_parallel_size=2 but the "
                       "engine's group has 1 rank"):
        _port(tiny, tensor_parallel_size=2)


# -- serving ------------------------------------------------------------------

def _http(url, payload=None, raw=False):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read().decode()
            return r.status, body if raw else json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, None


def _jax_spec_families():
    """name -> (type, label names) of the JAX publisher's speculative
    families after one advance (``prometheus_client``'s family names)."""
    pub = jmetrics.MetricsPublisher("vllm", "pool", pod_name="pod-0",
                                    stream=io.StringIO())
    pub.publish_spec(drafted=4, accepted=3, committed=5)
    return {m.name: (m.type, frozenset(k for s in m.samples
                                       for k in s.labels))
            for m in pub.registry.collect() if m.name.startswith("shai_spec")}


def test_publish_spec_pushes_the_jax_lines():
    """tests/test_speculative.py's publisher case on both packages: the
    same JSON lines, an unchanged snapshot quiet."""
    lines = []
    for mod in (jmetrics, tmetrics):
        stream = io.StringIO()
        pub = mod.MetricsPublisher("vllm-x", "pool-a", pod_name="pod-0",
                                   stream=stream)
        for snap in ((10, 7, 12), (10, 7, 12), (20, 15, 25)):
            pub.publish_spec(*snap)
        lines.append([json.loads(ln)["data"]
                      for ln in stream.getvalue().splitlines()])
    assert lines[0] == lines[1] and len(lines[1]) == 2
    assert lines[1][-1]["vllm-x-spec-acceptance"] == 0.75
    text = pub.render()
    got = {s.name: s.value for f in text_string_to_metric_families(text)
           for s in f.samples if s.name.startswith("shai_spec")}
    assert got == {"shai_spec_drafted_total": 20.0,
                   "shai_spec_accepted_total": 15.0,
                   "shai_spec_committed_total": 25.0}


def test_unit_serves_the_tiny_tier_with_spec_keys(tmp_path, monkeypatch):
    """The ``vllm`` unit with ``speculative_model: "[ngram]"`` in its
    ConfigMap: a repetitive prompt speculates, ``/stats`` carries the
    counters, ``/metrics`` the JAX pod's ``shai_spec_*`` families."""
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
        VllmService,
    )
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
        ServeConfig,
    )

    for k, v in BASE_ENV.items():
        monkeypatch.setenv(k, v)
    path = tmp_path / "vllm_config.yaml"
    path.write_text(json.dumps({
        "max_model_len": 256, "context_encoding_buckets": [32, 64, 128],
        "speculative_model": "[ngram]",
        "num_speculative_tokens": K, "ngram_prompt_lookup_max": 4,
        "ngram_prompt_lookup_min": 1}))
    cfg = ServeConfig(app="vllm", device="cpu", model_id="tiny",
                      batch_size=2, max_new_tokens=24, warmup=False,
                      vllm_config=str(path))
    service = VllmService(cfg)
    srv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    host, port = srv.start_background()
    base = f"http://{host}:{port}"
    try:
        deadline = time.monotonic() + 120
        while (status := _http(base + "/readiness")[0]) != 200:
            assert status == 503 and time.monotonic() < deadline, status
            time.sleep(0.1)
        eng = service._engine
        assert eng.spec is not None and eng.ecfg.num_speculative_tokens == K
        assert set(eng._verify_fns) == set(eng._decode_fns)
        status, out = _http(base + "/generate", {
            "prompt": "abcd" * 8, "temperature": 0.0,
            "max_new_tokens": 24})
        assert status == 200 and out["n_tokens"] == 24
        st = _http(base + "/stats")[1]
        stats = st.get("service", st)
        assert stats["spec_verify_steps"] == eng.spec.verify_steps > 0
        assert stats["spec_committed"] == eng.spec.committed
        status, text = _http(base + "/metrics", raw=True)
        fams = {f.name: (f.type, frozenset(k for s in f.samples
                                           for k in s.labels))
                for f in text_string_to_metric_families(text)}
        want = _jax_spec_families()
        assert {n: fams[n] for n in want} == want
        samples = {s.name: s.value for f in
                   text_string_to_metric_families(text) for s in f.samples}
        assert samples["shai_spec_committed_total"] == eng.spec.committed
        assert samples["shai_spec_drafted_total"] == eng.spec.drafted
        gauge = jmetrics._ENGINE_GAUGES["spec_acceptance_rate"][0]
        assert fams[gauge][0] == "gauge"
        assert samples[gauge] == eng.spec.as_dict()["spec_acceptance_rate"]
        assert eng.obs.recompiles == 0 and eng.cache.leaked_blocks == 0
    finally:
        srv.stop()
        service.close()
