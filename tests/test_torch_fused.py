"""The port's fused mixed-phase step (``SHAI_FUSED_STEP``) and B3 over
mixed-phase rows, against the JAX package's, on the CPU.

Port of the fused half of ``tests/test_fused_cow.py`` (its cases that do
not need the prefix cache) and of the mixed-row layout of
``tests/test_ragged_quant.py``. Both packages read the same weights (a
flax init carried over with ``params_from_jax``; the tiny config, 2
layers, head dim 16). What is held:

- ``mixed_phase_ragged_attention`` and B3's plain row-group contract
  (``ragged_paged_attention(groups=...)``) against the JAX function, run
  as ``tests/test_ragged_quant.py`` runs it: the Pallas kernel in
  interpret mode and the gather oracle, on an f32 and an int8 pool, within
  ``ATTN_ATOL`` (2e-5: fp32 softmaxes summed in another order); the
  groups' launch plan, scratch and the group table handed to the C entry
  point (a recorder stands in for the library: there is no card here);
- ``runner.make_fused_step`` against the JAX package's on one pool state
  (logits within ``LOGIT_ATOL`` 6e-2 and pools within ``POOL_ATOL`` 5e-2,
  the bf16 tolerances of ``tests/test_torch_chunked.py``), and bit for bit
  against the port's own laddered functions (the ragged continuation, then
  the ragged decode step) on the same inputs and draws;
- the engine: the port's fused engine is TOKEN-EXACT against its
  laddered ragged engine (tokens, stop reasons, logprob entries and a
  whole pool) for greedy, top-k and top-p rows, async and lock-step, with
  chunked prefill, preemption and an int8 pool: both draw their uniforms
  from one generator in the same order. Greedy tokens are held to the JAX
  fused engine with ``tests/parity.py``'s ``assert_greedy_parity``; the
  JAX engine decodes through its Pallas kernels in interpret mode
  (``SHAI_PAGED_DECODE=1``), as the other engine parity tests run it;
  sampled rows agree with it in distribution only
  (``tests/test_torch_ops.py``);
- the fused engine never builds a continuation function, its warmed set
  collapses to the JAX fused engine's count, and nothing builds after it;
  ``SHAI_FUSED_STEP`` without ragged attention is off, in both packages.

- the oracle's two prefix-cache cases, on both packages: with the cache
  on and an unquantized pool, the fused engine's cached admission (one
  chunk-only call over the uncached remainder, its start as data) is
  token-exact against the laddered ragged engine, and the port's greedy
  tokens are held to the JAX fused engine's; an int8 pool under the fused
  step declines the cached path (plain admission, no recompute split)
  and still serves, with no leaked block.
"""

import ctypes
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import config as jconfig
from scalable_hw_agnostic_inference_tpu.engine import runner as jrunner
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.ops import attention as jattn
from scalable_hw_agnostic_inference_tpu.ops.pallas.ragged_paged_attention import (  # noqa: E501
    ragged_paged_attention as jkernel,
)
from scalable_hw_agnostic_inference_tpu.ops.quant import (
    quantize_kv_blocks as jquantize,
)
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine import runner as trunner
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import PagedKVCache
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
    DecodeGraph,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.ops import attention as tattn
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
    ragged_paged_attention as trpa,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ATTN_ATOL = 2e-5
LOGIT_ATOL = 6e-2
POOL_ATOL = 5e-2

# the oracle's engine shapes: buckets (16, 32), a 128-token window
ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16, 32),
                 token_generation_buckets=(32, 64), max_new_tokens=16)
MIXED = [[1, 5, 9], [2] * 20, [7, 3] * 14, [4]]  # mixed lengths, on purpose
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


def _switches(monkeypatch, fused, quant, async_on, ragged=True):
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_on else "0")
    monkeypatch.setenv("SHAI_RAGGED_ATTENTION", "1" if ragged else "0")
    monkeypatch.setenv("SHAI_FUSED_STEP", "1" if fused else "0")
    monkeypatch.setenv("SHAI_KV_QUANT", "int8" if quant else "")
    monkeypatch.setenv("SHAI_KV_COW", "0")
    # the JAX engine's pool kernels in interpret mode
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")


def _port(tiny, monkeypatch, fused=True, quant=False, async_on=True,
          ragged=True, **over):
    _, _, tcfg, model = tiny
    _switches(monkeypatch, fused, quant, async_on, ragged)
    eng = LLMEngine(tcfg, model,
                    tconfig.EngineConfig(**dict(ENGINE_KW, **over)),
                    device="cpu")
    assert eng._fused is (fused and ragged)
    return eng


def _jax(tiny, monkeypatch, fused=True, quant=False, async_on=True,
         ragged=True, **over):
    jcfg, params, _, _ = tiny
    _switches(monkeypatch, fused, quant, async_on, ragged)
    eng = JEngine(jcfg, params,
                  jconfig.EngineConfig(**dict(ENGINE_KW, **over)))
    assert eng._fused is (fused and ragged)
    return eng


def _assert_pool_whole(eng):
    assert eng.cache.leaked_blocks == 0
    assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1


def _assert_finished_equal(a, b):
    assert a.token_ids == b.token_ids, (a.req_id, a.token_ids, b.token_ids)
    assert a.stop_reason == b.stop_reason
    assert a.logprobs == b.logprobs


def _greedy_vs_jax(tiny, monkeypatch, prompts, quant=False, **over):
    """The port's fused engine against the JAX fused engine, greedy."""
    teng = _port(tiny, monkeypatch, quant=quant, **over)
    got = teng.generate(prompts, SamplingParams(**SAMPLING["greedy"]))
    jeng = _jax(tiny, monkeypatch, quant=quant, **over)
    want = jeng.generate(prompts, JParams(**SAMPLING["greedy"]))
    assert [f.stop_reason for f in got] == [f.stop_reason for f in want]
    assert_greedy_parity(got, want, label=f"fused quant={quant}")
    _assert_pool_whole(teng)
    assert jeng.cache.leaked_blocks == 0
    return teng


# -- B3 over mixed-phase rows --------------------------------------------------

def _pool_fixture(quant):
    """``tests/test_ragged_quant.py``'s pool: 12 blocks of 8 tokens, 2 kv
    heads of 16, 4 query heads; three decode rows and a 5-token chunk
    whose table is none of theirs."""
    rng = np.random.default_rng(3)
    kp = rng.normal(size=(12, 8, 2, 16)).astype(np.float32)
    vp = rng.normal(size=(12, 8, 2, 16)).astype(np.float32)
    q_dec = rng.normal(size=(3, 4, 16)).astype(np.float32)
    q_chunk = rng.normal(size=(5, 4, 16)).astype(np.float32)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0]], np.int32)
    c_table = np.asarray([[8, 9, 10, 11]], np.int32)
    pos_dec = np.asarray([28, 10, 2], np.int32)
    c_pos = np.arange(20, 25, dtype=np.int32)   # the chunk at start 20
    ks = vs = None
    if quant:
        kq, ks = jquantize(jnp.asarray(kp))
        vq, vs = jquantize(jnp.asarray(vp))
        kp, vp, ks, vs = (np.asarray(x) for x in (kq, vq, ks, vs))
    return q_dec, q_chunk, kp, vp, tables, c_table, pos_dec, c_pos, ks, vs


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_mixed_phase_attention_matches_jax(quant):
    """The port's ``mixed_phase_ragged_attention`` (B3's plain version over
    row groups) against the JAX function through its Pallas kernel in
    interpret mode and through its gather oracle."""
    args = _pool_fixture(quant)
    got = tattn.mixed_phase_ragged_attention(*map(_t, args))

    def pallas(qf, kp, vp, tf, lf, ks, vs):
        return jkernel(qf, kp, vp, tf, lf, ks, vs, interpret=True)

    for pool_call in (pallas, None):
        want = jattn.mixed_phase_ragged_attention(*map(_j, args),
                                                  pool_call=pool_call)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=ATTN_ATOL, rtol=0)
    assert got[0].shape == (3, 4, 16) and got[1].shape == (5, 4, 16)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_row_groups_match_repeated_tables(quant):
    """B3's plain row-group contract: each row attends through its group's
    table row, as the TPU kernel does on the table repeated per row. A
    group of 3 rows between groups of one, and two groups on one table."""
    q_dec, q_chunk, kp, vp, tables, _, pos_dec, _, ks, vs = \
        _pool_fixture(quant)
    q = np.concatenate([q_dec, q_chunk])              # 8 rows
    groups = ((0, 1, 0), (1, 3, 2), (4, 1, 1), (5, 3, 0))
    per_row = np.asarray([0, 2, 2, 2, 1, 0, 0, 0])
    lengths = np.asarray([29, 3, 2, 1, 11, 30, 31, 32], np.int32)
    got = trpa.ragged_paged_attention(
        _t(q), _t(kp), _t(vp), _t(tables), _t(lengths), _t(ks), _t(vs),
        groups=groups)
    want = jattn.ragged_paged_attention(
        _j(q), _j(kp), _j(vp), _j(tables[per_row]), _j(lengths), _j(ks),
        _j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATTN_ATOL, rtol=0)


def test_row_groups_refuse_a_bad_layout():
    q_dec, _, kp, vp, tables, _, _, _, _, _ = _pool_fixture(False)
    lens = torch.tensor([5, 5, 5], dtype=torch.int32)
    call = dict(q=_t(q_dec), k_pool=_t(kp), v_pool=_t(vp),
                tables=_t(tables), lengths=lens)
    for bad in (((0, 1, 0), (1, 1, 1)),              # row 2 uncovered
                ((0, 2, 0), (1, 2, 1)),              # overlapping
                ((0, 3, 3),),                         # no table row 3
                ((0, 1, 0), (1, 0, 1), (1, 2, 1))):   # an empty group
        with pytest.raises(ValueError, match="row groups"):
            trpa.ragged_paged_attention(**call, groups=bad)
    with pytest.raises(ValueError, match="exclude"):
        trpa.ragged_paged_attention(**call, groups=((0, 3, 0),),
                                    rows_per_table=3)


def test_groups_plan_and_scratch():
    """Decode groups split by the decode plan over their own count; the
    chunk's group takes tile CTAs of 64 / G rows, unsplit; the scratch
    holds the decode groups' partials and counters only."""
    H, Hkv, D, bs, M, sms = 32, 8, 128, 16, 256, 132
    fused8 = tattn.mixed_phase_groups(8, 512)
    rt, splits = trpa.groups_plan(fused8, H, Hkv, bs, M, sms)
    assert rt == 16
    assert splits == trpa.decode_plan(8, H, Hkv, bs, M, sms)[1] > 1
    assert trpa.groups_scratch_size(fused8, H, Hkv, D, bs, M, sms) == (
        splits * 9 * H * (D + 2), 9 * Hkv)
    # a chunk alone: no decode group, nothing split
    assert trpa.groups_plan(((0, 512, 0),), H, Hkv, bs, M, sms) == (16, 1)
    assert trpa.groups_scratch_size(((0, 512, 0),), H, Hkv, D, bs, M,
                                    sms) == (0, 0)
    # more than 32 query heads per kv head: groups of one take tile CTAs
    assert trpa.groups_plan(((0, 1, 0), (1, 1, 1)), 64, 1, bs, M,
                            sms) == (1, 1)


def test_groups_launch_hands_the_group_table_to_the_kernel(monkeypatch):
    """The CUDA route of a row-group call: checks, plan, split scratch and
    the host group table handed by value to
    ``shai_ragged_paged_attention_groups``, counted as one B3 launch. A
    recorder stands in for the kernel library (there is no card here)."""
    seen = {}

    class Lib:
        def shai_ragged_paged_attention_groups(self, *a):
            n = a[12]
            seen["groups"] = list(
                (ctypes.c_int * (3 * n)).from_address(a[11]))
            seen["args"] = a
            return 0

    monkeypatch.setattr(trpa._build, "library", lambda: Lib())
    monkeypatch.setattr(trpa, "_check_launch", lambda *a: False)
    monkeypatch.setattr(trpa, "sm_count", lambda index: 132)
    monkeypatch.setattr(trpa, "_scratch", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(trpa.ragged_paged_attention, "launches", 0)
    B, C, H, Hkv, D, bs, M = 4, 64, 32, 8, 128, 16, 32
    q = torch.zeros(B + C, H, D, dtype=torch.bfloat16)
    kp = torch.zeros(8, bs, Hkv, D, dtype=torch.bfloat16)
    tables = torch.zeros(B + 1, M, dtype=torch.int32)
    lens = torch.ones(B + C, dtype=torch.int32)
    groups = tuple((i, 1, i) for i in range(B)) + ((B, C, B),)
    out = trpa._launch_groups(trpa.ragged_paged_attention, q, kp, kp,
                              tables, lens, None, None, None, groups)
    assert out.shape == q.shape
    assert trpa.ragged_paged_attention.launches == 1
    assert seen["groups"] == [x for g in groups for x in g]
    a = seen["args"]
    rt, splits = trpa.groups_plan(groups, H, Hkv, bs, M, 132)
    # n_groups, rows, rows_per_tile, dec_splits, H, Hkv, D, bs, M, n_tables
    assert a[12:22] == (B + 1, B + C, rt, splits, H, Hkv, D, bs, M, B + 1)
    assert splits > 1 and a[8] and a[9] and a[10]   # partials, counters
    with pytest.raises(ValueError, match="at most"):
        many = tuple((i, 1, i) for i in range(trpa.MAX_GROUPS + 1))
        trpa._launch_groups(trpa.ragged_paged_attention,
                            torch.zeros(len(many), H, D), kp, kp,
                            torch.zeros(len(many), M, dtype=torch.int32),
                            torch.ones(len(many), dtype=torch.int32), None,
                            None, None, many)


# -- the fused step in the runner ---------------------------------------------

BS, BPS, N_BLOCKS, C = 8, 16, 40, 32


def _random_pools(cfg, seed):
    """The same random bf16 pool for both packages."""
    rng = np.random.default_rng(seed)
    shape = (N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim)
    jkv, tkv = [], PagedKVCache(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                                N_BLOCKS, BS, BPS,
                                device=torch.device("cpu")).kv
    for lay in tkv:
        jl = {}
        for name in ("k", "v"):
            x = rng.normal(size=shape).astype(np.float32)
            lay[name].copy_(torch.from_numpy(x))
            jl[name] = jnp.asarray(x, jnp.bfloat16)
        jkv.append(jl)
    return jkv, tkv


def _step_inputs(cfg):
    """Three decode rows (one a padding row on null tables) and a 20-token
    chunk at start 40 whose table holds blocks none of them reads."""
    rng = np.random.default_rng(8)
    tables = np.zeros((3, BPS), np.int32)
    tables[0, :4] = [3, 7, 12, 4]
    tables[1, :6] = [20, 21, 22, 23, 24, 25]
    c_table = np.zeros((1, BPS), np.int32)
    c_table[0, :8] = [30, 31, 32, 33, 34, 35, 36, 37]
    ids = np.zeros((1, C), np.int32)
    ids[0, :20] = rng.integers(3, cfg.vocab_size, 20)
    return dict(tokens=np.asarray([5, 9, 0], np.int32),
                pos=np.asarray([29, 44, 0], np.int32), tables=tables,
                c_ids=ids, c_ntext=np.asarray([20], np.int32),
                c_table=c_table, c_start=np.asarray([40], np.int32),
                temp=np.asarray([0.0, 0.8, 1.0], np.float32),
                topk=np.asarray([0, 4, 0], np.int32),
                topp=np.ones((3,), np.float32))


def test_fused_step_matches_jax_runner(tiny):
    """``make_fused_step`` against the JAX package's on one pool state:
    the chunk's raw logits, the decode rows' logprob readout, the greedy
    row's token and the pool after the step."""
    jcfg, params, tcfg, model = tiny
    jkv, tkv = _random_pools(jcfg, 11)
    a = _step_inputs(jcfg)
    jfn = jrunner.make_fused_step(jcfg, BS, BPS, 3, C, feedback=True)
    tfn = trunner.make_fused_step(tcfg, BS, BPS, 3, C)
    jkv, jnxt, jpos, _, jtop, jtok, jcl = jfn(
        params, jkv, *(jnp.asarray(a[k]) for k in ("tokens", "pos",
                                                    "tables")),
        jnp.ones((3,), bool), jax.random.PRNGKey(0),
        *(jnp.asarray(a[k]) for k in ("temp", "topk", "topp", "c_ids",
                                      "c_ntext", "c_table", "c_start")))
    uniforms = torch.rand(3, tcfg.vocab_size,
                          generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        tkv, tnxt, tpos, _, ttop, ttok, tcl = tfn(
            model, tkv, *(_t(a[k]) for k in ("tokens", "pos", "tables")),
            uniforms, *(_t(a[k]) for k in ("temp", "topk", "topp",
                                            "c_ids", "c_ntext", "c_table",
                                            "c_start")))
    np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(ttop.numpy()[:2], np.asarray(jtop)[:2],
                               atol=LOGIT_ATOL, rtol=0)
    assert int(tnxt[0]) == int(jnxt[0])     # the greedy row, decisive here
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    for jl, tl in zip(jkv, tkv):
        for name in ("k", "v"):
            got, want = tl[name].float().numpy(), np.asarray(
                jl[name].astype(jnp.float32))
            # the padding row's write lands in null block 0 on both sides
            np.testing.assert_allclose(got[1:], want[1:], atol=POOL_ATOL,
                                       rtol=0)


def test_fused_step_is_the_laddered_pair_bit_for_bit(tiny):
    """On the CPU the fused step is exactly the ragged continuation
    followed by the ragged decode step on the same inputs and draws: the
    chunk's logits, the tokens, the logprob readout and every live block
    of the pool."""
    _, _, tcfg, model = tiny
    _, fkv = _random_pools(tcfg, 12)
    _, lkv = _random_pools(tcfg, 12)
    a = {k: _t(v) for k, v in _step_inputs(tcfg).items()}
    uniforms = torch.rand(3, tcfg.vocab_size,
                          generator=torch.Generator().manual_seed(2))
    fused = trunner.make_fused_step(tcfg, BS, BPS, 3, C)
    cont = trunner.make_prefill_cont(tcfg, BS, BPS, C, ragged=True)
    decode = trunner.make_decode(tcfg, BS, BPS, 3, ragged=True,
                                 feedback=True)
    knobs = (a["temp"], a["topk"], a["topp"])
    with torch.inference_mode():
        _, *f_out = fused(model, fkv, a["tokens"], a["pos"], a["tables"],
                          uniforms, *knobs, a["c_ids"], a["c_ntext"],
                          a["c_table"], a["c_start"])
        _, c_logits = cont(model, lkv, a["c_ids"], a["c_ntext"],
                           a["c_table"], a["c_start"])
        _, *d_out = decode(model, lkv, a["tokens"], a["pos"], a["tables"],
                           uniforms, *knobs)
    for got, want in zip(f_out, d_out + [c_logits]):
        assert torch.equal(got, want)
    # every block but the null block 0, which the padding row and the
    # window's tail past its table both write (garbage by contract: the
    # chunk's padding queries read it in another order)
    for fl, ll in zip(fkv, lkv):
        for name in fl:
            assert torch.equal(fl[name][1:], ll[name][1:])


def test_fused_graph_holds_the_window(tiny):
    """A fused graph's chunk window is static input: the null window (zero
    ids and table, one token) until one is loaded, back to null after.
    On the CPU a replay runs the fused step eagerly on those inputs, and
    the chunk's raw logits are a static output beside the decode's."""
    _, _, tcfg, model = tiny
    _, kv = _random_pools(tcfg, 13)
    fused = trunner.make_fused_step(tcfg, BS, BPS, 1, C)
    g = DecodeGraph(1, fused, model, kv, 1, BPS, tcfg.vocab_size,
                    device="cpu", chunk=C)
    a = g.inputs
    assert g.outputs[-1] == "c_logits" and not g.window
    assert int(a["c_ntext"]) == 1 and not a["c_ids"].any()
    s = _step_inputs(tcfg)
    g.load_window((s["c_ids"], 20, s["c_table"], 40))
    assert g.window and int(a["c_ntext"]) == 20 and int(a["c_start"]) == 40
    assert torch.equal(a["c_table"], _t(s["c_table"]))
    g.replay()
    assert g.c_logits.shape == (1, tcfg.vocab_size) and g.nxt.shape == (1,)
    g.load_window(None)
    assert not g.window and int(a["c_ntext"]) == 1
    assert not (a["c_ids"].any() or a["c_table"].any() or a["c_start"].any())


# -- the engine -----------------------------------------------------------------

@pytest.mark.parametrize("async_on", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("mode", list(SAMPLING))
def test_fused_matches_laddered_oracle(tiny, monkeypatch, mode, async_on):
    """Token-exact, sampled rows included, against the laddered ragged
    engine: the same tokens, stop reasons, logprob entries, whole pools."""
    sp = SamplingParams(**SAMPLING[mode])
    a = _port(tiny, monkeypatch, fused=True, async_on=async_on)
    b = _port(tiny, monkeypatch, fused=False, async_on=async_on)
    for x, y in zip(a.generate(MIXED, sp), b.generate(MIXED, sp)):
        _assert_finished_equal(x, y)
    _assert_pool_whole(a)
    _assert_pool_whole(b)
    assert a._fused_fns and not a._decode_fns


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_fused_greedy_matches_jax(tiny, monkeypatch, quant):
    teng = _greedy_vs_jax(tiny, monkeypatch, MIXED, quant=quant)
    assert teng._fused_fns


def test_fused_chunked_prefill_parity(tiny, monkeypatch):
    """A 70-token prompt past the 32 bucket beside a short one: the fused
    engine parks the intermediate chunk on a decode replay and runs the
    final one chunk-only; the laddered engine runs the ragged
    continuation. Same tokens; the fused engine built no continuation; the
    pad ledger splits by phase and sums to its totals."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 200, 70).tolist(), [9, 8, 7]]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    outs = {}
    for fused in (True, False):
        eng = _port(tiny, monkeypatch, fused=fused)
        if fused:
            loads = []
            real = DecodeGraph.load_window
            monkeypatch.setattr(
                DecodeGraph, "load_window",
                lambda g, w: loads.append((g.key, w is not None))
                or real(g, w))
        outs[fused] = [f.token_ids for f in eng.generate(prompts, sp)]
        _assert_pool_whole(eng)
        if fused:
            fused_eng = eng
            monkeypatch.setattr(DecodeGraph, "load_window", real)
    assert outs[True] == outs[False]
    assert not any(k[0] in ("cont", "rcont") for k in fused_eng._prefill)
    # 70 tokens: 32 by prefill, the 32 at start 32 rides a decode replay
    # (a batch key), the last 6 run chunk-only
    assert [k for k, live in loads if live] == [1, ("chunk", 1)]
    snap = fused_eng.obs.snapshot()
    by_phase = snap["pad_by_phase"]
    assert {"prefill", "decode", "chunk"} <= set(by_phase)
    assert sum(e["pad"] for e in by_phase.values()) == snap["pad_tokens"]
    assert sum(e["real"] for e in by_phase.values()) == snap["real_tokens"]
    _greedy_vs_jax(tiny, monkeypatch, prompts)


def test_fused_preemption_parity(tiny, monkeypatch):
    """A pool too small for the batch forces a recompute preemption; the
    fused and laddered engines preempt alike and give the same tokens,
    and the JAX fused engine's greedy tokens."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=12)
    prompts = [[1, 2, 3, 4, 5, 6], [9, 8, 7, 6, 5]]
    fins = {}
    for fused in (True, False):
        eng = _port(tiny, monkeypatch, fused=fused, num_blocks=6)
        fins[fused] = eng.generate(prompts, sp)
        assert eng.obs.preemptions >= 1
        _assert_pool_whole(eng)
    assert ([(f.token_ids, f.stop_reason) for f in fins[True]]
            == [(f.token_ids, f.stop_reason) for f in fins[False]])
    jeng = _jax(tiny, monkeypatch, num_blocks=6)
    want = jeng.generate(prompts, JParams(temperature=0.0, logprobs=2,
                                          max_new_tokens=12))
    assert_greedy_parity(fins[True], want, label="fused preemption")
    assert jeng.obs.preemptions >= 1


def test_fused_parked_window_never_outlives_its_step(tiny, monkeypatch):
    """A parked window no decode replay took runs chunk-only at the end of
    its step, and a preemption dispatches a parked window before it
    releases any block (the laddered engine's order)."""
    eng = _port(tiny, monkeypatch)
    calls = []
    real = eng._fused_chunk_call
    monkeypatch.setattr(eng, "_fused_chunk_call",
                        lambda w: calls.append(w[3]) or real(w))

    def window(start):
        return (np.zeros((1, 32), np.int32), 5,
                np.zeros((1, eng.ecfg.blocks_per_seq), np.int32), start)

    eng._pending_chunk = window(32)
    eng.step()                     # nothing decodes: chunk-only
    assert calls == [32] and eng._pending_chunk is None
    rid = eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=4))
    eng.step()                     # admitted and decoding
    eng._pending_chunk = window(64)
    eng._preempt_lowest()
    assert calls == [32, 64] and eng._pending_chunk is None
    assert eng.waiting[0].req_id == rid and eng.n_running == 0
    _assert_pool_whole(eng)


@pytest.mark.parametrize("async_on", [True, False], ids=["async", "sync"])
def test_fused_int8_kv_parity(tiny, monkeypatch, async_on):
    """Quant on both sides: the fused step's requantizing decode writes
    and whole-block chunk scatter match the laddered engine's exactly,
    with a prompt that chunks."""
    rng = np.random.default_rng(6)
    prompts = MIXED + [rng.integers(3, 200, 50).tolist()]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    outs = {}
    for fused in (True, False):
        eng = _port(tiny, monkeypatch, fused=fused, quant=True,
                    async_on=async_on)
        outs[fused] = [f.token_ids for f in eng.generate(prompts, sp)]
        _assert_pool_whole(eng)
    assert outs[True] == outs[False]


def test_fused_ladder_collapses_and_stays_closed(tiny, monkeypatch):
    """The fused engine warms fewer executables than the laddered one (the
    decode grid and the continuation collapse into one fused key per batch
    bucket), the JAX fused engine's count, and builds nothing after."""
    a = _port(tiny, monkeypatch, fused=True)
    b = _port(tiny, monkeypatch, fused=False)
    na, nb = a.warm_executables(), b.warm_executables()
    assert not a._decode_fns and a._fused_fns and a._fused_chunk is not None
    assert na == a.n_executables < b.n_executables == nb
    j = _jax(tiny, monkeypatch, fused=True)
    j.warm_executables()
    assert a.n_executables == j.n_executables
    rng = np.random.default_rng(9)
    a.generate([rng.integers(3, 200, n).tolist() for n in (4, 20, 40, 70)],
               SamplingParams(temperature=0.0, max_new_tokens=6))
    assert a.obs.recompiles == 0 and a.n_executables == na
    _assert_pool_whole(a)


def test_fused_prefix_cache_parity(tiny, monkeypatch):
    """Quant off, cache on: the fused cached admission runs the chunk-only
    call over the remainder; tokens (and logprob entries) equal the
    laddered engine's in each package, and the port's greedy tokens are
    held to the JAX engine's."""
    jcfg, params, _, _ = tiny
    rng = np.random.default_rng(7)
    prompt = rng.integers(3, 200, 40).tolist()
    outs = {}
    for pkg, Params in (("port", SamplingParams), ("jax", JParams)):
        for fused in (True, False):
            if pkg == "port":
                eng = _port(tiny, monkeypatch, fused=fused,
                            enable_prefix_caching=True)
            else:
                # the JAX engine as the oracle runs it (its default decode
                # path, not the Pallas kernels in interpret mode)
                _switches(monkeypatch, fused, False, True)
                monkeypatch.delenv("SHAI_PAGED_DECODE")
                eng = JEngine(jcfg, params, jconfig.EngineConfig(
                    **dict(ENGINE_KW, enable_prefix_caching=True)))
            sp = Params(**SAMPLING["greedy"])
            f1 = eng.generate([prompt], sp)            # registers
            f2 = eng.generate([prompt + [5, 6]], sp)   # admits from cache
            assert f2[0].timing["recompute_tokens"] == 42 - 32
            assert eng.cache.n_evictable > 0
            assert eng.cache.leaked_blocks == 0
            outs[pkg, fused] = f1 + f2
    for pkg in ("port", "jax"):
        for a, b in zip(outs[pkg, True], outs[pkg, False]):
            assert a.token_ids == b.token_ids
            if pkg == "port":
                _assert_finished_equal(a, b)
    assert_greedy_parity(outs["port", True], outs["jax", True],
                         label="fused prefix cache")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_fused_int8_plus_prefix_cache_excluded(tiny, monkeypatch, pkg):
    """Int8 + prefix-cache reuse declines the cached path under the fused
    step (the whole-bucket window would re-quantize the cached tail block
    under another scale): plain admission, which still serves."""
    make, Params = (_port, SamplingParams) if pkg == "port" else \
        (_jax, JParams)
    eng = make(tiny, monkeypatch, fused=True, quant=True,
               enable_prefix_caching=True)
    prompt = [7, 3] * 10
    sp = Params(temperature=0.0, max_new_tokens=4)
    eng.generate([prompt], sp)
    assert eng.cache.n_evictable > 0
    [fin] = eng.generate([prompt + [5]], sp)
    assert len(fin.token_ids) == 4
    assert "recompute_tokens" not in fin.timing   # no cached admission
    assert eng.cache.leaked_blocks == 0


def test_fused_requires_ragged(tiny, monkeypatch):
    assert _port(tiny, monkeypatch, fused=True, ragged=False)._fused is False
    assert _jax(tiny, monkeypatch, fused=True, ragged=False)._fused is False
