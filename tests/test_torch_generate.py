"""The port's dense-cache generate (``models/generate.py``
``make_generate``, ``models/llama.py`` ``DenseCache``) against the JAX
package's ``make_generate`` on ``LlamaConfig.tiny``, on the CPU.

The JAX model's tree is ``jax.eval_shape`` of its ``init`` filled with
numpy draws, carried into the port by ``llama.params_from_jax`` (int8: the
JAX ``quantize_params_tree`` carried across). Three prompts of 1, 17 and
32 tokens share one 32-token bucket (the last fills it: no padding).

- greedy tokens and ``n_generated`` equal to the JAX generate's, with the
  model in fp32 (the tiny unit's), bf16, bf16 over a bf16 cache, and
  int8 (every projection through B4's plain version), run once without
  an EOS and once with an EOS that a row emits mid-run (so rows stop at
  different steps and the loop's early exit is reached). In fp32 every
  row is equal; in bf16 and int8 a row's stream may part from the JAX
  one only at a tie: the JAX model's own top-2 logits at the parting
  step within ``NOISE_TIES`` times the two packages' measured logit
  difference there, and the port's token one of those two (the rule the
  chip smoke's engine phases hold to);
- the port's layout (decode step ``t`` at slot ``prompt_len + t``) against
  the reference's (slot ``Tp + t``, padding slots masked): teacher-forced
  logits of the prefill and every decode step within ``FP32_RRMS`` in
  fp32;
- sampled runs deterministic in the seed (the port draws with a torch
  generator, not JAX's folded keys: sampled text is not the JAX pod's).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models import generate as jgen
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.ops import quant as jquant
from scalable_hw_agnostic_inference_tpu_torch.models import generate as pgen
from scalable_hw_agnostic_inference_tpu_torch.models import llama as pllama

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_diffusion import _jax_params, _rel_max  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

#: fp32 logits, port layout against the reference's
FP32_RRMS = 1e-5
#: a bf16 or int8 stream may part from the JAX one where the JAX top-2
#: gap is within this many times the two packages' measured logit
#: difference on that sequence
NOISE_TIES = 2.0
BUCKET, NEW = 32, 12
LENS = np.array([1, 17, 32], np.int32)
JCFG = jllama.LlamaConfig.tiny()
PCFG = pllama.LlamaConfig(**dataclasses.asdict(JCFG))
#: model dtype, cache dtype, int8 weights
CASES = {"fp32": (jnp.float32, torch.float32, False),
         "bf16": (jnp.bfloat16, torch.float32, False),
         "bf16_cache": (jnp.bfloat16, torch.bfloat16, False),
         "int8": (jnp.bfloat16, torch.float32, True)}


@pytest.fixture(scope="module")
def tree():
    model = jllama.LlamaForCausalLM(JCFG, dtype=jnp.float32)
    return _jax_params(model.init, 61, jnp.zeros((1, 8), jnp.int32))


def _prompts():
    rng = np.random.default_rng(8)
    ids = np.zeros((len(LENS), BUCKET), np.int32)
    for b, n in enumerate(LENS):
        ids[b, :n] = rng.integers(3, JCFG.vocab_size, n)
    return ids


@pytest.fixture(scope="module")
def qtree(tree):
    """The JAX int8 tree (``quantize_params_tree``, jitted: one compile
    in place of some seconds of eager dispatch), made once."""
    return jax.jit(jquant.quantize_params_tree)(tree)


def _params(tree, qtree, case):
    return qtree if CASES[case][2] else tree


def _port_model(params, case):
    sd = pllama.params_from_jax(jax.tree.map(np.asarray, params), PCFG)
    dt = torch.float32 if CASES[case][0] == jnp.float32 else torch.bfloat16
    return pllama.LlamaForCausalLM.from_state_dict(PCFG, sd, dtype=dt)


def _jax_generate(params, case, eos):
    jdt, cdt, quant = CASES[case]
    model = jllama.LlamaForCausalLM(JCFG, dtype=jdt, quant=quant)
    fn = jgen.make_generate(
        model, JCFG, prompt_bucket=BUCKET, max_new_tokens=NEW, eos_id=eos,
        pad_id=0, cache_dtype=jnp.float32 if cdt == torch.float32
        else jnp.bfloat16)
    out = fn(params, jnp.asarray(_prompts()), jnp.asarray(LENS),
             jax.random.PRNGKey(0), 0.0, 0, 1.0)
    return np.asarray(out.tokens), np.asarray(out.n_generated)


def _port_generate(model, case, eos, seed=0, temperature=0.0):
    fn = pgen.make_generate(model, PCFG, prompt_bucket=BUCKET,
                            max_new_tokens=NEW, eos_id=eos, pad_id=0,
                            cache_dtype=CASES[case][1])
    out = fn(_prompts(), LENS, seed=seed, temperature=temperature)
    return out.tokens.numpy(), out.n_generated.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_equal_the_jax_generate(tree, qtree, case):
    params = _params(tree, qtree, case)
    model = _port_model(params, case)
    free, n_free = _port_generate(model, case, eos=-1)
    assert (n_free == NEW).all()
    # an EOS a row first emits mid-run: it (and any row emitting that
    # token earlier) stops there, the others run on
    row, first = next((b, t) for b in range(len(LENS))
                      for t in range(2, NEW) if free[b, t] not in free[b, :t])
    eos = int(free[row, first])
    got, n_got = _port_generate(model, case, eos)
    want, n_want = _jax_generate(params, case, eos)
    equal = _streams_equal(params, model, case, got, want)
    if case == "fp32":
        assert all(equal)
    np.testing.assert_array_equal(n_got[equal], n_want[equal])
    assert n_got[row] == first + 1 and got[row, first] == eos
    assert n_got.min() < NEW
    for b, n in enumerate(n_got):
        np.testing.assert_array_equal(got[b, :n], free[b, :n])
        assert n == NEW or (got[b, n - 1] == eos and not got[b, n:].any())


@functools.lru_cache(maxsize=None)
def _jax_apply(jdt, quant):
    """The JAX model's jitted ``apply`` for one dtype and weight format,
    shared by the cases that score with it (one compile, not one a
    case)."""
    return jax.jit(jllama.LlamaForCausalLM(JCFG, dtype=jdt,
                                           quant=quant).apply)


def _streams_equal(params, pm, case, got, want):
    """Per row: the streams are equal, or they part at a tie, which this
    asserts: at the parting step the JAX model's top-2 logits (its
    scoring forward over the prompt and the JAX stream before that step)
    lie within ``NOISE_TIES`` times the largest logit difference between
    the two packages' scoring forwards of that same sequence: the
    rounding of two bf16 implementations, measured, not assumed. The
    parted rows are scored as one batch, each sequence right-padded to
    ``BUCKET + NEW`` (causal: the padding changes no earlier logit)."""
    jdt, _, quant = CASES[case]
    ids = _prompts()
    parted = {b: int(np.flatnonzero(got[b] != want[b])[0])
              for b in range(len(LENS)) if (got[b] != want[b]).any()}
    if parted:
        seqs = np.zeros((len(parted), BUCKET + NEW), np.int32)
        ends = []
        for r, (b, i) in enumerate(parted.items()):
            seq = np.concatenate([ids[b, :LENS[b]], want[b, :i]])
            seqs[r, :len(seq)] = seq
            ends.append(len(seq) - 1)
        rows = np.arange(len(parted))
        jl = np.asarray(_jax_apply(jdt, quant)(params,
                                               jnp.asarray(seqs))[0])
        jl = jl[rows, ends]
        with torch.inference_mode():
            pl = pm(torch.from_numpy(seqs).long()).numpy()[rows, ends]
        for r, (b, i) in enumerate(parted.items()):
            noise = float(np.abs(pl[r] - jl[r]).max())
            top = np.sort(jl[r])
            gap = float(top[-1] - top[-2])
            assert gap <= NOISE_TIES * noise, (case, b, i, gap, noise)
            assert got[b, i] in np.argsort(jl[r])[-2:], (case, b, i)
    return np.array([b not in parted for b in range(len(LENS))])


def test_dense_layout_logits_equal_the_reference_layout(tree):
    """Teacher-forced: the same tokens through the reference's layout
    (``init_cache``, ``prefill_mask``, ``decode_mask``, writes at ``Tp +
    t``) and the port's (writes at ``prompt_len + t``, lengths)."""
    apply = jax.jit(jllama.LlamaForCausalLM(JCFG, dtype=jnp.float32).apply)
    pm = _port_model(tree, "fp32")
    ids = _prompts()
    B = len(LENS)
    steps = np.random.default_rng(9).integers(3, JCFG.vocab_size, (NEW, B))
    n_slots = BUCKET + NEW
    pos = np.broadcast_to(np.arange(BUCKET, dtype=np.int32), (B, BUCKET))
    valid = pos < LENS[:, None]
    cache = jllama.init_cache(JCFG, B, n_slots, dtype=jnp.float32)
    logits, cache = apply(tree, jnp.asarray(ids), jnp.asarray(pos), cache,
                          jllama.prefill_mask(jnp.asarray(valid), n_slots),
                          jnp.int32(0))
    want = [np.asarray(logits)[np.arange(B), LENS - 1]]
    slot_valid = np.zeros((B, n_slots), bool)
    slot_valid[:, :BUCKET] = valid
    for t in range(NEW):
        slot_valid[:, BUCKET + t] = True
        logits, cache = apply(
            tree, jnp.asarray(steps[t][:, None]),
            jnp.asarray((LENS + t)[:, None]), cache,
            jllama.decode_mask(jnp.asarray(slot_valid)),
            jnp.int32(BUCKET + t))
        want.append(np.asarray(logits)[:, -1])

    pc = pllama.init_cache(PCFG, B, n_slots, dtype=torch.float32,
                           device="cpu")
    plen = torch.from_numpy(LENS).long()
    with torch.inference_mode():
        lg = pm(torch.from_numpy(ids).long(),
                torch.arange(BUCKET).expand(B, BUCKET), cache=pc,
                lengths=plen)
        got = [lg[torch.arange(B), plen - 1]]
        for t in range(NEW):
            p = plen + t
            lg = pm(torch.from_numpy(steps[t][:, None]).long(), p[:, None],
                    cache=pc, write_pos=p)
            got.append(lg[:, -1])
    assert pc.n_slots % pllama.DENSE_BLOCK == 0
    assert tuple(pc.tables.shape) == (B, pc.n_slots // pllama.DENSE_BLOCK)
    for g, w in zip(got, want):
        assert _rel_max(g, w) < FP32_RRMS


def test_sampled_runs_are_deterministic_in_the_seed(tree):
    model = _port_model(tree, "fp32")
    a = _port_generate(model, "fp32", eos=-1, seed=5, temperature=1.0)
    b = _port_generate(model, "fp32", eos=-1, seed=5, temperature=1.0)
    c = _port_generate(model, "fp32", eos=-1, seed=6, temperature=1.0)
    np.testing.assert_array_equal(a[0], b[0])
    assert (a[0] != c[0]).any()
    greedy = _port_generate(model, "fp32", eos=-1)
    assert (a[0] != greedy[0]).any()


def test_dense_cache_is_refused_for_mllama_configs():
    cfg = dataclasses.replace(PCFG, cross_attention_layers=(1,))
    model = pllama.LlamaForCausalLM.from_state_dict(
        cfg, pllama.random_params(cfg, 0, device="cpu"))
    cache = pllama.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="paged engine"):
        model(torch.zeros((1, 4), dtype=torch.long), cache=cache,
              lengths=torch.tensor([4]))
