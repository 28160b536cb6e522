"""The port's engine runner against the JAX runner, on the CPU.

Both runners read the same weights (a flax init carried over with
``params_from_jax``) and write pools that start equal. The JAX decode goes
through the Pallas paged kernel in interpret mode (``paged=True``), the
port's through the plain version of B2 (a CPU tensor never reaches the CUDA
kernel). Activations are bf16 from the embedding on in both, so the
comparison is at bf16 tolerances:

- pool contents (bf16 k/v after rope, |k| < 5): ``atol`` 5e-2, two bf16
  ulps. The first layer's k/v agree to the bit; from the second layer on a
  fifth of the values differ by one or two ulps, because torch and XLA
  round the bf16 attention output, SiLU and products of the first layer
  differently (measured 3.5e-2);
- logits (fp32, |logit| < 5): ``atol`` 6e-2, those ulps carried through the
  last norm and the unembedding (measured 3.1e-2, as in the scoring
  forward's bf16 test);
- greedy tokens: equal wherever the JAX top-2 gap is decisive (at least
  twice the logit tolerance); below that the argmax is a bf16 tie.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import runner as jrunner
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.engine import runner as trunner
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import PagedKVCache
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama

BS = 16            # block size
BPS = 8            # blocks per sequence: max_model_len 128
N_BLOCKS = 24
LOGIT_ATOL = 6e-2
POOL_ATOL = 5e-2


@pytest.fixture(scope="module", params=["tiny", "hd64"])
def models(request):
    jcfg = jllama.LlamaConfig.tiny()          # head dim 16, tied logits
    if request.param == "hd64":
        jcfg = dataclasses.replace(jcfg, dim=128, n_heads=2, n_kv_heads=1,
                                   tie_embeddings=False)
    params = jllama.LlamaForCausalLM(jcfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(params, tcfg))
    return jcfg, params, tcfg, model


def _pools(cfg):
    jkv = [{"k": jnp.zeros((N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim),
                           jnp.bfloat16),
            "v": jnp.zeros((N_BLOCKS, BS, cfg.n_kv_heads, cfg.head_dim),
                           jnp.bfloat16)} for _ in range(cfg.n_layers)]
    tkv = PagedKVCache(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, N_BLOCKS,
                       BS, BPS, device=torch.device("cpu")).kv
    return jkv, tkv


def _assert_pools_close(jkv, tkv):
    for jl, tl in zip(jkv, tkv):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tl[name].float().numpy(),
                np.asarray(jl[name].astype(jnp.float32)),
                atol=POOL_ATOL, rtol=0)


def _assert_logits_close(got, want):
    """``[B, V]`` logits within the tolerance, and the same argmax on every
    row whose top-2 gap is decisive."""
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] >= 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decisive],
                                  want.argmax(-1)[decisive])


def _prefill_both(jcfg, params, tcfg, model, jkv, tkv, ids, n_text, tables):
    bucket = ids.shape[1]
    jfn = jrunner.make_prefill(jcfg, BS, BPS, bucket, n_seqs=ids.shape[0])
    jkv, jlog = jfn(params, jkv, jnp.asarray(ids), jnp.asarray(n_text),
                    jnp.asarray(tables))
    tfn = trunner.make_prefill(tcfg, BS, BPS, bucket, n_seqs=ids.shape[0])
    with torch.inference_mode():
        tkv, tlog = tfn(model, tkv, torch.from_numpy(ids),
                        torch.from_numpy(n_text), torch.from_numpy(tables))
    return jkv, np.asarray(jlog), tkv, tlog.numpy()


def _tables(rows):
    t = np.zeros((len(rows), BPS), np.int32)
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def test_prefill_logits_and_pool_match_jax(models):
    jcfg, params, tcfg, model = models
    rng = np.random.default_rng(0)
    ids = rng.integers(3, jcfg.vocab_size, (4, 32)).astype(np.int32)
    n_text = np.array([5, 29, 32, 1], np.int32)
    ids[0, 5:] = 0
    ids[1, 29:] = 0
    ids[3, 1:] = 0
    # shuffled, non-contiguous block ids; the last row is a padding row
    # (null table) as the engine's power-of-two prefill batch carries
    tables = _tables([[3, 7], [12, 4], [9, 21], []])
    jkv, tkv = _pools(jcfg)
    jkv, jlog, tkv, tlog = _prefill_both(jcfg, params, tcfg, model, jkv, tkv,
                                         ids, n_text, tables)
    assert tlog.shape == (4, jcfg.vocab_size) and tlog.dtype == np.float32
    _assert_logits_close(tlog[:3], jlog[:3])
    _assert_pools_close(jkv, tkv)


@pytest.mark.parametrize("m_ctx", [BPS, 4])
def test_decode_steps_match_jax(models, m_ctx):
    """Per-step decode logits through the paged path (JAX: the Pallas kernel
    in interpret mode; port: B2's plain version), over a full and a
    truncated context bucket, with a padding row in the batch."""
    jcfg, params, tcfg, model = models
    rng = np.random.default_rng(1)
    ids = rng.integers(3, jcfg.vocab_size, (2, 32)).astype(np.int32)
    n_text = np.array([7, 30], np.int32)
    ids[0, 7:] = 0
    ids[1, 30:] = 0
    tables = _tables([[5, 2], [17, 11]])
    jkv, tkv = _pools(jcfg)
    jkv, jlog, tkv, _ = _prefill_both(jcfg, params, tcfg, model, jkv, tkv,
                                      ids, n_text, tables)
    # row 1 crosses into a third block during decode
    dec_tables = _tables([[5, 2], [17, 11, 8], []])
    B = 3
    jfwd = jrunner._make_token_forward(jcfg, BS, m_ctx, B, 1, None,
                                       paged=True)
    tfwd = trunner._make_token_forward(tcfg, BS, m_ctx, B, 1)
    tok = np.zeros((B,), np.int32)
    tok[:2] = jlog.argmax(-1)
    pos = np.array([7, 30, 0], np.int32)
    for _ in range(4):
        jkv, jl = jfwd(params, jkv, jnp.asarray(tok)[:, None],
                       jnp.asarray(pos)[:, None], jnp.asarray(dec_tables))
        with torch.inference_mode():
            tkv, tl = tfwd(model, tkv, torch.from_numpy(tok)[:, None],
                           torch.from_numpy(pos)[:, None],
                           torch.from_numpy(dec_tables))
        jl, tl = np.asarray(jl)[:2, 0], tl.numpy()[:2, 0]
        _assert_logits_close(tl, jl)
        # both sides continue from the same tokens
        tok[:2] = jl.argmax(-1)
        pos[:2] += 1
    _assert_pools_close(jkv, tkv)


def test_make_decode_greedy_matches_jax(models):
    """One full decode step (forward + sampling) at temperature 0 gives the
    JAX decode executable's tokens."""
    jcfg, params, tcfg, model = models
    rng = np.random.default_rng(2)
    ids = rng.integers(3, jcfg.vocab_size, (2, 16)).astype(np.int32)
    n_text = np.array([16, 9], np.int32)
    ids[1, 9:] = 0
    tables = _tables([[6], [14]])
    jkv, tkv = _pools(jcfg)
    jkv, jlog, tkv, _ = _prefill_both(jcfg, params, tcfg, model, jkv, tkv,
                                      ids, n_text, tables)
    tables = _tables([[6, 3], [14]])
    tok = jlog.argmax(-1).astype(np.int32)
    pos = n_text.copy()
    zeros_f = np.zeros((2,), np.float32)
    zeros_i = np.zeros((2,), np.int32)
    ones_f = np.ones((2,), np.float32)
    jdec = jrunner.make_decode(jcfg, BS, BPS, 2, paged=True)
    _, jnxt, _, top_lp, _ = jdec(params, jkv, jnp.asarray(tok), jnp.asarray(pos),
                       jnp.asarray(tables), jnp.ones((2,), bool),
                       jax.random.PRNGKey(0), jnp.asarray(zeros_f),
                       jnp.asarray(zeros_i), jnp.asarray(ones_f))
    tdec = trunner.make_decode(tcfg, BS, BPS, 2)
    with torch.inference_mode():
        _, tnxt = tdec(model, tkv, torch.from_numpy(tok),
                       torch.from_numpy(pos), torch.from_numpy(tables),
                       torch.Generator().manual_seed(0),
                       torch.from_numpy(zeros_f), torch.from_numpy(zeros_i),
                       torch.from_numpy(ones_f))
    top_lp = np.asarray(top_lp)
    decisive = top_lp[:, 0] - top_lp[:, 1] >= 2 * LOGIT_ATOL
    np.testing.assert_array_equal(tnxt.numpy()[decisive],
                                  np.asarray(jnxt)[decisive])


def test_make_prefill_rejects_misaligned_bucket(models):
    _, _, tcfg, _ = models
    with pytest.raises(ValueError, match="multiple of block_size"):
        trunner.make_prefill(tcfg, BS, BPS, 24)
    with pytest.raises(ValueError, match="ctx_blocks"):
        trunner.make_decode(tcfg, BS, BPS, 2, ctx_blocks=BPS + 1)
