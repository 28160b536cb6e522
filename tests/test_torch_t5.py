"""The port's T5 encoder (``models/t5.py``) against the JAX package and
against ``transformers``' ``T5EncoderModel`` on the CPU at tiny sizes.

- ``relative_position_bucket`` equal to the JAX package's, exactly;
- ``T5Encoder`` (gated GELU and ReLU) with a padded key mask: in fp32
  within ``FP32_RRMS`` of the JAX encoder's rms at every position; in bf16
  by the attention rule and within twice the JAX bf16 output's own
  distance from its fp32 forward (``test_torch_diffusion``'s rule);
  ``mean_pool`` equal to the JAX package's within one fp32 rounding;
- a tiny ``T5EncoderModel`` written by ``save_pretrained`` (safetensors)
  and read through the port's reader and ``state_from_hf``: tensor for
  tensor the port state of the JAX package's ``params_from_torch``, the
  embedding from ``shared.weight`` or from ``encoder.embed_tokens.weight``
  alone; its last hidden state within ``HF_ATOL`` of HF's at the real
  tokens (HF's padded query rows are not the reference's, as the JAX
  package's own test notes); ``T5Config.from_hf`` of the ``config.json``
  equal to the JAX package's of the HF config;
- the attention never reaches ``dot_product_attention`` (B1's dispatch).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models import t5 as jt5
from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
    Checkpoint,
)
from scalable_hw_agnostic_inference_tpu_torch.models import t5 as pt5

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_diffusion import _check_bf16, _jax_params  # noqa: E402
from test_torch_unigram import transformers_names  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

#: fp32: max |port - JAX| over rms(JAX)
FP32_RRMS = 1e-4
#: against HF's fp32 encoder at the real tokens (the JAX package's own
#: test holds its encoder to HF at 2e-4)
HF_ATOL = 2e-4


def _ids_mask(vocab, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[1, 8:] = 0
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 16), (16, 20)])
def test_relative_position_bucket_equals_the_jax_package(buckets, distance):
    rel = np.arange(-600, 601)[None, :] + np.zeros((1, 1), np.int64)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel),
                                                   buckets, distance))
    got = pt5.relative_position_bucket(torch.from_numpy(rel), buckets,
                                       distance).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=[True, False], ids=["gated", "relu"])
def t5_pair(request):
    import dataclasses

    jcfg = dataclasses.replace(jt5.T5Config.tiny(), gated=request.param)
    params = _jax_params(jt5.T5Encoder(jcfg).init, 9,
                         jnp.zeros((1, 8), jnp.int32),
                         jnp.ones((1, 8), jnp.int32))
    pcfg = pt5.T5Config(**dataclasses.asdict(jcfg))
    return jcfg, pcfg, params, jax.jit(jt5.T5Encoder(jcfg).apply)


def test_encoder_fp32_and_mean_pool_equal_the_jax_package(t5_pair):
    jcfg, pcfg, params, apply32 = t5_pair
    ids, mask = _ids_mask(jcfg.vocab_size)
    want = np.asarray(apply32(params, ids, mask))
    m = pt5.build(pcfg, pt5.params_from_jax(params))
    with torch.inference_mode():
        got = m(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    rms = np.sqrt((want ** 2).mean())
    assert np.abs(got.numpy() - want).max() <= FP32_RRMS * rms
    pooled = pt5.mean_pool(got, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        pooled, np.asarray(jt5.mean_pool(jnp.asarray(got.numpy()),
                                         jnp.asarray(mask))),
        rtol=0, atol=float(np.spacing(np.abs(pooled).max())))


def test_encoder_bf16_within_the_rounding_floor(t5_pair):
    jcfg, pcfg, params, apply32 = t5_pair
    ids, mask = _ids_mask(jcfg.vocab_size)
    want32 = np.asarray(apply32(params, ids, mask))
    want = np.asarray(jax.jit(jt5.T5Encoder(jcfg, dtype=jnp.bfloat16).apply)(
        params, ids, mask))
    m = pt5.T5Encoder(pcfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                      device="cpu")
    m.load_state_dict(pt5.params_from_jax(params))
    with torch.inference_mode():
        got = m(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    _check_bf16(got, want, want32)


def test_attention_is_plain_pytorch(t5_pair, monkeypatch):
    """T5's biased, masked attention is its own plain function, never the
    B1 dispatch."""
    from scalable_hw_agnostic_inference_tpu_torch.ops import attention

    def refuse(*a, **k):
        raise AssertionError("T5 reached dot_product_attention")

    monkeypatch.setattr(attention, "dot_product_attention", refuse)
    _, pcfg, params, _ = t5_pair
    m = pt5.build(pcfg, pt5.params_from_jax(params))
    ids, mask = _ids_mask(pcfg.vocab_size)
    with torch.inference_mode():
        assert torch.isfinite(m(torch.from_numpy(ids),
                                torch.from_numpy(mask))).all()


@pytest.fixture(scope="module", params=["gated-gelu", "relu"])
def hf_dir(request, tmp_path_factory):
    HFConfig, T5EncoderModel = transformers_names("T5Config",
                                                  "T5EncoderModel")
    hf_cfg = HFConfig(
        vocab_size=256, d_model=32, d_kv=8, num_heads=4, d_ff=64,
        num_layers=2, relative_attention_num_buckets=8,
        relative_attention_max_distance=16,
        feed_forward_proj=request.param, dropout_rate=0.0)
    torch.manual_seed(0)
    tm = T5EncoderModel(hf_cfg).eval()
    path = tmp_path_factory.mktemp("t5")
    tm.save_pretrained(path, safe_serialization=True)
    return path, tm, hf_cfg


def test_hf_checkpoint_through_the_reader_equals_the_reference(hf_dir):
    path, tm, hf_cfg = hf_dir

    cfg = pt5.T5Config.from_hf(json.loads((path / "config.json").read_text()))
    jcfg = jt5.T5Config.from_hf(hf_cfg)
    assert cfg.__dict__ == jcfg.__dict__
    ck = Checkpoint(path)
    keys = set(ck.keys())
    got = pt5.state_from_hf(lambda n: ck.tensor(n, "cpu"), keys, cfg)
    want = pt5.params_from_jax(jax.tree.map(
        np.asarray, jt5.params_from_torch(tm, jcfg)))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # the embedding under encoder.embed_tokens alone reads the same
    emb = "shared.weight" if "shared.weight" in keys \
        else "encoder.embed_tokens.weight"
    alone = (keys - {emb}) | {"encoder.embed_tokens.weight"}
    state = pt5.state_from_hf(
        lambda n: ck.tensor(emb if n == "encoder.embed_tokens.weight"
                            else n, "cpu"), alone, cfg)
    torch.testing.assert_close(state["embed"], want["embed"], rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="has no"):
        pt5.state_from_hf(lambda n: ck.tensor(n, "cpu"),
                          keys - {"encoder.final_layer_norm.weight"}, cfg)

    ids, mask = _ids_mask(cfg.vocab_size)
    m = pt5.build(cfg, got)
    with torch.inference_mode():
        out = m(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        ref = tm(input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask)
                 ).last_hidden_state.numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(out[real], ref[real], rtol=0, atol=HF_ATOL)
