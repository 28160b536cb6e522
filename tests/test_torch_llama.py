"""The port's Llama model against the flax model, on the CPU.

The flax model is initialised from a seed; :func:`params_from_jax` carries
its weights over, and both forwards score the same token ids. Tolerances:

- compute dtype fp32: ``atol`` 2e-5 on logits of magnitude ~4 (fp32
  matmuls and softmax summed in another order through 2 layers; measured
  ~4e-6);
- compute dtype bf16: ``atol`` 6e-2, two bf16 ulps at |logit| < 8 — both
  round activations to bf16 at the same points, but torch and XLA
  accumulate each bf16 product in another order (measured ~5e-2); the
  greedy argmax must still agree on 90% of positions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama


@pytest.fixture(scope="module", params=["tiny", "hd64"])
def flax_model(request):
    cfg = jllama.LlamaConfig.tiny()
    if request.param == "hd64":
        # head dim 64 (the flash kernel's smallest) with untied logits
        cfg = dataclasses.replace(cfg, dim=128, n_heads=2, n_kv_heads=1,
                                  tie_embeddings=False)
    params = jllama.LlamaForCausalLM(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return cfg, params


def _port_cfg(jcfg):
    return tllama.LlamaConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 6e-2)])
def test_forward_matches_flax(flax_model, dtype, atol):
    jcfg, params = flax_model
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 24))
    want = np.asarray(jllama.LlamaForCausalLM(jcfg, dtype=getattr(
        jnp, dtype)).apply(params, jnp.asarray(ids, jnp.int32))[0])
    model = tllama.LlamaForCausalLM.from_state_dict(
        _port_cfg(jcfg), tllama.params_from_jax(params, _port_cfg(jcfg)),
        dtype=getattr(torch, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= (1.0 if dtype == "float32" else 0.9)


def test_params_from_jax_layout(flax_model):
    jcfg, params = flax_model
    cfg = _port_cfg(jcfg)
    sd = tllama.params_from_jax(params, cfg)
    k = np.asarray(params["params"]["layer_1"]["attn"]["q"]["kernel"])
    np.testing.assert_array_equal(sd["layers.1.attn.q.weight"].numpy(), k.T)
    assert set(sd) == set(tllama.geometry_params(cfg, device="cpu"))
    # bf16 leaves travel as their bit patterns
    bf = {"params": jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                                 params["params"])}
    sd16 = tllama.params_from_jax(bf, cfg)
    assert sd16["embed.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sd16["embed.weight"].float().numpy(),
        np.asarray(bf["params"]["embed"]["embedding"]).astype(np.float32))


def test_config_presets_and_from_hf_match():
    for name in ("tiny", "llama3_8b", "llama32_1b", "llama32_3b",
                 "mistral_7b", "llama3_70b", "mllama_11b_text"):
        assert dataclasses.asdict(getattr(tllama.LlamaConfig, name)()) == \
            dataclasses.asdict(getattr(jllama.LlamaConfig, name)())

    class HF:  # the attributes from_hf reads, as an HF config carries them
        vocab_size, hidden_size, num_hidden_layers = 1000, 64, 2
        num_attention_heads, num_key_value_heads = 4, 2
        intermediate_size, max_position_embeddings = 128, 512
        rope_theta, rms_norm_eps, tie_word_embeddings = 500000.0, 1e-5, True
        rope_scaling = {"rope_type": "llama3", "factor": 8.0,
                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 8192}

    assert dataclasses.asdict(tllama.LlamaConfig.from_hf(HF)) == \
        dataclasses.asdict(jllama.LlamaConfig.from_hf(HF))


def test_geometry_params_shapes_match_reference():
    jcfg = jllama.LlamaConfig.tiny()
    jtree = jllama.geometry_params(jcfg)
    sd = tllama.geometry_params(_port_cfg(jcfg), device="cpu")
    want = tllama.params_from_jax(
        {"params": jax.tree.map(np.asarray, jtree["params"])},
        _port_cfg(jcfg))
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for k, v in sd.items():
        assert torch.equal(v.float(), want[k].float()), k
