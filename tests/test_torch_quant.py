"""The port's int8 weight-only projections against the JAX package's, on
the CPU.

Inputs come from a numpy seed and go through both packages. What is held,
each with its tolerance:

- ``quantize_weight`` equals the JAX quantizer bit for bit (int8 codes and
  f32 scales; the port's weights are ``[out, in]``, the JAX kernels
  ``[in, out]``);
- ``quant_matmul``'s int8 route within 2 bf16 ulps of the JAX one, the ulp
  taken at ``max(|ref|, K 2^-24 sum|x w s|)``: below that magnitude the
  fp32 sums of two summation orders may differ by more than an ulp (the
  worst-case fp32 error of a K-term sum is ``K 2^-24 sum|terms|``). A
  plain version short of one 16-wide K slice fails the same check;
- ``quantize_state_dict`` converts exactly the weights whose JAX paths
  ``quantized_kernel_paths`` names, tied and untied;
- ``geometry_params(quant=True)`` has the JAX tier's dtypes and shapes;
- ``params_from_jax`` carries a quantized tree across bit for bit;
- the tiny int8 engine meets the JAX int8 engine's greedy tokens
  (``tests/parity.py::assert_greedy_parity``: equal, or parting only at a
  top-2 gap under 3e-2), async and lock-step;
- the W8A16 wrapper takes its plain version for CPU tensors (and launches
  nothing), refuses other devices, and ``quant_matmul`` sends calls of at
  most 64 rows to it and wider ones to the counted wide route;
- the engine refuses weights that do not match its ``quantization``.
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
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.ops import quant as jquant
from scalable_hw_agnostic_inference_tpu_torch.engine import config as tconfig
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.ops import quant as tquant
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
    int8_matmul as ti8,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 and back (the engine's activations)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("shape,bf16", [((48, 64), False), ((128, 256), True),
                                        ((8, 16), False)])
def test_quantize_weight_bit_exact(shape, bf16):
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[3] = 0.0                      # an all-zero row: the 1e-8 floor
    w[5, 7] = 0.5 * w[5].max()      # values on the half-step
    if bf16:
        w = _bf16(w)
    jq, js = jquant.quantize_weight(jnp.asarray(w.T))
    tq, ts = tquant.quantize_weight(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tquant.dequantize_weight(tq, ts).numpy(),
        np.asarray(jquant.dequantize_weight(jq, js)).T)


def _ulp(a: torch.Tensor) -> torch.Tensor:
    """bf16 spacing at |a| (f32 in, f32 out; subnormals not needed)."""
    _, e = torch.frexp(a.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(a), e - 8)


def _ulps_off(got, want, x, wq, scale) -> float:
    """The largest |got - want| in bf16 ulps at max(|want|, K 2^-24
    sum|x w s|)."""
    K = x.shape[-1]
    mag = (x.abs() @ wq.float().abs().T) * scale.abs()
    floor = mag * K * 2.0 ** -24
    return float(((got.float() - want.float()).abs()
                  / _ulp(torch.maximum(want.float().abs(), floor))).max())


@pytest.mark.parametrize("M", [1, 7, 64, 65])
def test_quant_matmul_int8_route_matches_jax(M):
    rng = np.random.default_rng(M)
    K, N = 256, 96
    w = rng.standard_normal((N, K)).astype(np.float32) * 0.05
    x = _bf16(rng.standard_normal((M, K)).astype(np.float32))
    jq, js = jquant.quantize_weight(jnp.asarray(w.T))
    want = np.asarray(jquant.quant_matmul(
        jnp.asarray(x, jnp.bfloat16), {"kernel_q": jq, "scale": js}
    ).astype(jnp.float32))
    proj = tllama.QuantLinear(K, N, device="cpu")
    q, s = tquant.quantize_weight(_t(w))
    proj.weight_q.data, proj.scale.data = q, s
    got = tquant.quant_matmul(_t(x).to(torch.bfloat16), proj)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    xf = _t(x)
    assert _ulps_off(got, _t(want), xf, q, s) <= 2.0
    # the check sees a plain version short of one 16-wide K slice
    cut = tquant.int8_matmul_reference(
        _t(x).to(torch.bfloat16)[:, 16:], q[:, 16:], s)
    assert _ulps_off(cut, _t(want), xf, q, s) > 2.0


def _jax_tree(cfg):
    return jllama.LlamaForCausalLM(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))


def _port_name(path: str) -> str:
    """``params/layer_0/attn/q/kernel`` -> ``layers.0.attn.q.weight``."""
    parts = path.split("/")[1:-1]
    if parts[0].startswith("layer_"):
        parts = ["layers", parts[0][len("layer_"):]] + parts[1:]
    return ".".join(parts) + ".weight"


@pytest.mark.parametrize("tie", [True, False])
def test_quantize_state_dict_names_match_jax_paths(tie):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), tie_embeddings=tie)
    tree = _jax_tree(jcfg)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    sd = tllama.params_from_jax(jax.tree.map(np.asarray, tree), tcfg)
    want = {_port_name(p) for p in jquant.quantized_kernel_paths(tree)}
    assert tquant.quantized_weight_names(sd) == want
    assert ("lm_head.weight" in want) == (not tie)
    qsd = tquant.quantize_state_dict(sd)
    converted = {k[: -len("_q")] for k in qsd if k.endswith(".weight_q")}
    assert converted == want
    assert {k for k in qsd if not k.endswith((".weight_q", ".scale"))
            or k.endswith("norm.scale")} == set(sd) - want
    for name in want:
        stem = name[: -len(".weight")]
        assert qsd[f"{stem}.weight_q"].dtype == torch.int8
        assert qsd[f"{stem}.scale"].dtype == torch.float32
    # the embedding and the norms pass through untouched
    assert qsd["embed.weight"] is sd["embed.weight"]


def test_geometry_params_quant_matches_jax_tier():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(),
                               tie_embeddings=False)
    jtree = jllama.geometry_params(jcfg, quant=True)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    want = tllama.params_from_jax(jax.tree.map(np.asarray, jtree), tcfg)
    got = tllama.geometry_params(tcfg, dtype=torch.bfloat16, device="cpu",
                                 quant=True)
    assert set(got) == set(want)
    for name, t in got.items():
        assert (t.dtype, tuple(t.shape)) == (want[name].dtype,
                                             tuple(want[name].shape)), name
        assert torch.equal(t, want[name]), name
    assert sum(k.endswith(".weight_q") for k in got) == 7 * tcfg.n_layers + 1
    model = tllama.LlamaForCausalLM.from_state_dict(tcfg, got)
    assert model.quantized
    assert isinstance(model.lm_head, tllama.QuantLinear)
    assert all(not p.requires_grad for p in model.lm_head.parameters())


def test_params_from_jax_carries_quantized_tree():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(),
                               tie_embeddings=False)
    tree = _jax_tree(jcfg)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    qtree = jax.tree.map(np.asarray, jquant.quantize_params_tree(tree))
    got = tllama.params_from_jax(qtree, tcfg)
    want = tquant.quantize_state_dict(
        tllama.params_from_jax(jax.tree.map(np.asarray, tree), tcfg))
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=16,
                 context_encoding_buckets=(16, 32, 64),
                 token_generation_buckets=(32, 64), max_new_tokens=12,
                 quantization="int8")


@pytest.fixture(scope="module")
def int8_pair():
    jcfg = jllama.LlamaConfig.tiny()
    qtree = jquant.quantize_params_tree(_jax_tree(jcfg))
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(jax.tree.map(np.asarray, qtree), tcfg))
    return jcfg, qtree, tcfg, model


@pytest.fixture(scope="module")
def jax_int8_tokens(int8_pair):
    jcfg, qtree, _, _ = int8_pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, n).tolist() for n in (5, 12, 40, 70)]
    mp = pytest.MonkeyPatch()
    mp.setenv("SHAI_PAGED_DECODE", "1")
    mp.setenv("SHAI_ASYNC_DECODE", "0")
    try:
        jeng = JEngine(jcfg, qtree, jconfig.EngineConfig(**ENGINE_KW))
        want = jeng.generate(prompts, JParams(temperature=0.0, logprobs=2,
                                              max_new_tokens=12))
    finally:
        mp.undo()
    return prompts, want


@pytest.mark.parametrize("async_on", [True, False])
def test_int8_engine_matches_jax_int8_engine(int8_pair, jax_int8_tokens,
                                             monkeypatch, async_on):
    """Mixed prompt lengths (one chunks past the 64 bucket, so prefill,
    continuation and decode all run int8) through both engines."""
    _, _, tcfg, model = int8_pair
    prompts, want = jax_int8_tokens
    monkeypatch.setenv("SHAI_ASYNC_DECODE", "1" if async_on else "0")
    eng = LLMEngine(tcfg, model, tconfig.EngineConfig(**ENGINE_KW),
                    device="cpu")
    assert eng._async == async_on
    got = eng.generate(prompts, SamplingParams(temperature=0.0,
                                               max_new_tokens=12))
    assert [len(f.token_ids) for f in got] == [12] * 4
    assert_greedy_parity(got, want, label=f"int8 async={async_on}")
    assert eng.cache.leaked_blocks == 0


def test_engine_refuses_mismatched_weights(int8_pair):
    _, _, tcfg, model = int8_pair
    with pytest.raises(ValueError, match="quantize them at boot"):
        LLMEngine(tcfg, model, tconfig.EngineConfig(
            **dict(ENGINE_KW, quantization=None)), device="cpu")
    bf16 = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.random_params(tcfg, 0, device="cpu"))
    with pytest.raises(ValueError, match="not quantized"):
        LLMEngine(tcfg, bf16, tconfig.EngineConfig(**ENGINE_KW),
                  device="cpu")


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((5, 128))).to(torch.bfloat16)
    q, s = tquant.quantize_weight(_t(rng.standard_normal((24, 128))))
    ti8.int8_matmul.launches = 0
    got = ti8.int8_matmul(x, q, s)
    assert torch.equal(got, ti8.int8_matmul_reference(x, q, s))
    assert ti8.int8_matmul.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        ti8.int8_matmul(x.to("meta"), q.to("meta"), s.to("meta"))


def test_route_split_at_64_rows(monkeypatch):
    """Calls of at most ``KERNEL_MAX_ROWS`` rows (leading dims flattened)
    reach the kernel's wrapper; wider ones take the wide route."""
    assert tquant.KERNEL_MAX_ROWS == 64
    calls = []

    def spy(x, wq, scale):
        calls.append(tuple(x.shape))
        return ti8.int8_matmul_reference(x, wq, scale)

    monkeypatch.setattr(tquant, "int8_matmul", spy)
    proj = tllama.QuantLinear(64, 16, device="cpu")
    proj.weight_q.data.random_(-127, 128)
    tquant.quant_matmul_wide.launches = 0
    for shape in [(64, 1, 64), (8, 8, 64), (1, 64)]:
        y = tquant.quant_matmul(torch.ones(shape, dtype=torch.bfloat16), proj)
        assert y.shape == shape[:-1] + (16,)
    assert calls == [(64, 64), (64, 64), (1, 64)]
    assert tquant.quant_matmul_wide.launches == 0
    for shape in [(65, 64), (1, 512, 64)]:
        tquant.quant_matmul(torch.ones(shape, dtype=torch.bfloat16), proj)
    assert len(calls) == 3 and tquant.quant_matmul_wide.launches == 2
    # an nn.Linear projection takes neither route
    lin = torch.nn.Linear(64, 16, bias=False)
    tquant.quant_matmul(torch.ones((4, 64), dtype=torch.bfloat16), lin)
    assert len(calls) == 3 and tquant.quant_matmul_wide.launches == 2


def test_int8_plan_fills_the_card():
    """The CTA width at the Llama-3-8B decode shapes on 132 SMs: k/v
    (N=1024) 128 CTAs of 8 rows, q/o/down (4096) 256 of 16 (one wave of
    two per SM), gate/up (14336) and lm_head 64-row CTAs; Llama-3.2-1B's
    q/o (2048) 256 of 8 and gate/up (8192) 256 of 32."""
    assert ti8.int8_plan(1024, 132) == 8
    assert ti8.int8_plan(4096, 132) == 16
    assert ti8.int8_plan(2048, 132) == 8
    assert ti8.int8_plan(8192, 132) == 32
    assert ti8.int8_plan(14336, 132) == 64
    assert ti8.int8_plan(128256, 132) == 64
    assert ti8.int8_plan(8, 132) == 8
