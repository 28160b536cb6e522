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
  nothing), refuses other devices; ``quant_matmul`` sends every int8 call
  to it, and on a CUDA tensor (stand-ins of the tensors and the library)
  it launches the decode instantiation up to 64 rows and the wide one past
  them, with the plan's CTAs and scratch;
- the plan (``int8_plan``) at Llama-3-8B's and Llama-3.2-1B's shapes on
  132 SMs: every (tile, k tile) element in exactly one CTA's run, each
  SM's load within one element of every other's, each split tile's pieces
  added in ascending k from slots no other piece uses, the same plan from
  the shape alone;
- the engine refuses weights that do not match its ``quantization``.
"""

import dataclasses
import sys
import types
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
from torch_threads import one_torch_thread  # noqa: E402,F401


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


@pytest.mark.parametrize("M", [1, 7, 64, 65, 200, 512])
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


class _OnCuda:
    """A stand-in of a contiguous, aligned CUDA tensor: what the W8A16
    wrapper reads before it launches (shape, dtype, device, layout,
    pointer) and the outputs it allocates."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype
        self.device = torch.device("cuda", 0)

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 1 << 20

    def new_empty(self, shape, dtype=None):
        return _OnCuda(shape, dtype or self.dtype)


@pytest.mark.parametrize("M", [1, 64, 65, 512])
def test_int8_calls_reach_the_wrapper(monkeypatch, M):
    """Every int8 call reaches the W8A16 wrapper, leading dims flattened
    into rows; on a CUDA tensor the wrapper launches the decode
    instantiation up to 64 rows and the wide one past them, with the
    plan's CTA count and split scratch."""
    calls = []

    def spy(x, wq, scale):
        calls.append(tuple(x.shape))
        return ti8.int8_matmul_reference(x, wq, scale)

    monkeypatch.setattr(tquant, "int8_matmul", spy)
    proj = tllama.QuantLinear(64, 16, device="cpu")
    proj.weight_q.data.random_(-127, 128)
    for shape in [(M, 64), (1, M, 64)]:
        y = tquant.quant_matmul(torch.ones(shape, dtype=torch.bfloat16), proj)
        assert y.shape == shape[:-1] + (16,)
    assert calls == [(M, 64), (M, 64)]
    # an nn.Linear projection does not take it
    lin = torch.nn.Linear(64, 16, bias=False)
    tquant.quant_matmul(torch.ones((M, 64), dtype=torch.bfloat16), lin)
    assert len(calls) == 2

    # the wrapper's CUDA route, with the library replaced by a recorder
    launched = []

    class _Lib:
        def shai_int8_matmul(self, *args):
            launched.append(args)
            return 0

    N, K = 4096, 4096
    monkeypatch.setattr(ti8, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0x5A5A))
    monkeypatch.setattr(ti8, "_arrival_counters",
                        lambda *a: _OnCuda((264,), torch.int32))
    monkeypatch.setattr(ti8._build, "library", lambda: _Lib())
    monkeypatch.setattr(ti8.int8_matmul, "launches", 0)
    monkeypatch.setattr(ti8.int8_matmul, "wide_launches", 0)
    y = ti8.int8_matmul(_OnCuda((M, K), torch.bfloat16),
                        _OnCuda((N, K), torch.int8),
                        _OnCuda((N,), torch.float32))
    assert (y.shape, y.dtype) == ((M, N), torch.bfloat16)
    plan = ti8.int8_plan(M, N, K, 132)
    assert plan.wide == (M > 64)
    assert plan.rows == ({1: 8, 64: 64}.get(M, 128))
    assert (ti8.int8_matmul.launches, ti8.int8_matmul.wide_launches) == \
        ((0, 1) if M > 64 else (1, 0))
    (args,) = launched
    assert args[6:10] == (M, N, K, plan.ctas)
    assert (args[4] is not None) == plan.splits
    # refusals come before any launch
    with pytest.raises(TypeError, match="bfloat16"):
        ti8.int8_matmul(_OnCuda((M, K), torch.float32),
                        _OnCuda((N, K), torch.int8),
                        _OnCuda((N,), torch.float32))
    with pytest.raises(ValueError, match="K % 16"):
        ti8.int8_matmul(_OnCuda((M, 100), torch.bfloat16),
                        _OnCuda((N, 100), torch.int8),
                        _OnCuda((N,), torch.float32))
    assert len(launched) == 1


#: (N, K) of every int8 projection: Llama-3-8B's q/o, k/v, gate/up, down
#: and lm_head; Llama-3.2-1B's q/o, k/v, gate/up and down (its lm_head is
#: the tied embedding, which stays bf16)
PLAN_SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
               (128256, 4096), (2048, 2048), (512, 2048), (8192, 2048),
               (2048, 8192)]


@pytest.mark.parametrize("M", [8, 512])
@pytest.mark.parametrize("N,K", PLAN_SHAPES)
def test_int8_plan_covers_balances_and_orders(N, K, M):
    plan = ti8.int8_plan(M, N, K, 132)
    assert plan.rows == (8 if M == 8 else 128) and plan.wide == (M > 64)
    # two 64-row tiles a warpgroup only where that leaves a tile per SM
    assert plan.row_tiles == (2 if M > 64 and -(-N // 256) * 4 >= 132
                              else 1)
    assert plan.tile_n == 128 * plan.row_tiles
    assert plan.n_tiles == -(-N // plan.tile_n)
    assert plan.k_tiles == -(-K // 128)
    # a CTA per SM, or (wide) whole waves from 106 to 132 CTAs
    assert plan.ctas == min(132, plan.elements) or (
        plan.wide and 106 <= plan.ctas <= 132
        and plan.tiles % plan.ctas == 0)
    # every (m tile, n tile, k tile) element in exactly one CTA's run
    seen = np.zeros((plan.m_tiles, plan.n_tiles, plan.k_tiles), np.int32)
    loads = []
    for c in range(plan.ctas):
        units = plan.units(c)
        loads.append(sum(k1 - k0 for _, _, k0, k1 in units))
        for mt, nt, k0, k1 in units:
            seen[mt, nt, k0:k1] += 1
        # whole tiles round-robin first; then only the first unit of the
        # CTA's run may start inside a tile, only its last end inside one
        whole = units[:plan.full_waves]
        assert [(nt * plan.m_tiles + mt, k0, k1) for mt, nt, k0, k1 in whole] \
            == [(u * plan.ctas + c, 0, plan.k_tiles)
                for u in range(plan.full_waves)]
        run = units[plan.full_waves:]
        assert all(k0 == 0 for _, _, k0, _ in run[1:])
        assert all(k1 == plan.k_tiles for *_, k1 in run[:-1])
    assert (seen == 1).all()
    assert max(loads) - min(loads) <= 1
    # each split tile's pieces: ascending k ranges that tile it, from
    # slots no other piece uses; an unsplit tile has one piece
    slots = []
    for mt in range(plan.m_tiles):
        for nt in range(plan.n_tiles):
            pieces = plan.pieces(mt, nt)
            ranges = [(k0, k1) for c, _ in pieces
                      for t_mt, t_nt, k0, k1 in plan.units(c)
                      if (t_mt, t_nt) == (mt, nt)]
            assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_tiles
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            if len(pieces) > 1:
                slots += [sl for _, sl in pieces]
    assert len(slots) == len(set(slots))
    assert all(0 <= sl < 2 * plan.ctas for sl in slots)
    assert plan.splits == bool(slots)
    # the order is a function of the shape and the SM count alone
    ti8.int8_plan.cache_clear()
    again = ti8.int8_plan(M, N, K, 132)
    assert again == plan and again is not plan
    assert [again.pieces(0, nt) for nt in range(plan.n_tiles)] == \
        [plan.pieces(0, nt) for nt in range(plan.n_tiles)]
