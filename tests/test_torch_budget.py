"""The port's HBM budget (``core/budget.py``) and the engine's boot gate
held against the JAX package on the CPU.

- ``causal_lm_budget`` equals the JAX package's (params, KV and activation
  GiB to 1e-9 relative, ``fits``, ``describe()`` word for word) for
  ``tiny``, ``llama-8b`` at tp 1 and 4, ``mistral-7b`` at tp 4,
  ``llama3_70b`` at tp 1, 8, 16 and 32 (16 and 32 price every kv head a
  chip: 8 kv heads do not split 16 or 32 ways) and ``mllama_11b_text`` at
  tp 8 with its vision states, each with bf16 and int8 weights and with
  and without ``SHAI_KV_QUANT=int8``;
- ``diffusion_budget`` equals it for SD2.1 at 512 px (batch 1 and 4) and
  768 px;
- an illegal split raises on both sides; the engine under
  ``SHAI_ENFORCE_HBM=1`` refuses a small ``SHAI_HBM_GIB`` before its KV
  pool is built, with the budget's breakdown, and boots within budget;
  ``detect_hbm_gib`` reads ``SHAI_HBM_GIB`` first and the host's memory on
  the CPU.

The reference prices parameters from ``jax.eval_shape`` of each model's
flax ``init``: 2 s a call at 8B, 5 s at 70B, 5 s for SD2.1's UNet and
VAE. Here (:func:`memo_eval_shape`) the JAX package's own shape-exact
Llama tree, ``models.llama.geometry_params`` under ``eval_shape``, stands
in for the Llama ``init`` trace (a test holds the two trees equal, path
for path and shape for shape, at two layers of each preset's widths: the
layers repeat), and the UNet's and VAE's traces are memoized on their
configuration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from scalable_hw_agnostic_inference_tpu.core import budget as jb
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.engine.config import (
    EngineConfig as JEngineConfig,
)
from scalable_hw_agnostic_inference_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
)
from scalable_hw_agnostic_inference_tpu.models.sd import SDVariant as JSDVariant
from scalable_hw_agnostic_inference_tpu_torch.core import budget as pb
from scalable_hw_agnostic_inference_tpu_torch.engine import engine as pengine
from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
    EngineConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as pllama
from scalable_hw_agnostic_inference_tpu_torch.models.sd import SDVariant

REL = 1e-9
HBM = 80.0


def _geometry_tree(cfg):
    return jax.eval_shape(lambda: jllama.geometry_params(cfg, jnp.float32))


class _MemoJax:
    """``jax`` for the reference's budget module, whose ``eval_shape`` of a
    Llama ``init`` returns :func:`_geometry_tree` and whose other traces
    are memoized on the flax module's configuration (a UNet's or VAE's
    parameter shapes do not depend on the spatial size of the sample it is
    initialized with: convolutions, norms and attention projections)."""

    def __init__(self):
        self.cache = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def eval_shape(self, fn, *args):
        m = fn.__self__
        key = (type(m).__name__, m.cfg, getattr(m, "dtype", None))
        if key not in self.cache:
            self.cache[key] = (
                _geometry_tree(m.cfg)
                if isinstance(m, jllama.LlamaForCausalLM)
                else jax.eval_shape(fn, *args))
        return self.cache[key]


@pytest.fixture(scope="module", autouse=True)
def memo_eval_shape():
    mp = pytest.MonkeyPatch()
    mp.setattr(jb, "jax", _MemoJax())
    yield
    mp.undo()


@pytest.fixture(autouse=True)
def no_budget_env(monkeypatch):
    for name in ("SHAI_KV_QUANT", "SHAI_HBM_GIB", "SHAI_ENFORCE_HBM"):
        monkeypatch.delenv(name, raising=False)


def _same(got, want):
    for field in ("params_gib", "kv_gib", "act_gib", "hbm_gib_per_chip",
                  "reserve_frac"):
        g, w = getattr(got, field), getattr(want, field)
        assert g == pytest.approx(w, rel=REL, abs=0.0), field
    assert (got.what, got.chips, got.fits) == (want.what, want.chips,
                                               want.fits)
    assert got.describe() == want.describe()


#: (preset, tp, cross_seq_len, engine fields): the repo's manifests'
#: geometries (deploy/units: llama and mistral at tp=4, the 70B tiers at 16
#: and 32, mllama-11B at 8 with one 4-tile image's 6,404 vision states)
CAUSAL = [
    ("tiny", 1, 0, dict(max_model_len=256,
                        context_encoding_buckets=(32, 64, 128))),
    ("llama3_8b", 1, 0, dict(max_model_len=8192, max_num_seqs=8)),
    ("llama3_8b", 4, 0, dict(max_model_len=8192, max_num_seqs=8)),
    ("mistral_7b", 4, 0, dict(max_model_len=8192, max_num_seqs=8)),
    ("llama3_70b", 1, 0, dict(max_model_len=4096, max_num_seqs=4)),
    ("llama3_70b", 8, 0, dict(max_model_len=4096, max_num_seqs=4)),
    ("llama3_70b", 16, 0, dict(max_model_len=4096, max_num_seqs=4,
                               num_blocks=4096)),
    ("llama3_70b", 32, 0, dict(max_model_len=8192, max_num_seqs=16)),
    ("mllama_11b_text", 8, 6404, dict(max_model_len=8192, max_num_seqs=4)),
]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["kv-bf16", "kv-int8"])
@pytest.mark.parametrize("quant", [None, "int8"], ids=["w-bf16", "w-int8"])
@pytest.mark.parametrize(
    "preset,tp,cross,fields", CAUSAL,
    ids=[f"{p}-tp{tp}" for p, tp, _, _ in CAUSAL])
def test_causal_lm_budget_equals_the_jax_package(monkeypatch, preset, tp,
                                                 cross, fields, quant,
                                                 kv_quant):
    if kv_quant:
        monkeypatch.setenv("SHAI_KV_QUANT", "int8")
    kw = dict(model=preset, tensor_parallel_size=tp, quantization=quant,
              **fields)
    want = jb.causal_lm_budget(
        getattr(JLlamaConfig, preset)(), JEngineConfig(**kw),
        cross_seq_len=cross, hbm_gib_per_chip=HBM)
    got = pb.causal_lm_budget(
        getattr(pllama.LlamaConfig, preset)(), EngineConfig(**kw),
        cross_seq_len=cross, hbm_gib_per_chip=HBM)
    _same(got, want)


@pytest.mark.parametrize("preset", sorted({p for p, *_ in CAUSAL}))
def test_geometry_tree_is_the_init_tree(preset):
    """The stand-in of :func:`memo_eval_shape`: at two layers of the
    preset's widths (an mllama preset as the reference prices it, its
    plain clone), the flax ``init``'s tree and ``geometry_params``' hold
    the same paths with the same shapes."""
    cfg = dataclasses.replace(getattr(JLlamaConfig, preset)(), n_layers=2,
                              cross_attention_layers=())
    init = jax.eval_shape(
        jllama.LlamaForCausalLM(cfg, dtype=jnp.float32).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))

    def flat(tree):
        return {jax.tree_util.keystr(p): leaf.shape for p, leaf in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert flat(init) == flat(_geometry_tree(cfg))


@pytest.mark.parametrize("batch,size", [(1, 512), (4, 512), (1, 768)])
def test_diffusion_budget_equals_the_jax_package(batch, size):
    want = jb.diffusion_budget(JSDVariant.sd21(), batch=batch, height=size,
                               width=size, hbm_gib_per_chip=HBM)
    got = pb.diffusion_budget(SDVariant.sd21(), batch=batch, height=size,
                              width=size, hbm_gib_per_chip=HBM)
    _same(got, want)


def test_illegal_sharding_raises_on_both_sides():
    """tiny's 64 features and 128 MLP columns do not split 3 ways."""
    kw = dict(model="tiny", tensor_parallel_size=3, max_model_len=256,
              context_encoding_buckets=(128,))
    with pytest.raises(jb.HbmBudgetError, match="illegal sharding"):
        jb.causal_lm_budget(JLlamaConfig.tiny(), JEngineConfig(**kw),
                            hbm_gib_per_chip=HBM)
    with pytest.raises(pb.HbmBudgetError,
                       match="illegal sharding: embed.weight dim 64"):
        pb.causal_lm_budget(pllama.LlamaConfig.tiny(), EngineConfig(**kw),
                            hbm_gib_per_chip=HBM)


def _tiny_engine_parts():
    cfg = pllama.LlamaConfig.tiny()
    model = pllama.LlamaForCausalLM.from_state_dict(
        cfg, pllama.random_params(cfg, 0, dtype=torch.float32,
                                  device="cpu"), dtype=torch.float32)
    ecfg = EngineConfig(model="tiny", max_model_len=256, max_num_seqs=4,
                        context_encoding_buckets=(32, 64, 128),
                        dtype="float32", num_blocks=4096)
    return cfg, model, ecfg


def test_engine_gate_refuses_before_the_pool(monkeypatch):
    """Under ``SHAI_ENFORCE_HBM=1`` a CPU engine is gated too: 4,096
    blocks of 16 tokens over 2 layers of 2 kv heads of 16 are 8 MiB of KV
    against a declared 0.005 GiB; the refusal names the breakdown and
    comes before the KV pool is built."""
    cfg, model, ecfg = _tiny_engine_parts()
    monkeypatch.setenv("SHAI_ENFORCE_HBM", "1")
    monkeypatch.setenv("SHAI_HBM_GIB", "0.005")

    def no_pool(*a, **k):
        raise AssertionError("the KV pool was built before the gate")

    monkeypatch.setattr(pengine, "PagedKVCache", no_pool)
    want = pb.causal_lm_budget(cfg, ecfg, hbm_gib_per_chip=0.005)
    assert not want.fits
    with pytest.raises(pb.HbmBudgetError) as e:
        pengine.LLMEngine(cfg, model, ecfg, device="cpu")
    assert str(e.value) == want.describe()
    assert "OVER BUDGET by" in str(e.value)


def test_engine_gate_boots_within_budget(monkeypatch):
    cfg, model, ecfg = _tiny_engine_parts()
    monkeypatch.setenv("SHAI_ENFORCE_HBM", "1")
    monkeypatch.setenv("SHAI_HBM_GIB", "1")
    eng = pengine.LLMEngine(cfg, model, ecfg, device="cpu")
    assert eng.hbm_budget == pb.causal_lm_budget(cfg, ecfg,
                                                 hbm_gib_per_chip=1.0)
    assert eng.hbm_budget.fits
    # off the card and without the opt-in, no gate runs
    monkeypatch.delenv("SHAI_ENFORCE_HBM")
    assert pengine.LLMEngine(cfg, model, ecfg,
                             device="cpu").hbm_budget is None


def test_detect_hbm_gib(monkeypatch):
    monkeypatch.setenv("SHAI_HBM_GIB", "12.5")
    assert pb.detect_hbm_gib("cpu") == 12.5
    assert pb.detect_hbm_gib(torch.device("cuda", 0)) == 12.5
    with open("/proc/meminfo") as f:
        kib = next(int(line.split()[1]) for line in f
                   if line.startswith("MemTotal:"))
    # a malformed declaration degrades to no declaration, as unset
    for value in ("not-a-number", None):
        if value is None:
            monkeypatch.delenv("SHAI_HBM_GIB")
        else:
            monkeypatch.setenv("SHAI_HBM_GIB", value)
        assert pb.detect_hbm_gib("cpu") == pytest.approx(kib / 2 ** 20,
                                                         rel=1e-3)
    # no TPU table: nothing answers 16 GiB by default
    assert not hasattr(pb, "HBM_GIB")


def test_describe_is_the_reference_text():
    fields = dict(what="x tp=2 window=64", chips=2, hbm_gib_per_chip=16.0,
                  params_gib=10.0, kv_gib=4.0, act_gib=0.25)
    for over in (False, True):
        f = dict(fields, kv_gib=20.0) if over else fields
        want, got = jb.HbmBudget(**f), pb.HbmBudget(**f)
        assert got.describe() == want.describe()
        assert (got.fits, got.headroom_gib) == (want.fits, want.headroom_gib)
        if over:
            with pytest.raises(pb.HbmBudgetError):
                got.check()
        else:
            assert got.check() is got


def test_mllama_prices_cross_layers_as_self_layers():
    """The reference counts an mllama tree through a plain clone (its
    cross layers' q/k/v/o and MLP priced as a self layer's; the gates and
    head norms left out); the port's number is that one, not the one of
    its own cross-layer names."""
    cfg = pllama.LlamaConfig.mllama_11b_text()
    ecfg = EngineConfig(model="m", tensor_parallel_size=8)
    plain = dataclasses.replace(cfg, cross_attention_layers=())
    want = pb.params_bytes_per_chip(
        pllama._weight_shapes(plain), pllama.tp_rules(), 8, 2.0)
    got = pb.causal_lm_budget(cfg, ecfg, cross_seq_len=6404,
                              hbm_gib_per_chip=HBM)
    assert got.params_gib == want / pb.GIB
    own = pb.params_bytes_per_chip(
        pllama._weight_shapes(cfg), pllama.tp_rules(), 8, 2.0)
    assert own != want
