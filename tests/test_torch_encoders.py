"""DistilBERT, ViT and YOLOS in the port against the JAX package, on the
CPU in fp32.

The JAX modules' trees are ``jax.eval_shape`` of their ``init`` filled
with numpy draws (``test_torch_diffusion._randomize``) and carried into
the port by ``params_from_jax``. Every forward is held to ``FP32_RRMS``:
max |port - JAX| over rms(JAX) of the logits (and YOLOS's boxes).

- the shared encoder (``models/encoder.py``) pre-LN and post-LN, without a
  mask, with a right-padded mask (B1's lengths) and with a mask that is
  not a prefix (the masked plain path);
- DistilBERT with and without its padding mask (padded query rows attend
  the valid keys in both packages; the classifier reads the [CLS] row);
- ViT and YOLOS over the same pixels; ``postprocess`` equal to the JAX
  function on the same logits and boxes, at several thresholds;
- each HF-key loader (``state_from_hf``) against the JAX package's own
  ``params_from_torch``, given the same seeded torch state dict under the
  HF names: both compute the same logits, no ``transformers`` model built;
- the refusals: a ``config.json`` whose ``model_type`` is not DistilBERT,
  YOLOS positions of another image's length.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models import bert as jbert
from scalable_hw_agnostic_inference_tpu.models import encoder as jenc
from scalable_hw_agnostic_inference_tpu.models import vit as jvit
from scalable_hw_agnostic_inference_tpu.models import yolos as jyolos
from scalable_hw_agnostic_inference_tpu_torch.models import bert as pbert
from scalable_hw_agnostic_inference_tpu_torch.models import encoder as penc
from scalable_hw_agnostic_inference_tpu_torch.models import vit as pvit
from scalable_hw_agnostic_inference_tpu_torch.models import yolos as pyolos

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_diffusion import _jax_params, _rel_max  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

#: fp32 forwards, port against JAX: max |diff| over rms(JAX)
FP32_RRMS = 1e-5

B, T = 2, 12
#: a right-padded batch: row 0 holds 5 tokens, row 1 all 12
PREFIX_MASK = np.array([[1] * 5 + [0] * 7, [1] * 12], np.int32)
#: a mask whose valid keys are no prefix (the plain path's masked branch)
HOLED_MASK = np.array([[1, 0, 1, 1, 0, 1, 1, 1, 0, 0, 1, 1], [1] * 12],
                      np.int32)
MASKS = {"none": None, "prefix": PREFIX_MASK, "holed": HOLED_MASK}


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


#: the JAX modules at their tiny configs, each with one jitted ``apply``
#: that every test of the module shares: one compile a module and
#: argument signature (a mask or none), not one a test
JBERT = jbert.DistilBertClassifier(jbert.BertConfig.tiny(), dtype=jnp.float32)
JVIT = jvit.ViTClassifier(jvit.ViTConfig.tiny(), dtype=jnp.float32)
JYOLOS = jyolos.YolosForObjectDetection(jyolos.YolosConfig.tiny())
APPLY = {"bert": jax.jit(JBERT.apply), "vit": jax.jit(JVIT.apply),
         "yolos": jax.jit(JYOLOS.apply)}
ENC_KW = dict(n_layers=2, dim=32, heads=2, mlp_dim=64, act="gelu",
              ln_eps=1e-12)


@pytest.fixture(scope="module", params=[True, False],
                ids=["pre_ln", "post_ln"])
def encoder_pair(request):
    """The shared encoder stack, pre-LN or post-LN: its JAX module's
    jitted ``apply``, tree, input, and the port's stack on that tree."""
    kw = dict(ENC_KW, pre_ln=request.param)
    jm = jenc.Encoder(**kw, dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal((B, T, 32)).astype(
        np.float32)
    tree = _jax_params(jm.init, 11, jnp.asarray(x))
    pm = penc.Encoder(**kw, device="cpu")
    pm.load_state_dict(penc.state_from_flax(tree), strict=True)
    return jax.jit(jm.apply), tree, x, pm


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_encoder_against_jax(encoder_pair, mask):
    """The shared encoder stack, pre-LN and post-LN, under each mask."""
    apply, tree, x, pm = encoder_pair
    m = MASKS[mask]
    want = apply(tree, jnp.asarray(x), mask=jenc.attention_mask_2d(
        None if m is None else jnp.asarray(m)))
    with torch.inference_mode():
        got = pm(_t(x), attention_mask=_t(m))
    assert _rel_max(got, np.asarray(want)) < FP32_RRMS


def test_key_lengths_reads_a_right_padded_mask():
    lengths, mask = penc.key_lengths(_t(PREFIX_MASK))
    assert mask is None and lengths.tolist() == [5, 12]
    lengths, mask = penc.key_lengths(_t(HOLED_MASK))
    assert lengths is None and mask.shape == (B, 1, 1, T)
    assert penc.key_lengths(None) == (None, None)


@pytest.fixture(scope="module")
def bert_pair():
    cfg = jbert.BertConfig.tiny()
    ids = jnp.zeros((1, T), jnp.int32)
    tree = _jax_params(JBERT.init, 21, ids, jnp.ones((1, T), jnp.int32))
    pm = pbert.build(pbert.BertConfig.tiny(), pbert.params_from_jax(tree))
    return cfg, tree, pm


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_distilbert_against_jax(bert_pair, mask):
    cfg, tree, pm = bert_pair
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, T),
                                            dtype=np.int32)
    m = MASKS[mask]
    want = APPLY["bert"](tree, jnp.asarray(ids),
                         None if m is None else jnp.asarray(m))
    with torch.inference_mode():
        got = pm(_t(ids).long(), _t(m))
    assert got.dtype == torch.float32 and got.shape == (B, cfg.n_labels)
    assert _rel_max(got, np.asarray(want)) < FP32_RRMS


def test_vit_against_jax():
    cfg = jvit.ViTConfig.tiny()
    px = np.random.default_rng(5).standard_normal(
        (B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    tree = _jax_params(JVIT.init, 31, jnp.asarray(px))
    pm = pvit.build(pvit.ViTConfig.tiny(), pvit.params_from_jax(tree))
    want = APPLY["vit"](tree, jnp.asarray(px))
    with torch.inference_mode():
        got = pm(_t(px))
    assert got.shape == (B, cfg.n_labels)
    assert _rel_max(got, np.asarray(want)) < FP32_RRMS


@pytest.fixture(scope="module")
def yolos_pair():
    cfg = jyolos.YolosConfig.tiny()
    px = np.random.default_rng(6).standard_normal(
        (B, *cfg.image_size, 3)).astype(np.float32)
    tree = _jax_params(JYOLOS.init, 41, jnp.asarray(px))
    pm = pyolos.build(pyolos.YolosConfig.tiny(),
                      pyolos.params_from_jax(tree))
    want = APPLY["yolos"](tree, jnp.asarray(px))
    with torch.inference_mode():
        got = pm(_t(px))
    return cfg, want, got


def test_yolos_against_jax(yolos_pair):
    cfg, (wl, wb), (gl, gb) = yolos_pair
    assert gl.shape == (B, cfg.n_det_tokens, cfg.n_labels)
    assert gb.shape == (B, cfg.n_det_tokens, 4)
    assert _rel_max(gl, np.asarray(wl)) < FP32_RRMS
    assert _rel_max(gb, np.asarray(wb)) < FP32_RRMS


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.5, 0.99])
def test_yolos_postprocess_equals_jax(yolos_pair, threshold):
    _, (wl, wb), _ = yolos_pair
    labels = {0: "cat", 2: "dog"}
    for ids in (None, labels):
        got = pyolos.postprocess(np.asarray(wl)[0], np.asarray(wb)[0],
                                 threshold, 864, 512, ids)
        want = jyolos.postprocess(np.asarray(wl)[0], np.asarray(wb)[0],
                                  threshold, 864, 512, ids)
        assert got == want
    if threshold == 0.0:
        assert len(got) == 5


# -- the HF-key loaders ------------------------------------------------------


def _hf_state(names, shapes, seed):
    """A seeded torch state dict under the HF keys of ``names`` (this
    package's name -> HF key), each of ``shapes[ours]``."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for ours, hf in names.items():
        shape = shapes[ours]
        if ours.endswith("weight") and len(shape) == 1:   # LayerNorm scales
            sd[hf] = 1.0 + 0.1 * torch.randn(shape, generator=gen)
        else:
            fan = shape[-1] if len(shape) > 1 else 10.0
            sd[hf] = torch.randn(shape, generator=gen) / np.sqrt(fan)
    return sd


def _shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def _hf_case(which):
    if which == "bert":
        cfg = pbert.BertConfig.tiny()
        m = pbert.DistilBertClassifier(cfg, device="cpu")
        return (cfg, m, pbert,
                lambda sd: jbert.params_from_torch(sd, JBERT.cfg))
    if which == "vit":
        cfg = pvit.ViTConfig.tiny()
        m = pvit.ViTClassifier(cfg, device="cpu")
        return (cfg, m, pvit,
                lambda sd: jvit.params_from_torch(sd, JVIT.cfg))
    cfg = pyolos.YolosConfig.tiny()
    m = pyolos.YolosForObjectDetection(cfg, device="cpu")
    return (cfg, m, pyolos,
            lambda sd: jyolos.params_from_torch(sd, JYOLOS.cfg))


@pytest.mark.parametrize("which", ["bert", "vit", "yolos"])
def test_hf_loader_against_params_from_torch(which):
    """``state_from_hf`` over an HF-named state dict and the JAX
    ``params_from_torch`` over the same one compute the same outputs."""
    cfg, module, mod, from_torch = _hf_case(which)
    names = mod.hf_names(cfg)
    assert set(names) == set(module.state_dict())
    sd = _hf_state(names, _shapes(module), seed=51)
    pm = mod.build(cfg, mod.state_from_hf(sd.__getitem__, sd.keys(), cfg))
    tree = from_torch(sd)
    rng = np.random.default_rng(7)
    if which == "bert":
        ids = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
        want = [APPLY["bert"](tree, jnp.asarray(ids),
                              jnp.asarray(PREFIX_MASK))]
        with torch.inference_mode():
            got = [pm(_t(ids).long(), _t(PREFIX_MASK))]
    else:
        size = cfg.image_size
        hw = size if isinstance(size, tuple) else (size, size)
        px = rng.standard_normal((B, *hw, 3)).astype(np.float32)
        want = APPLY[which](tree, jnp.asarray(px))
        with torch.inference_mode():
            got = pm(_t(px))
        if which == "vit":
            want, got = [want], [got]
    for g, w in zip(got, want):
        assert _rel_max(g, np.asarray(w)) < FP32_RRMS
    # a missing key is named
    sd.pop(names["encoder.layer_1.fc2.bias"])
    with pytest.raises(ValueError, match="fc2.bias|output"):
        mod.state_from_hf(sd.__getitem__, sd.keys(), cfg)


def test_bert_config_refuses_another_model_type():
    base = {"model_type": "distilbert", "vocab_size": 100, "dim": 32,
            "n_layers": 2, "n_heads": 2, "hidden_dim": 64,
            "id2label": {"0": "NEGATIVE", "1": "POSITIVE"}}
    cfg = pbert.BertConfig.from_hf(base)
    assert (cfg.vocab_size, cfg.dim, cfg.n_labels) == (100, 32, 2)
    for kind in ("bert", "roberta", None):
        with pytest.raises(ValueError, match="DistilBERT"):
            pbert.BertConfig.from_hf({**base, "model_type": kind})


def test_yolos_positions_of_another_image_are_refused():
    cfg = pyolos.YolosConfig.tiny()
    module = pyolos.YolosForObjectDetection(cfg, device="cpu")
    names = pyolos.hf_names(cfg)
    shapes = _shapes(module)
    shapes["pos"] = (1, cfg.n_tokens + 3, cfg.dim)
    sd = _hf_state(names, shapes, seed=52)
    with pytest.raises(ValueError, match="not interpolated"):
        pyolos.state_from_hf(sd.__getitem__, sd.keys(), cfg)
    assert pyolos.YolosConfig().n_tokens == 1829
