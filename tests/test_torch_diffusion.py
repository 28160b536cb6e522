"""Stable Diffusion 2.x's modules in the port, held against the JAX
package on the CPU at tiny sizes.

The same inputs, drawn from a seed with numpy, go through the JAX function
and its port; the JAX modules' parameter trees (their shapes from
``jax.eval_shape`` of the flax ``init``, their values numpy draws) are
carried into the port through each module's ``params_from_jax``.

- schedulers: the tables equal the JAX package's; DDIM and Euler steps
  under epsilon and v-prediction within 1e-6;
- the CLIP text encoder (fp32, causal) within 1e-5 of the JAX package's,
  the pooled row at the same index; its HF-key loader against the JAX
  package's ``params_from_torch`` on one synthetic state dict;
- the UNet and the VAE (decode and encode): at fp32 within 1e-4·rms of the
  JAX package's; at bf16 by the attention rule (rms of the difference
  within ``1e-6 + 0.05·rms(ref)``) and no further from the JAX bf16 output
  than twice that output's own distance from the JAX fp32 forward (the
  bf16 rounding floor: XLA and torch round at different points);
  ``timestep_embedding``; the diffusers converters against the JAX
  package's ``params_from_torch`` on one synthetic state dict;
- the pipeline: ``txt2img_batch`` over the same latents, DDIM and Euler,
  epsilon and v, 2 steps at 16 px; ``txt2img_stepwise`` equal to the loop;
  a row's image independent of its batch;
- the CLIP tokenizer against ``transformers``' ``CLIPTokenizerFast`` (the
  class ``AutoTokenizer`` loads there) on generated SD2.1-style
  (``!`` pad) and SD1.x-style (end-of-text pad) directories;
- the PNG encoder read back by PIL and by the port's ``decode_png``;
- B1's plain path at the UNet's head counts and at S = 77 against the JAX
  package's ``dot_product_attention``.
"""

import collections
import dataclasses
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models import clip as jclip
from scalable_hw_agnostic_inference_tpu.models import schedulers as jsch
from scalable_hw_agnostic_inference_tpu.models import sd as jsd
from scalable_hw_agnostic_inference_tpu.models import unet as junet
from scalable_hw_agnostic_inference_tpu.models import vae as jvae
from scalable_hw_agnostic_inference_tpu.ops import attention as jattn
from scalable_hw_agnostic_inference_tpu_torch.models import clip as pclip
from scalable_hw_agnostic_inference_tpu_torch.models import imageio
from scalable_hw_agnostic_inference_tpu_torch.models import schedulers as psch
from scalable_hw_agnostic_inference_tpu_torch.models import sd as psd
from scalable_hw_agnostic_inference_tpu_torch.models import unet as punet
from scalable_hw_agnostic_inference_tpu_torch.models import vae as pvae
from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    BYTE_TO_CHAR,
    ClipTokenizer,
)
from scalable_hw_agnostic_inference_tpu_torch.ops import attention as pattn
from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
    flash_attention as pflash,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_threads import one_torch_thread  # noqa: E402,F401

#: fp32 modules: max |port - JAX| over rms(JAX)
FP32_RRMS = 1e-4
#: the attention rule: rms(port - JAX) within ATOL + RRMS·rms(JAX)
BF16_ATOL, BF16_RRMS = 1e-6, 0.05
#: and the port's bf16 output no further from the JAX bf16 output than
#: this many times the JAX bf16 output's own distance from its fp32 one
BF16_FLOOR = 2.0
#: the pipeline's uint8 images, port against JAX on the same latents, in
#: levels of 255 (mean, max). Measured at 2 steps, 16 px, guidance 5, over
#: 3 seeds x 4 schedules: the UNet fp32 (the VAE bf16 on both sides, as
#: the reference fixes it) 0.29-0.36, 2-3; the UNet bf16 2.06-3.15, 14-22,
#: where the JAX pipeline's own bf16 images lie 1.76-2.74, 11-30 from its
#: fp32 ones (random tiny weights under guidance amplify bf16 rounding)
PIPE_F32_MEAN, PIPE_F32_MAX = 0.5, 4
PIPE_BF16_MEAN, PIPE_BF16_MAX = 4.0, 32



def _randomize(shapes, seed):
    """Numpy draws for a flax parameter tree of ``ShapeDtypeStruct``s:
    kernels and embeddings N(0, 1/fan_in), norm scales 1 + N(0, 0.1),
    biases N(0, 0.1); float32."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name == "bias":
            a = 0.1 * rng.standard_normal(s.shape)
        else:
            fan = (int(np.prod(s.shape[:-1])) if name == "kernel"
                   else s.shape[-1])
            a = rng.standard_normal(s.shape) / np.sqrt(fan)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_params(init, seed, *args):
    """A flax ``init``'s tree shape, filled from ``seed`` (no flax init
    runs: its eager trace costs seconds)."""
    return _randomize(jax.eval_shape(init, jax.random.PRNGKey(0), *args),
                      seed)


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.sqrt((want ** 2).mean()))


def _check_bf16(got, want, want_f32):
    """The bf16 rule (module note)."""
    want = np.asarray(want, np.float64)
    rms = np.sqrt((want ** 2).mean())
    err = np.sqrt(((np.asarray(got, np.float64) - want) ** 2).mean())
    assert err <= BF16_ATOL + BF16_RRMS * rms, (err, rms)
    floor = np.abs(want - np.asarray(want_f32, np.float64)).max()
    assert np.abs(np.asarray(got, np.float64) - want).max() \
        <= BF16_FLOOR * floor, floor


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- schedulers ------------------------------------------------------------------

SCHEDULES = [(name, pred) for name in ("ddim", "euler")
             for pred in ("epsilon", "v_prediction")]


@pytest.mark.parametrize("name,pred", SCHEDULES)
def test_scheduler_tables_and_steps_equal_the_jax_package(name, pred):
    """Tables equal (numpy both sides); every step of a 25-step run, and
    Euler's input scaling, within 1e-6 (absolute and relative) on
    unit-scale inputs."""
    cfg = psch.ScheduleConfig(prediction_type=pred)
    jcfg = jsch.ScheduleConfig(prediction_type=pred)
    ps, js = psch.get_scheduler(name, cfg), jsch.get_scheduler(name, jcfg)
    assert ps.init_noise_sigma == js.init_noise_sigma
    for steps in (1, 2, 3, 25, 50):
        np.testing.assert_array_equal(psch.inference_timesteps(cfg, steps),
                                      jsch.inference_timesteps(jcfg, steps))
        for p, j in zip(ps.tables(steps), js.tables(steps)):
            np.testing.assert_array_equal(p, np.asarray(j))
    if name == "euler":
        assert ps.init_sigma_for(25) == js.init_sigma_for(25)
    rng = np.random.default_rng(0)
    ts, a, a2 = ps.tables(25)
    for i in range(25):
        x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
        eps = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
        want = js.step(jnp.asarray(x), jnp.asarray(eps), jnp.float32(a[i]),
                       jnp.float32(a2[i]))
        got = ps.step(_t(x), _t(eps), a[i], a2[i])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)
        if name == "euler":
            np.testing.assert_allclose(
                ps.scale_model_input(_t(x), a[i]).numpy(),
                np.asarray(js.scale_model_input(jnp.asarray(x),
                                                jnp.float32(a[i]))),
                atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown scheduler"):
        psch.get_scheduler("pndm")


# -- the CLIP text encoder -------------------------------------------------------

@pytest.fixture(scope="module")
def clip_pair():
    cfg = jclip.ClipTextConfig.tiny()
    jm = jclip.ClipTextEncoder(cfg)
    params = _jax_params(jm.init, 5, jnp.zeros((1, 8), jnp.int32))
    pm = pclip.build(pclip.ClipTextConfig.tiny(),
                     pclip.params_from_jax(params))
    return jm, params, pm


def test_clip_text_encoder_equals_the_jax_package(clip_pair):
    """Causal fp32 within 1e-5; the pooled features at the same index (the
    highest id, the first of equal ones); a later token never moves an
    earlier position."""
    jm, params, pm = clip_pair
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 120, (3, 16)).astype(np.int32)
    ids[0, 5] = ids[1, 9] = 127
    ids[2, 3] = ids[2, 11] = 127        # two end-of-text ids: the first
    jx, jpooled = jm.apply(params, ids)
    with torch.inference_mode():
        px, ppooled = pm(_t(ids))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ppooled.numpy(), np.asarray(jpooled),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ppooled.numpy()[2], px.numpy()[2, 3])
    later = ids.copy()
    later[:, 12:] = 7
    with torch.inference_mode():
        lx, _ = pm(_t(later))
    np.testing.assert_array_equal(lx.numpy()[:, :12], px.numpy()[:, :12])
    assert np.abs(lx.numpy()[:, 12:] - px.numpy()[:, 12:]).max() > 1e-3


@pytest.mark.parametrize("prefix", ["text_model.", ""])
def test_clip_hf_loader_equals_the_jax_package(clip_pair, prefix):
    """A synthetic HF ``CLIPTextModel`` state dict (the tiny encoder's
    weights under HF's names, either key layout, with a third layer the
    config does not run): the port's ``state_from_hf`` keeps the 2 layers
    asked for, and equals the JAX package's ``params_from_torch`` of the
    same dict carried through ``params_from_jax``."""
    jm, params, pm = clip_pair
    cfg = pclip.ClipTextConfig.tiny()
    state = pclip.params_from_jax(params)
    names = pclip.hf_names(cfg, pre=prefix)
    hf = {names[k]: t.clone() for k, t in state.items()}
    for k in [k for k in hf if ".layers.1." in k]:
        hf[k.replace(".layers.1.", ".layers.2.")] = hf[k] + 1.0
    got = pclip.state_from_hf(hf.__getitem__, hf, cfg)
    via_jax = pclip.params_from_jax(jclip.params_from_torch(
        hf, jclip.ClipTextConfig.tiny()))
    assert set(got) == set(state) == set(via_jax)
    for k in state:
        torch.testing.assert_close(got[k], state[k], rtol=0, atol=0)
        torch.testing.assert_close(via_jax[k], state[k], rtol=0, atol=0)
    hf_cfg = {"vocab_size": 128, "max_position_embeddings": 16,
              "hidden_size": 32, "num_hidden_layers": 3,
              "num_attention_heads": 2, "intermediate_size": 64,
              "layer_norm_eps": 1e-5, "hidden_act": "gelu"}
    assert pclip.ClipTextConfig.from_hf(hf_cfg, penultimate=True) == cfg
    with pytest.raises(ValueError, match="has no"):
        pclip.state_from_hf(hf.__getitem__, set(hf) - {names["tok_emb"]},
                            cfg)


# -- the UNet --------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_params():
    cfg = junet.UNetConfig.tiny()
    return _jax_params(junet.UNet2DCondition(cfg).init, 1,
                       jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, 8, cfg.cross_attention_dim)))


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 981], np.int32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    return x, t, ctx


def _port_unet(params, dtype):
    return punet.build(punet.UNetConfig.tiny(), punet.params_from_jax(params),
                       dtype=dtype)


def test_unet_equals_the_jax_package(unet_params):
    """fp32 within 1e-4·rms; bf16 by the bf16 rule; the output fp32 NHWC;
    the conditioning conditions."""
    cfg = junet.UNetConfig.tiny()
    x, t, ctx = _unet_inputs(2)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        m = junet.UNet2DCondition(cfg, dtype=dt)
        want[dt] = np.asarray(jax.jit(m.apply)(unet_params, x, t, ctx))
    with torch.inference_mode():
        got32 = _port_unet(unet_params, torch.float32)(_t(x), _t(t), _t(ctx))
        got16 = _port_unet(unet_params, torch.bfloat16)(_t(x), _t(t),
                                                        _t(ctx))
        moved = _port_unet(unet_params, torch.float32)(_t(x), _t(t),
                                                       _t(ctx + 1.0))
    assert got32.dtype == got16.dtype == torch.float32
    assert got32.shape == (2, 16, 16, 4)
    assert _rel_max(got32.numpy(), want[jnp.float32]) <= FP32_RRMS
    _check_bf16(got16.numpy(), want[jnp.bfloat16], want[jnp.float32])
    assert np.abs(moved.numpy() - got32.numpy()).max() > 1e-3


def test_timestep_embedding_equals_the_jax_package():
    """Equal to the JAX formula up to float32 rounding of its arguments
    (``t · freq`` is about 999 at most, where an ulp is 6.1e-5: sin and
    cos of two 1-ulp-apart arguments differ by that much); exact at t=0."""
    t = np.array([0.0, 1.0, 7.0, 500.0, 999.0], np.float32)
    for dim in (8, 320):
        got = punet.timestep_embedding(_t(t), dim).numpy()
        want = np.asarray(junet.timestep_embedding(jnp.asarray(t), dim))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    emb = punet.timestep_embedding(torch.tensor([0.0]), 8).numpy()[0]
    np.testing.assert_array_equal(emb, [1, 1, 1, 1, 0, 0, 0, 0])


def _to_diffusers(state, names, conv_keys=()):
    """The port's state under diffusers' names; each name in
    ``conv_keys`` stored as a 1x1 convolution."""
    out = {}
    for name, t in state.items():
        t = t.clone()
        if any(k in name for k in conv_keys) and name.endswith("weight") \
                and t.ndim == 2:
            t = t[:, :, None, None]
        out[names(name)] = t
    return out


@pytest.mark.parametrize("proj", ["linear", "conv1x1"])
def test_unet_diffusers_converter_equals_the_jax_package(unet_params, proj):
    """A synthetic diffusers state dict (the port's tiny UNet under
    diffusers' names; SD1.x's ``proj_in``/``proj_out`` as 1x1 convs):
    the port's ``state_from_diffusers`` gives back the state, and the JAX
    package's ``params_from_torch`` of the same dict, carried through
    ``params_from_jax``, gives the same tensors."""
    state = punet.params_from_jax(unet_params)
    conv = ("proj_in", "proj_out") if proj == "conv1x1" else ()
    dsd = _to_diffusers(state, punet.diffusers_name, conv)
    cfg = punet.UNetConfig.tiny()
    got = punet.state_from_diffusers(dsd.__getitem__, dsd, cfg)
    jtree = junet.params_from_torch(dsd, junet.UNetConfig.tiny())
    via_jax = punet.params_from_jax(jtree)
    assert set(got) == set(state) == set(via_jax)
    for k in state:
        torch.testing.assert_close(got[k], state[k], rtol=0, atol=0)
        torch.testing.assert_close(via_jax[k], state[k], rtol=0, atol=0)
    assert "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_out.0" \
        ".weight" in dsd
    with pytest.raises(ValueError, match="has no"):
        punet.state_from_diffusers(dsd.__getitem__,
                                   set(dsd) - {"conv_in.weight"}, cfg)


def test_unet_config_from_hf_reads_heads_per_level():
    sd21 = punet.UNetConfig.from_hf({
        "block_out_channels": [320, 640, 1280, 1280],
        "attention_head_dim": [5, 10, 20, 20],
        "cross_attention_dim": 1024})
    assert sd21 == punet.UNetConfig.sd21()
    assert sd21.head_dims() == (64, 64, 64)
    sd15 = punet.UNetConfig.from_hf({"attention_head_dim": 8,
                                     "cross_attention_dim": 768})
    assert sd15 == punet.UNetConfig.sd15()
    assert sd15.head_dims() == (40, 80, 160)


# -- the VAE ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_params():
    cfg = jvae.VAEConfig.tiny()
    m = jvae.AutoencoderKL(cfg)
    dec = jax.eval_shape(m.init, jax.random.PRNGKey(0),
                         jnp.zeros((1, 8, 8, 4)))
    enc = jax.eval_shape(
        lambda r, x: m.init(r, x, method=jvae.AutoencoderKL.encode),
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    return _randomize({"params": {**dec["params"], **enc["params"]}}, 3)


def test_vae_decode_and_encode_equal_the_jax_package(vae_params):
    """decode and encode: fp32 within 1e-4·rms, bf16 by the bf16 rule;
    NHWC in and out."""
    cfg = jvae.VAEConfig.tiny()
    rng = np.random.default_rng(4)
    z = (0.2 * rng.standard_normal((2, 8, 8, 4))).astype(np.float32)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        m = jvae.AutoencoderKL(cfg, dtype=dt)

        def both(p, z, x, m=m):
            return (m.apply(p, z, method=jvae.AutoencoderKL.decode),
                    *m.apply(p, x, method=jvae.AutoencoderKL.encode))

        want[dt] = tuple(map(np.asarray, jax.jit(both)(vae_params, z, img)))
    state = pvae.params_from_jax(vae_params)
    for dt, pdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        pm = pvae.build(pvae.VAEConfig.tiny(), state, dtype=pdt)
        with torch.inference_mode():
            got = (pm.decode(_t(z)).numpy(),
                   *(t.numpy() for t in pm.encode(_t(img))))
        assert got[0].shape == (2, 16, 16, 3)
        assert got[1].shape == got[2].shape == (2, 8, 8, 4)
        for g, w, w32 in zip(got, want[dt], want[jnp.float32]):
            if dt == jnp.float32:
                assert _rel_max(g, w) <= FP32_RRMS
            else:
                _check_bf16(g, w, w32)


@pytest.mark.parametrize("attn", ["to_q", "query"])
def test_vae_diffusers_converter_equals_the_jax_package(vae_params, attn):
    """As the UNet's: a synthetic diffusers ``AutoencoderKL`` state dict
    (modern ``to_q``/``to_out.0`` attention names, or the old
    ``query``/``proj_attn`` ones as 1x1 convs), the 1x1
    ``quant_conv``/``post_quant_conv``."""
    cfg = pvae.VAEConfig.tiny()
    state = pvae.params_from_jax(vae_params)
    names = pvae.diffusers_names(cfg, {"encoder.conv_in.weight",
                                       "decoder.mid_block.attentions.0.to_q"
                                       ".weight",
                                       "encoder.mid_block.attentions.0.to_q"
                                       ".weight"})
    old = {"to_q": "query", "to_k": "key", "to_v": "value",
           "to_out.0": "proj_attn"}

    def name(n):
        src = names[n]
        if attn == "query":
            for a, b in old.items():
                src = src.replace(f".attentions.0.{a}.", f".attentions.0.{b}.")
        return src

    conv = ("post_quant", "quant") + (
        (".attn.q.", ".attn.k.", ".attn.v.", ".attn.o.")
        if attn == "query" else ())
    dsd = _to_diffusers(state, name, conv)
    got = pvae.state_from_diffusers(dsd.__getitem__, dsd, cfg)
    via_jax = pvae.params_from_jax(jvae.params_from_torch(
        dsd, jvae.VAEConfig.tiny()))
    assert set(got) == set(state) == set(via_jax)
    for k in state:
        torch.testing.assert_close(got[k], state[k], rtol=0, atol=0)
        torch.testing.assert_close(via_jax[k], state[k], rtol=0, atol=0)


# -- the pipeline ----------------------------------------------------------------

D_CTX = junet.UNetConfig.tiny().cross_attention_dim


def _jax_text(ids):
    return jax.nn.one_hot(ids % D_CTX, D_CTX)


def _port_text(ids):
    return torch.nn.functional.one_hot(ids % D_CTX, D_CTX).float()


def _variants(pred):
    sched = psch.ScheduleConfig(prediction_type=pred)
    jsched = jsch.ScheduleConfig(prediction_type=pred)
    return (dataclasses.replace(psd.SDVariant.tiny(), schedule=sched),
            dataclasses.replace(jsd.SDVariant.tiny(), schedule=jsched))


#: the fourth pairing, DDIM with epsilon at bf16, is the tiny tier's: the
#: unit test (``test_torch_serve_sd.py``) holds it against the JAX unit
PIPES = [("ddim", "v_prediction", "fp32"), ("euler", "epsilon", "fp32"),
         ("euler", "v_prediction", "bf16")]


@pytest.mark.parametrize("sched,pred,dtype", PIPES)
def test_txt2img_batch_equals_the_jax_package(unet_params, vae_params, sched,
                                              pred, dtype):
    """``txt2img_batch`` on the same latents, 2 steps at 16 px, guidance
    5: the uint8 images within ``PIPE_*`` levels (mean and max) of the
    JAX pipeline's, the UNet in ``dtype`` on both sides (the VAE in bf16,
    as the reference fixes it)."""
    pv, jv = _variants(pred)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    pdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    jpipe = jsd.StableDiffusion(jv, unet_params, vae_params, _jax_text,
                                scheduler=sched, dtype=jdt)
    ppipe = psd.StableDiffusion(
        pv, _port_unet(unet_params, pdt),
        pvae.build(pvae.VAEConfig.tiny(), pvae.params_from_jax(vae_params)),
        _port_text, scheduler=sched)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 100, (2, 6)).astype(np.int32)
    un = np.zeros((2, 6), np.int32)
    lat = (rng.standard_normal((2, 8, 8, 4))
           * ppipe._init_scale(2)).astype(np.float32)
    kw = dict(height=16, width=16, steps=2, guidance_scale=5.0)
    want = jpipe.txt2img_batch(jnp.asarray(ids), jnp.asarray(un),
                               jnp.asarray(lat), **kw)
    got = ppipe.txt2img_batch(ids, un, _t(lat), **kw)
    assert got.dtype == np.uint8 and got.shape == (2, 16, 16, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    mean_b, max_b = ((PIPE_F32_MEAN, PIPE_F32_MAX) if dtype == "fp32"
                     else (PIPE_BF16_MEAN, PIPE_BF16_MAX))
    assert diff.mean() <= mean_b and diff.max() <= max_b, (
        diff.mean(), diff.max())


@pytest.fixture(scope="module")
def port_pipe(unet_params, vae_params):
    pv, _ = _variants("epsilon")
    return psd.StableDiffusion(
        pv, _port_unet(unet_params, torch.bfloat16),
        pvae.build(pvae.VAEConfig.tiny(), pvae.params_from_jax(vae_params)),
        _port_text)


def test_txt2img_stepwise_equals_the_loop_and_seeds_repeat(port_pipe):
    """The stepwise mode (table values from the host each step) gives the
    loop's image bit for bit; a seed repeats its image; ``txt2img`` at
    batch 1 is ``txt2img_batch`` over ``init_latents(seed)``; the prompt
    and the seed both move the image."""
    ids = np.array([[3, 5, 7, 9]])
    un = np.zeros((1, 4), np.int64)
    kw = dict(height=16, width=16, steps=3, guidance_scale=5.0)
    a = port_pipe.txt2img(ids, un, rng=0, **kw)
    b = port_pipe.txt2img_stepwise(ids, un, rng=0, **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, port_pipe.txt2img(ids, un, rng=0, **kw))
    c = port_pipe.txt2img_batch(ids, un, port_pipe.init_latents(0, 8, 8, 3),
                                **kw)
    np.testing.assert_array_equal(a, c)
    assert np.abs(a.astype(int) - port_pipe.txt2img(
        ids + 1, un, rng=0, **kw).astype(int)).max() > 0
    assert np.abs(a.astype(int) - port_pipe.txt2img(
        ids, un, rng=1, **kw).astype(int)).max() > 0
    with pytest.raises(ValueError, match="multiples"):
        port_pipe.txt2img(ids, un, rng=0, height=15, width=16, steps=1)


def test_a_rows_image_does_not_depend_on_its_batch(port_pipe):
    """The reference's composition invariance: in one batch bucket a row's
    image is a function of its own prompt and latents, whatever else
    shares the batch and in whichever order."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 100, (6, 5))
    un = np.zeros((4, 5), np.int64)
    lat = torch.cat([port_pipe.init_latents(s, 8, 8, 2) for s in range(6)])
    kw = dict(height=16, width=16, steps=2, guidance_scale=7.5)
    a = port_pipe.txt2img_batch(ids[:4], un, lat[:4], **kw)
    order = [3, 2, 0, 1]
    b = port_pipe.txt2img_batch(ids[order], un, lat[order], **kw)
    for i, j in enumerate(order):
        np.testing.assert_array_equal(b[i], a[j])
    mix = [1, 4, 5, 2]
    c = port_pipe.txt2img_batch(ids[mix], un, lat[mix], **kw)
    np.testing.assert_array_equal(c[0], a[1])
    np.testing.assert_array_equal(c[3], a[2])


def test_variant_from_checkpoint_and_the_refusals(tmp_path):
    (tmp_path / "unet").mkdir()
    (tmp_path / "vae").mkdir()
    (tmp_path / "scheduler").mkdir()
    (tmp_path / "unet" / "config.json").write_text(json.dumps({
        "block_out_channels": [320, 640, 1280, 1280],
        "attention_head_dim": [5, 10, 20, 20], "sample_size": 96}))
    (tmp_path / "vae" / "config.json").write_text(json.dumps({}))
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(
        json.dumps({"prediction_type": "v_prediction"}))
    v = psd.variant_from_checkpoint(tmp_path)
    jv = jsd.variant_from_checkpoint(str(tmp_path))
    assert v.default_size == jv.default_size == 768
    assert v.schedule.prediction_type == "v_prediction"
    assert v.unet.block_out == jv.unet.block_out
    assert v.unet.attn_heads == jv.unet.attn_heads
    for name in ("sd21_base", "sd21", "sd15", "tiny"):
        pv, jv = getattr(psd.SDVariant, name)(), getattr(jsd.SDVariant,
                                                          name)()
        assert (pv.name, pv.default_size) == (jv.name, jv.default_size)
        assert pv.schedule.prediction_type == jv.schedule.prediction_type
        assert pv.unet.attn_heads == jv.unet.attn_heads
    with pytest.raises(ValueError, match="does not download"):
        psd.resolve_checkpoint_dir("stabilityai/stable-diffusion-2-1")
    assert psd.resolve_checkpoint_dir(str(tmp_path)) == str(tmp_path)
    (tmp_path / "unet" / "diffusion_pytorch_model.bin").write_bytes(b"x")
    with pytest.raises(ValueError, match="pickles are not read"):
        psd.load_torch_state(tmp_path / "unet")


# -- the CLIP tokenizer ----------------------------------------------------------

TOKENIZER_CORPUS = (
    "a photo of an astronaut riding a horse on the moon. A painting of a "
    "red fox in the snow, trending on artstation! the quick brown fox jumps "
    "over the lazy dog; it's 2024 and we're rendering 512x512 images at 25 "
    "steps. Café déjà vu 日本語 Привет мир")


def write_clip_tokenizer(path, pad: str, n_merges: int = 200) -> None:
    """A CLIP ``tokenizer/`` directory in SD's layout: the 256 byte
    characters, each with ``</w>``, ``n_merges`` merges learnt on a small
    corpus, the start and end tokens; the pad token in
    ``special_tokens_map.json`` (``!`` as SD2.1's, the end token as
    SD1.x's)."""
    path.mkdir(parents=True, exist_ok=True)
    base = [BYTE_TO_CHAR[b] for b in sorted(BYTE_TO_CHAR)]
    vocab = base + [c + "</w>" for c in base]
    counts = collections.Counter()
    for w in re.findall(r"[^\W\d_]+|\d|[^\w\s]+",
                        (TOKENIZER_CORPUS * 3).lower()):
        chars = [BYTE_TO_CHAR[b] for b in w.encode()]
        counts[tuple(chars[:-1] + [chars[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in counts.items():
            for pair in zip(w, w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append(f"{a} {b}")
        vocab.append(a + b)
        new = collections.Counter()
        for w, n in counts.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += n
        counts = new
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (path / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                     + "\n")

    def added(c):
        return {"__type": "AddedToken", "content": c, "lstrip": False,
                "normalized": True, "rstrip": False, "single_word": False}

    (path / "tokenizer_config.json").write_text(json.dumps({
        "add_prefix_space": False, "bos_token": added("<|startoftext|>"),
        "do_lower_case": True, "eos_token": added("<|endoftext|>"),
        "errors": "replace", "model_max_length": 77,
        "pad_token": "<|endoftext|>", "tokenizer_class": "CLIPTokenizer",
        "unk_token": added("<|endoftext|>")}))
    smap = {k: {key: v for key, v in added(c).items() if key != "__type"}
            for k, c in (("bos_token", "<|startoftext|>"),
                         ("eos_token", "<|endoftext|>"),
                         ("unk_token", "<|endoftext|>"))}
    smap["pad_token"] = pad if pad == "!" else {
        key: v for key, v in added(pad).items() if key != "__type"}
    (path / "special_tokens_map.json").write_text(json.dumps(smap))


def _hf_tokenizer(path):
    """``CLIPTokenizerFast``: the class ``AutoTokenizer`` loads for these
    directories (``tokenizer_class`` ``CLIPTokenizer``, fast by default),
    imported directly: ``AutoTokenizer``'s import also pulls
    ``transformers``' generation stack and scikit-learn, seconds of a test
    worker."""
    from transformers import CLIPTokenizerFast

    config = json.loads((Path(path) / "tokenizer_config.json").read_text())
    assert config["tokenizer_class"] == "CLIPTokenizer"
    return CLIPTokenizerFast.from_pretrained(str(path))


@pytest.fixture(scope="module")
def clip_tokenizers(tmp_path_factory):
    out = {}
    for name, pad in (("sd21", "!"), ("sd15", "<|endoftext|>")):
        path = tmp_path_factory.mktemp(name)
        write_clip_tokenizer(path, pad)
        out[name] = (_hf_tokenizer(path), ClipTokenizer.from_dir(path))
    return out


PROMPTS = {
    "case": "A PHOTO of An Astronaut RIDING a Horse",
    "whitespace": "a  photo\tof\n\nan 　 astronaut   ",
    "contractions": "it's, we're, they'LL, I'd've, don't 'quoted'",
    "digits": "512x512 at 25 steps in 2024, 3.14159",
    "non_latin": "Café déjà vu, 日本語の写真, Привет мир, ñandú, emoji 🚀🚀",
    "punctuation": "hello!! world?! (a) [b] {c} -- ... !",
    "specials": "x <|endoftext|> y<|startoftext|>z",
    "long": " ".join(f"word{i} and more" for i in range(60)),
    "empty": "",
}


@pytest.mark.parametrize("name", ["sd21", "sd15"])
@pytest.mark.parametrize("case", list(PROMPTS))
def test_clip_tokenizer_equals_autotokenizer(clip_tokenizers, name, case):
    """``padding="max_length", truncation=True`` to 77, as the pipelines
    call it: the same ids and mask (SD2.1 pads with ``!``, a special
    token also matched inside a prompt; SD1.x with the end token)."""
    hf, port = clip_tokenizers[name]
    text = PROMPTS[case]
    want = hf(text, padding="max_length", truncation=True, max_length=77)
    got = port(text, padding="max_length", truncation=True, max_length=77)
    assert got["input_ids"] == want["input_ids"]
    assert got["attention_mask"] == want["attention_mask"]
    assert port.pad_token_id == hf.pad_token_id
    assert port.encode(text, add_special_tokens=False) == hf(
        text, add_special_tokens=False)["input_ids"]


@pytest.mark.parametrize("text", [
    "a photo of an astronaut riding a horse on the moon",
    "A painting of a red fox in the snow, trending!", "",
    "highly detailed " * 30])
def test_chip_smoke_clip_tokenizer_equals_autotokenizer(tmp_path, text):
    """``chip_smoke.py``'s synthetic SD2.1 tokenizer directory (CLIP's
    start and end ids 49406 and 49407 past a short vocabulary): the port
    and ``CLIPTokenizerFast`` give the same 77 ids."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    chip_smoke._write_clip_tokenizer(tmp_path / "tokenizer", n_merges=120)
    hf = _hf_tokenizer(tmp_path / "tokenizer")
    port = ClipTokenizer.from_dir(tmp_path / "tokenizer")
    want = hf(text, padding="max_length", truncation=True, max_length=77)
    got = port(text, max_length=77)
    assert got["input_ids"] == want["input_ids"]
    assert got["input_ids"][0] == 49406 and 49407 in got["input_ids"]


# -- the PNG encoder -------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (17, 31), (64, 7), (33, 64)])
def test_png_encoder_reads_back_through_pil_and_decode_png(h, w):
    from PIL import Image

    img = np.random.default_rng(h * 100 + w).integers(
        0, 256, (h, w, 3), dtype=np.uint8)
    img[0, 0] = (0, 255, 128)
    data = imageio.encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(imageio.decode_png(data), img)
    b64 = psd.to_png_base64(img)
    import base64

    assert base64.b64decode(b64) == data
    with pytest.raises(imageio.ImageError, match="uint8"):
        imageio.encode_png(img.astype(np.float32))


# -- B1's plain path at the diffusion shapes -------------------------------------

B1_SHAPES = [
    # (B, T, S, H, D, causal): the UNet's self- and cross-attention heads
    # (5, 10, 20 of 64) with S = 77 cross keys, and CLIP's causal 77
    (2, 64, 64, 5, 64, False),
    (2, 64, 77, 5, 64, False),
    (2, 16, 77, 10, 64, False),
    (2, 4, 77, 20, 64, False),
    (2, 77, 77, 16, 64, True),
]


@pytest.mark.parametrize("B,T,S,H,D,causal", B1_SHAPES)
def test_attention_plain_path_at_diffusion_shapes(B, T, S, H, D, causal):
    """On the CPU ``dot_product_attention`` takes the plain path; it and
    B1's plain version hold the JAX package's ``dot_product_attention``
    (bf16 inputs) by the attention rule, each output vector within
    ``1e-6 + 0.05·rms`` of the JAX one."""
    rng = np.random.default_rng(B * T + S + H)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, T, H, D), (B, S, H, D), (B, S, H, D)))
    want = np.asarray(jattn.dot_product_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        causal=causal).astype(jnp.float32))
    tq, tk, tv = (_t(a).bfloat16() for a in (q, k, v))
    for got in (pattn.dot_product_attention(tq, tk, tv, causal=causal),
                pflash.flash_attention(tq, tk, tv, causal=causal)):
        got = got.float().numpy()
        rms = np.sqrt((want ** 2).mean(-1, keepdims=True))
        assert (np.abs(got - want) <= BF16_ATOL + BF16_RRMS * rms).all()
