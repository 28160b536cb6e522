"""The ``flux`` and ``t5`` units of the port against the JAX package's, on
the CPU: the tiny tiers over sockets, the pipeline on the same latents,
and written FLUX.1 directories.

A JAX pod and a port pod serve each unit's tiny tier with the JAX unit's
parameters carried into the port's (the JAX unit's flax ``init`` replaced
by numpy draws of its tree's shape while it loads,
``test_torch_serve_sd._load_jax_unit``). The port seeds its latents with
torch (ROADMAP C), so the port pipeline's ``init_latents`` hands back the
JAX unit's own draw (``jax.random.normal`` of ``PRNGKey(seed)``). Both VAEs
compute in fp32 here (the JAX unit's is set so before its first decode
compiles), so every stage is fp32 on both sides:

- ``/genimage``: the same fields, the PNG pixels within ``IMAGE_LEVELS``
  uint8 level, the same 400 for a steps value outside the set, no shape
  first run after warmup (the eager pipeline's recompiles);
- the pipeline (``FluxPipeline.txt2img`` on given latents) against the JAX
  pipeline's, two seeds and two guidance values, within ``IMAGE_LEVELS``;
- ``/embed``: the same ``dim``, the embedding within ``EMBED_ATOL``, the
  same 400 for a request without text.

A FLUX.1 directory written here at tiny widths (seeded weights under the
BFL single-file names or the diffusers ``transformer/`` names, a T5 and a
CLIP-L-layout text encoder, a FLUX-style VAE without quant convs, a
scheduler config, a Unigram ``tokenizer_2/`` and a CLIP ``tokenizer/``)
loads into the port's unit: the geometry read off the tensors, schnell
told apart by key, the tensors equal to the written ones, T5's 256 or 512
tokens, the image equal to a pipeline built by hand from the same weights
and tokens; the ``t5`` unit serves its ``text_encoder_2/``, given a
``tokenizer.json`` of its own. The refusals: a hub id, a multi-device
``SUBMESH`` at every unit but ``flux`` and ``MESH_SPEC`` at every unit
that lays no ranks over it (a ``dp`` axis at the others, and several
devices at ``flux``), the tiny tier's heads of 16 on the card.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models import vae as jvae
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.serve import metrics as jmetrics
from scalable_hw_agnostic_inference_tpu.serve.app import (
    create_app as jcreate_app,
)
from scalable_hw_agnostic_inference_tpu.serve.httpd import Server as JServer
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
    save_safetensors,
)
from scalable_hw_agnostic_inference_tpu_torch.models import clip as pclip
from scalable_hw_agnostic_inference_tpu_torch.models import flux as pflux
from scalable_hw_agnostic_inference_tpu_torch.models import t5 as pt5
from scalable_hw_agnostic_inference_tpu_torch.models import vae as pvae
from scalable_hw_agnostic_inference_tpu_torch.models.encoder import (
    seeded_init_,
)
from scalable_hw_agnostic_inference_tpu_torch.models.flux_pipeline import (
    FluxPipeline,
)
from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    ClipTokenizer,
    UnigramTokenizer,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
from scalable_hw_agnostic_inference_tpu_torch.serve.units import (
    flux as uflux,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units.common import (
    unit_layout,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_diffusion import write_clip_tokenizer  # noqa: E402
from test_torch_flux import diffusers_from_bfl  # noqa: E402
from test_torch_serve_sd import (  # noqa: E402
    _http,
    _load_jax_unit,
    _png,
    _wait_ready,
)
from test_torch_unigram import build_spec, write_t5_tokenizer  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

#: the tiny tier's images, port against JAX on the same latents and
#: weights, every stage fp32 on both sides: at most one uint8 level (a
#: value within float rounding of a .5 boundary rounds either way)
IMAGE_LEVELS = 1
#: the tiny T5 unit's mean-pooled embedding, port against JAX, fp32
#: (values of order 1 after the final RMS norm)
EMBED_ATOL = 1e-5
STEPS = 2

TINY = dict(model_id="tiny", device="cpu", num_inference_steps=STEPS)


def _jax_latents(seed, B, h, w, C):
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(int(seed)), (B, h, w, C), jnp.float32)))


def _carry_flux(jservice, drawn, service):
    """The JAX flux unit's weights into the port's unit (the VAE fp32 on
    both sides), and the port's latents from the JAX draw."""
    jpipe = jservice.pipe
    jpipe.vae = jvae.AutoencoderKL(jpipe.vae.cfg, dtype=jnp.float32)
    model = pflux.build(pflux.FluxConfig.tiny(), pflux.params_from_jax(
        drawn["FluxTransformer"]), dtype=torch.float32)
    t5m = pt5.build(pt5.T5Config.tiny(),
                    pt5.params_from_jax(drawn["T5Encoder"]))
    clipm = pclip.build(pclip.ClipTextConfig.tiny(),
                        pclip.params_from_jax(drawn["ClipTextEncoder"]))
    vae = pvae.build(pvae.VAEConfig.tiny(),
                     pvae.params_from_jax(jservice.pipe.vae_params),
                     dtype=torch.float32)
    pipe = FluxPipeline(model, vae, pt5.encode_fn(t5m),
                        pclip.pooled_fn(clipm))
    pipe.init_latents = lambda rng, B, h, w: _jax_latents(
        rng, B, h, w, pipe.latent_ch)
    service.pipe = pipe


def _serve(jcfg, jservice, cfg, service):
    jpub = jmetrics.MetricsPublisher(jcfg.app, jcfg.nodepool, jcfg.pod_name,
                                     emit_json=False)
    jsrv = JServer(jcreate_app(jcfg, jservice, publisher=jpub),
                   host="127.0.0.1", port=0)
    tsrv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    jh, jp = jsrv.start_background()
    th, tp = tsrv.start_background()
    return jsrv, tsrv, f"http://{jh}:{jp}", f"http://{th}:{tp}"


@pytest.fixture(scope="module")
def flux_pods():
    """A JAX pod and a port pod on the flux unit's tiny tier (the JAX
    transformer on one device), the port's carrying the JAX unit's
    weights."""
    jcfg = JServeConfig(app="flux", submesh="0:1", **TINY)
    jservice = get_model("flux")(jcfg)
    drawn = _load_jax_unit(jservice)
    jservice.load = lambda: None
    cfg = ServeConfig(app="flux", **TINY)
    service = UNITS["flux"](cfg)
    service.load()
    _carry_flux(jservice, drawn, service)
    service.load = lambda: None
    jsrv, tsrv, ref, port = _serve(jcfg, jservice, cfg, service)
    try:
        _wait_ready(ref)
        _wait_ready(port)
        yield ref, port, jservice, service
    finally:
        tsrv.stop()
        jsrv.stop()


def _diff(a, b):
    return np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32)).max()


def test_genimage_equals_the_jax_unit(flux_pods):
    ref, port, jservice, service = flux_pods
    payload = {"prompt": "a watercolor fox", "steps": STEPS, "seed": 3,
               "guidance_scale": 3.5}
    jstatus, jbody = _http(ref + "/genimage", payload)
    status, body = _http(port + "/genimage", payload)
    assert jstatus == status == 200, body
    assert set(body) == set(jbody)
    for k in ("steps", "height", "width"):
        assert body[k] == jbody[k]
    got, want = _png(body), _png(jbody)
    assert got.shape == want.shape == (32, 32, 3)
    assert _diff(got, want) <= IMAGE_LEVELS
    for url in (ref, port):
        status, err = _http(url + "/genimage", {"prompt": "x", "steps": 3})
        assert status == 400 and "STEPS_BUCKETS" in json.dumps(err)
    assert service.recompiles() == 0


@pytest.mark.parametrize("seed,guidance", [(0, 3.5), (11, 1.0)])
def test_pipeline_equals_the_jax_pipeline_on_the_same_latents(
        flux_pods, seed, guidance):
    """The pipelines on the same token ids and latents (the JAX one's own
    draw), through the JAX pipeline's compiled executables."""
    _, _, jservice, service = flux_pods
    rng = np.random.default_rng(seed)
    t5_ids = rng.integers(0, 256, (1, service.t5_len)).astype(np.int32)
    clip_ids = rng.integers(0, 127, (1, service.clip_len)).astype(np.int32)
    want = jservice.pipe.txt2img(
        jnp.asarray(t5_ids), jnp.asarray(clip_ids),
        rng=jax.random.PRNGKey(seed), height=32, width=32, steps=STEPS,
        guidance=guidance)
    pipe = service.pipe
    lat = _jax_latents(seed, 1, 16, 16, pipe.latent_ch)
    got = pipe.txt2img(t5_ids, clip_ids, height=32, width=32, steps=STEPS,
                       guidance=guidance, latents=lat)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert _diff(got, want) <= IMAGE_LEVELS


@pytest.fixture(scope="module")
def t5_pods():
    jcfg = JServeConfig(app="t5", model_id="tiny", device="cpu")
    jservice = get_model("t5")(jcfg)
    drawn = _load_jax_unit(jservice)
    jservice.load = lambda: None
    cfg = ServeConfig(app="t5", model_id="tiny", device="cpu")
    service = UNITS["t5"](cfg)
    service.load()
    service.model = pt5.build(pt5.T5Config.tiny(),
                              pt5.params_from_jax(drawn["T5Encoder"]))
    service.load = lambda: None
    jsrv, tsrv, ref, port = _serve(jcfg, jservice, cfg, service)
    try:
        _wait_ready(ref)
        _wait_ready(port)
        yield ref, port
    finally:
        tsrv.stop()
        jsrv.stop()


def test_embed_equals_the_jax_unit(t5_pods):
    ref, port = t5_pods
    for text in ("hello embeddings", "something else entirely, longer",
                 ""):
        jstatus, jbody = _http(ref + "/embed", {"text": text})
        status, body = _http(port + "/embed", {"text": text})
        assert jstatus == status == 200
        assert body["dim"] == jbody["dim"] == 32
        np.testing.assert_allclose(body["embedding"], jbody["embedding"],
                                   rtol=0, atol=EMBED_ATOL)
    for url in (ref, port):
        assert _http(url + "/embed", {})[0] == 400


# -- a written FLUX.1 directory -----------------------------------------------

def write_flux_dir(path: Path, layout: str, guidance: bool):
    """A FLUX.1 snapshot at tiny widths; returns the seeded modules."""
    fcfg = dataclasses.replace(pflux.FluxConfig.tiny(),
                               guidance_embed=guidance)
    tr = pflux.seeded(fcfg, 1, dtype=torch.float32, device="cpu")
    names = pflux.bfl_names(fcfg)
    bfl = {names[k]: v.to(torch.bfloat16) for k, v in
           tr.state_dict().items()}
    path.mkdir(parents=True)
    if layout == "bfl":
        save_safetensors(bfl, path / "flux1-dev.safetensors")
    else:
        (path / "transformer").mkdir()
        save_safetensors(diffusers_from_bfl(bfl, fcfg), path / "transformer"
                         / "diffusion_pytorch_model.safetensors")
    spec = build_spec(np.random.default_rng(0), True, False)
    tcfg = dataclasses.replace(pt5.T5Config.tiny(),
                               vocab_size=len(spec["model"]["vocab"]))
    t5m = seeded_init_(pt5.T5Encoder(tcfg, device="cpu"), 2)
    tnames = pt5.hf_names(tcfg, {"shared.weight", "encoder.x"})
    (path / "text_encoder_2").mkdir()
    save_safetensors({tnames[k]: v for k, v in t5m.state_dict().items()},
                     path / "text_encoder_2" / "model.safetensors")
    (path / "text_encoder_2" / "config.json").write_text(json.dumps({
        "vocab_size": tcfg.vocab_size, "d_model": 32, "d_kv": 8,
        "num_heads": 4, "d_ff": 64, "num_layers": 2,
        "relative_attention_num_buckets": 8,
        "relative_attention_max_distance": 16, "layer_norm_epsilon": 1e-6,
        "feed_forward_proj": "gated-gelu"}))
    ccfg = dataclasses.replace(pclip.ClipTextConfig.tiny(), vocab_size=49408,
                               max_position=77, act="quick_gelu")
    clipm = seeded_init_(pclip.ClipTextEncoder(ccfg, device="cpu"), 3)
    cnames = pclip.hf_names(ccfg)
    (path / "text_encoder").mkdir()
    save_safetensors({cnames[k]: v for k, v in clipm.state_dict().items()},
                     path / "text_encoder" / "model.safetensors")
    (path / "text_encoder" / "config.json").write_text(json.dumps({
        "vocab_size": 49408, "max_position_embeddings": 77,
        "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 64, "hidden_act": "quick_gelu",
        "layer_norm_eps": 1e-5}))
    vcfg = dataclasses.replace(pvae.VAEConfig.tiny(), scaling_factor=0.3611,
                               shift_factor=0.1159, use_quant_conv=False)
    va = seeded_init_(pvae.AutoencoderKL(vcfg, device="cpu", encoder=False),
                      4)
    vnames = pvae.diffusers_names(vcfg, {"decoder.mid_block.attentions.0."
                                         "to_q.weight"})
    (path / "vae").mkdir()
    save_safetensors({vnames[k]: v for k, v in va.state_dict().items()},
                     path / "vae" / "diffusion_pytorch_model.safetensors")
    (path / "vae" / "config.json").write_text(json.dumps({
        "latent_channels": 4, "block_out_channels": [8, 16],
        "layers_per_block": 1, "norm_num_groups": 4,
        "scaling_factor": 0.3611, "shift_factor": 0.1159,
        "use_quant_conv": False, "use_post_quant_conv": False}))
    (path / "scheduler").mkdir()
    (path / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 3.0,
        "use_dynamic_shifting": guidance, "base_image_seq_len": 256,
        "max_image_seq_len": 4096}))
    write_t5_tokenizer(path / "tokenizer_2", spec)
    # a T5 directory holds its own tokenizer.json, as the t5 unit reads it
    write_t5_tokenizer(path / "text_encoder_2", spec)
    write_clip_tokenizer(path / "tokenizer", pad="<|endoftext|>")
    return fcfg, bfl, t5m, clipm, va


@pytest.mark.parametrize("layout,guidance", [("bfl", False),
                                             ("diffusers", True)],
                         ids=["bfl-schnell", "diffusers-dev"])
def test_flux_directory_loads_and_serves(tmp_path, layout, guidance):
    path = tmp_path / "flux"
    fcfg, bfl, t5m, clipm, va = write_flux_dir(path, layout, guidance)
    cfg = ServeConfig(app="flux", model_id=str(path), device="cpu",
                      num_inference_steps=STEPS, height=16, width=16)
    unit = UNITS["flux"](cfg)
    unit.load()
    pipe = unit.pipe
    assert pipe.model.cfg == fcfg and pipe.model.dtype == torch.bfloat16
    names = pflux.bfl_names(fcfg)
    for k, v in pipe.model.state_dict().items():
        torch.testing.assert_close(v, bfl[names[k]], rtol=0, atol=0)
    assert isinstance(unit.t5_tok, UnigramTokenizer)
    assert isinstance(unit.clip_tok, ClipTokenizer)
    assert unit.t5_len == (512 if guidance else 256)
    assert pipe.scheduler.cfg.shift == 3.0
    assert pipe.scheduler.cfg.use_dynamic_shifting == guidance
    unit.warmup()
    out = unit.infer({"prompt": "a cat sitting on a window", "seed": 5})
    assert (out["height"], out["width"], out["steps"]) == (16, 16, STEPS)
    # the same image from a pipeline built by hand from the written
    # tensors and the directory's tokenizers
    hand = FluxPipeline(
        pflux.build(fcfg, {k: bfl[names[k]] for k in names}),
        pvae.build(va.cfg, va.state_dict()),
        pt5.encode_fn(pt5.build(t5m.cfg, {
            k: v.bfloat16() for k, v in t5m.state_dict().items()},
            dtype=torch.bfloat16)),
        pclip.pooled_fn(clipm), schedule=pipe.scheduler.cfg)
    t5_ids = unit.t5_tok("a cat sitting on a window", max_length=unit.t5_len)
    clip_ids = unit.clip_tok("a cat sitting on a window", max_length=77)
    want = hand.txt2img(np.array([t5_ids["input_ids"]]),
                        np.array([clip_ids["input_ids"]]), rng=5,
                        height=16, width=16, steps=STEPS, guidance=7.5)[0]
    np.testing.assert_array_equal(_png(out), want)
    assert unit.recompiles() == 0

    # the t5 unit on the snapshot's text encoder and its tokenizer.json
    t5u = UNITS["t5"](ServeConfig(app="t5", device="cpu", model_id=str(
        path / "text_encoder_2"), max_seq_len=24))
    t5u.load()
    assert isinstance(t5u.tokenizer, UnigramTokenizer) and t5u.seq == 24
    emb = t5u.infer({"text": "a red fox"})
    enc = t5u.tokenizer("a red fox", max_length=24)
    ids = torch.tensor([enc["input_ids"]])
    mask = torch.tensor([enc["attention_mask"]])
    with torch.inference_mode():
        ref = pt5.mean_pool(t5u.model(ids, mask), mask)[0]
    assert emb["dim"] == 32
    np.testing.assert_array_equal(np.float32(emb["embedding"]), ref.numpy())


@pytest.mark.parametrize("spec", [{"submesh": "0:4"}, {"mesh_spec": "tp=2"},
                                  {"mesh_spec": "dp=2,tp=4"}],
                         ids=["submesh", "mesh_tp", "mesh_dp_tp"])
@pytest.mark.parametrize("name", sorted(UNITS))
def test_every_unit_refuses_several_devices(name, spec):
    """Several devices where a unit does not lay its ranks over them are
    refused, naming ROADMAP A7.3c: a ``SUBMESH`` naming several at every
    unit but ``flux``, and ``MESH_SPEC`` over several at every unit that
    lays out no ranks. The units whose ranks ``MESH_SPEC`` lays out
    (``llama``, ``mistral``, ``deepseek``, ``t5``) lay ``tp=2`` out (and,
    loaded outside ``serve_multihost``, with no group, refuse it naming
    it) and refuse a ``dp`` axis; ``flux`` lays ``SUBMESH=0:4`` out the
    same way and refuses ``MESH_SPEC`` over several devices, which the
    reference's unit does not read."""
    cfg = ServeConfig(app=name, **{**TINY, **spec})
    unit = UNITS[name](cfg)
    over = unit.ranks_over or ("MESH_SPEC" if unit.supports_multihost
                               else None)
    knob = "mesh_spec" if "mesh_spec" in spec else "submesh"
    if over == knob.upper() and spec.get("mesh_spec") != "dp=2,tp=4":
        layout = unit_layout(cfg, unit.supports_multihost, ranks_over=over)
        assert layout[1].tp == (4 if knob == "submesh" else 2)
        match = "serve_multihost"
    elif over == "MESH_SPEC" and knob == "mesh_spec":
        match = "tensor parallelism only.*'dp'"
    elif over == "SUBMESH" and knob == "mesh_spec":
        match = "MESH_SPEC=.* names several devices.*SUBMESH"
    else:
        match = "names [248] devices.*tensor parallelism.*A7.3c"
    with pytest.raises(ValueError, match=match):
        unit.load()


def test_refusals():
    one = UNITS["t5"](ServeConfig(app="t5", device="cpu", model_id="tiny",
                                  submesh="0:1", mesh_spec="tp=1"))
    one.load()
    assert one.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not download"):
        UNITS["flux"](ServeConfig(app="flux", device="cpu",
                                  model_id="black-forest-labs/FLUX.1-dev"
                                  )).load()
    with pytest.raises(ValueError, match=r"heads of size \[16\]"):
        uflux.check_head_dims(pflux.FluxConfig.tiny(),
                              pclip.ClipTextConfig.tiny(),
                              torch.device("cuda", 0))
    uflux.check_head_dims(pflux.FluxConfig(), pclip.ClipTextConfig(
        dim=768, heads=12), torch.device("cuda", 0))
