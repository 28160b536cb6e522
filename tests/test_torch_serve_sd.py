"""The ``sd``/``sd2`` unit of the port against the JAX package's, on the
CPU: the tiny tier over sockets, the coalescer, a local diffusers
directory.

A JAX pod and a port pod serve ``POST /genimage`` on the tiny tier with
the JAX unit's parameters carried into the port's, and the port's
``init_latents`` handing back the JAX unit's draws (the port seeds its
latents with torch, ROADMAP C): the same response fields, images within
``IMAGE_MEAN``/``IMAGE_MAX`` levels, the same 400. The coalescer's cases
of the reference's ``tests/test_serve_sd.py`` (identity membership, the
leader's own entry, the pow2 clamp, batch 1 warmed, composition
invariance) run on the port's unit; ``extra_stats`` equals the JAX
unit's after the same batches. A seeded tiny diffusers directory (the
port's own writer of safetensors, a CLIP tokenizer) loads into the unit
with ``MODEL_ID=<dir>``, tensor for tensor.

The JAX unit's ``load`` initializes its flax modules eagerly (tens of
seconds on the CPU, several even under ``jax.jit``); while it loads, the
fixture has each ``Module.init`` return its tree's shape filled with numpy
draws (``test_torch_diffusion._randomize``) and keeps them, and the rest
of the JAX unit's ``load`` runs as it is.
"""

import base64
import concurrent.futures
import dataclasses
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

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
from scalable_hw_agnostic_inference_tpu_torch.models import imageio
from scalable_hw_agnostic_inference_tpu_torch.models import sd as psd
from scalable_hw_agnostic_inference_tpu_torch.models import unet as punet
from scalable_hw_agnostic_inference_tpu_torch.models import vae as pvae
from scalable_hw_agnostic_inference_tpu_torch.models.encoder import (
    seeded_init_,
)
from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    ClipTokenizer,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
from scalable_hw_agnostic_inference_tpu_torch.serve.units import sd as usd
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_diffusion import (  # noqa: E402
    _randomize,
    write_clip_tokenizer,
)
from torch_threads import one_torch_thread  # noqa: E402,F401

#: the tiny tier's images, port against JAX on the same latents and
#: weights, 2 DDIM steps at guidance 7.5, bf16 UNet and VAE on both sides
#: (levels of 255): measured at 32 px mean 1.99, max 14 for this request
#: (at 64 px 1.91, 17; a batch-2 image against the same request alone on
#: the port: 0, 0 at 32 px, 1.01, 8 at 64 px); the pipeline tests' bf16
#: bound (``test_torch_diffusion.PIPE_BF16_*``)
IMAGE_MEAN, IMAGE_MAX = 4.0, 32
#: the pods' and the unit tests' image side: the tiny tier's 64 px default
#: holds 1,024 latent tokens, whose attention costs a CPU test worker
#: about a second a batch; 32 px (256 tokens) and 16 px keep every path
POD_SIZE, UNIT_SIZE = 32, 16

TINY = dict(app="sd21", model_id="tiny", device="cpu",
            num_inference_steps=2, batch_size=1)



def _http(url, payload=None, timeout=120.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _wait_ready(base, timeout=240.0):
    deadline = time.monotonic() + timeout
    while _http(base + "/readiness")[0] != 200:
        assert time.monotonic() < deadline, f"{base} never became ready"
        time.sleep(0.05)


def _load_jax_unit(jservice):
    """The JAX unit's ``load`` with every flax ``Module.init`` returning
    numpy draws of its tree's shape; returns the trees by module class."""
    orig = fnn.Module.init
    drawn = {}

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda r, *a: orig(self, r, *a, **kw),
                                rngs, *args)
        drawn[type(self).__name__] = _randomize(shapes, len(drawn))
        return drawn[type(self).__name__]

    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Module, "init", init)
    try:
        jservice.load()
    finally:
        mp.undo()
    return drawn


def _carry(jax_unit, drawn, port_unit):
    """The JAX unit's weights into the port's unit, and the port's
    latents from the JAX unit's ``init_latents``."""
    tm = pclip.build(pclip.ClipTextConfig.tiny(),
                     pclip.params_from_jax(drawn["ClipTextEncoder"]))
    variant = port_unit.variant
    unet = punet.build(variant.unet,
                       punet.params_from_jax(jax_unit.pipe.unet_params))
    vae = pvae.build(variant.vae,
                     pvae.params_from_jax(jax_unit.pipe.vae_params))
    pipe = psd.StableDiffusion(variant, unet, vae, pclip.encode_fn(tm),
                               scheduler=port_unit.cfg.scheduler)

    def init_latents(s, h, w, steps):
        return torch.from_numpy(np.array(
            jax_unit.pipe.init_latents(s, h, w, steps)))

    pipe.init_latents = init_latents
    port_unit.pipe, port_unit.text_model = pipe, tm


@pytest.fixture(scope="module")
def pods():
    """A JAX pod and a port pod on the tiny tier (``SD_BATCH_MAX=2``, so
    every request takes the coalescer's latents), the port's carrying the
    JAX unit's weights."""
    jcfg = JServeConfig(**TINY, sd_batch_max=2, warmup=False)
    jservice = get_model("sd")(jcfg)
    drawn = _load_jax_unit(jservice)
    jservice.load = lambda: None
    cfg = ServeConfig(**TINY, sd_batch_max=2, warmup=False)
    service = UNITS["sd2"](cfg)
    service.load()
    _carry(jservice, drawn, service)
    service.load = lambda: None
    for unit in (jservice, service):
        unit.height = unit.width = POD_SIZE
    jpub = jmetrics.MetricsPublisher(jcfg.app, jcfg.nodepool, jcfg.pod_name,
                                     emit_json=False)
    jsrv = JServer(jcreate_app(jcfg, jservice, publisher=jpub),
                   host="127.0.0.1", port=0)
    tsrv = Server(create_app(cfg, service), host="127.0.0.1", port=0)
    jh, jp = jsrv.start_background()
    th, tp = tsrv.start_background()
    ref, port = f"http://{jh}:{jp}", f"http://{th}:{tp}"
    try:
        _wait_ready(ref)
        _wait_ready(port)
        yield ref, port, jservice, service
    finally:
        tsrv.stop()
        jsrv.stop()


def _png(body):
    from PIL import Image

    data = base64.b64decode(body["image_b64"])
    img = imageio.decode_png(data)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    return img


def test_genimage_equals_the_jax_unit(pods):
    """The same fields; the images within ``IMAGE_*`` levels; the same
    400 for a steps value outside the set; the unit's gauges on
    ``/stats`` under the reference's names."""
    ref, port, jservice, service = pods
    payload = {"prompt": "a red square", "steps": 2, "seed": 7}
    jstatus, jbody = _http(ref + "/genimage", payload)
    status, body = _http(port + "/genimage", payload)
    assert jstatus == status == 200, body
    assert set(body) == set(jbody)
    for k in ("steps", "height", "width"):
        assert body[k] == jbody[k]
    np.testing.assert_array_equal(service._tokenize("a red square"),
                                  jservice._tokenize("a red square"))
    got, want = _png(body), _png(jbody)
    assert got.shape == want.shape == (POD_SIZE, POD_SIZE, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() <= IMAGE_MEAN and diff.max() <= IMAGE_MAX, (
        diff.mean(), diff.max())
    for url in (ref, port):
        status, err = _http(url + "/genimage", {"prompt": "x", "steps": 3})
        assert status == 400 and "STEPS_BUCKETS" in json.dumps(err)
    jstats = _http(ref + "/stats")[1]["service"]
    stats = _http(port + "/stats")[1]["service"]
    assert set(stats) == set(jstats)
    assert stats["coalesced_requests"] == jstats["coalesced_requests"] == 1


def test_concurrent_requests_coalesce(pods):
    """Four concurrent requests on the port pod (``SD_BATCH_MAX=2``): all
    answer with PNGs, in batches of at most 2, and a request's image is
    the one it gets alone within ``IMAGE_*`` (another batch bucket rounds
    its bf16 products in another order: bit equality is not promised
    across buckets, as the reference's is not)."""
    _, port, _, service = pods
    before = service.extra_stats()
    payloads = [{"prompt": f"a cat #{i}", "seed": i} for i in range(4)]
    # a window no busy test host outlasts between two client threads
    service._coalesce_window_s = 0.5
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda p: _http(port + "/genimage", p),
                               payloads))
    finally:
        service._coalesce_window_s = 0.02
    for status, body in outs:
        assert status == 200
        assert base64.b64decode(body["image_b64"])[:4] == b"\x89PNG"
    after = service.extra_stats()
    assert after["coalesced_requests"] - before["coalesced_requests"] == 4
    assert after["coalesced_batches"] - before["coalesced_batches"] == 2
    assert after["coalesce_occupancy"] >= 1.0
    alone = _png(_http(port + "/genimage", payloads[2])[1])
    diff = np.abs(alone.astype(int) - _png(outs[2][1]).astype(int))
    assert diff.mean() <= IMAGE_MEAN and diff.max() <= IMAGE_MAX


def _unit(**kw):
    return UNITS["sd"](ServeConfig(**dict(TINY, **kw)))


def _item(i):
    return {"ids": np.zeros((1, 8), np.int32),
            "uncond": np.zeros((1, 8), np.int32), "seed": i}


def test_coalescer_membership_is_by_identity():
    """Three staggered same-key requests, cap 2: one pair batches, the
    straggler leads its own batch, and no membership probe compares numpy
    arrays by value."""
    s = _unit(sd_batch_max=2)
    s._coalesce_window_s = 0.15
    ran, results, errors = [], [], []

    def fake_run_batch(items, steps, guidance):
        ran.append(len(items))
        return np.zeros((len(items), 4, 4, 3), np.uint8)

    s._run_batch = fake_run_batch

    def one(i, delay):
        time.sleep(delay)
        try:
            results.append(s._coalesced(_item(i), 2, 7.5))
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=one, args=(i, d))
          for i, d in enumerate((0.0, 0.05, 0.1))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errors, errors
    assert len(results) == 3
    assert sum(ran) == 3 and max(ran) <= 2


def test_coalescer_leader_takes_its_own_entry():
    """Two foreign entries already pending past the cap: the leader's
    batch holds its own entry and one of them; the other stays."""
    s = _unit(sd_batch_max=2)
    s._coalesce_window_s = 0.0
    ran = []

    def fake_run_batch(items, steps, guidance):
        ran.append([i["seed"] for i in items])
        return np.zeros((len(items), 4, 4, 3), np.uint8)

    s._run_batch = fake_run_batch
    foreign = []
    for i in (100, 101):
        f = concurrent.futures.Future()
        s._pending.append(((2, 7.5), _item(i), f))
        foreign.append(f)
    assert s._coalesced(_item(7), 2, 7.5) is not None
    assert any(7 in batch for batch in ran)
    assert sum(f.done() for f in foreign) == 1
    assert len(s._pending) == 1


@pytest.mark.parametrize("raw,want", [(1, 1), (2, 2), (3, 2), (6, 4),
                                      (8, 8)])
def test_batch_max_clamps_to_pow2_as_the_jax_unit(raw, want):
    s = _unit(sd_batch_max=raw)
    j = get_model("sd")(JServeConfig(**TINY, sd_batch_max=raw))
    assert s._batch_max == j._batch_max == want
    assert s.concurrency == j.concurrency == want


def _record_batches(unit):
    """Wrap the unit's ``pipe.txt2img_batch``: the ``(B, steps)`` of every
    run, in order."""
    runs, inner = [], unit.pipe.txt2img_batch

    def rec(ids, un, lat, **kw):
        runs.append((lat.shape[0], kw["steps"]))
        return inner(ids, un, lat, **kw)

    unit.pipe.txt2img_batch = rec
    return runs


def test_warmup_runs_batch_one_and_every_bucket():
    """With ``SD_BATCH_MAX>1`` every request runs ``txt2img_batch``, so
    warmup runs batch 1 too, each bucket once and ``WARM_STEPS`` long; a
    solo request after it meets no new batch size. Without coalescing
    warmup runs batch 1 alone, and every allowed steps value's tables are
    on the device."""
    s = _unit(sd_batch_max=2)
    s.load()
    s.height = s.width = UNIT_SIZE
    runs = _record_batches(s)
    s.warmup()
    assert runs == [(1, usd.WARM_STEPS), (2, usd.WARM_STEPS)]
    s._coalesce_window_s = 0.0
    s.infer({"prompt": "a solo request", "seed": 3})
    assert runs[-1][0] == 1 and len(runs) == 3
    one = _unit(steps_buckets="1,3")
    one.load()
    one.height = one.width = UNIT_SIZE
    runs = _record_batches(one)
    one.warmup()
    assert one.steps_allowed == {1, 2, 3}
    assert runs == [(1, usd.WARM_STEPS)]
    assert set(one.pipe._tables) == {1, 2, 3}
    assert one.extra_stats() == {}


def test_extra_stats_equal_the_jax_unit():
    """The same batches through both units' bookkeeping (their denoise
    stubbed): the same gauges."""
    s, j = _unit(sd_batch_max=4), get_model("sd")(
        JServeConfig(**TINY, sd_batch_max=4))
    for unit in (s, j):
        unit._coalesce_window_s = 0.0
        unit.pipe = type("Pipe", (), {"vae_scale": 2})()
        unit.height = unit.width = 16
    s.pipe.init_latents = lambda *a: torch.zeros((1, 8, 8, 4))
    s.pipe.txt2img_batch = lambda ids, *a, **k: np.zeros(
        (len(ids), 16, 16, 3), np.uint8)
    j.pipe.init_latents = lambda *a: jnp.zeros((1, 8, 8, 4))
    j.pipe.txt2img_batch = lambda ids, *a, **k: np.zeros(
        (len(ids), 16, 16, 3), np.uint8)
    for n in (1, 3, 4, 2):
        for unit in (s, j):
            unit._run_batch([_item(i) for i in range(n)], 2, 7.5)
    assert s.extra_stats() == j.extra_stats()
    assert s.extra_stats()["coalesced_requests"] == 10.0


def test_batch_output_is_composition_invariant():
    """The reference's case: in one bucket a request's image depends on
    its seed and prompt only, whatever shares its batch (a padded batch
    of 3 too)."""
    s = _unit(sd_batch_max=4)
    s.load()
    s.height = s.width = UNIT_SIZE

    def it(i, prompt=None):
        return {"ids": s._tokenize(prompt or f"a cat #{i}"),
                "uncond": s._tokenize(""), "seed": i}

    a = s._run_batch([it(1), it(0), it(2), it(3)], 2, 7.5)
    b = s._run_batch([it(3), it(2), it(0), it(1)], 2, 7.5)
    np.testing.assert_array_equal(a[0], b[3])
    np.testing.assert_array_equal(a[1], b[2])
    np.testing.assert_array_equal(a[3], b[0])
    c = s._run_batch([it(1), it(7, "a dog"), it(8, "x y z"), it(9, "?")],
                     2, 7.5)
    np.testing.assert_array_equal(a[0], c[0])
    d = s._run_batch([it(1), it(0), it(2)], 2, 7.5)
    assert len(d) == 3
    np.testing.assert_array_equal(a[0], d[0])


def _write_diffusers_dir(root: Path, seed: int = 0):
    """A tiny diffusers directory from seeded port modules: the UNet,
    VAE and CLIP text encoder under diffusers' and HF's names in
    safetensors, their configs, a CLIP tokenizer (SD2.1's ``!`` pad), the
    scheduler's config. Returns the written states."""
    unet = seeded_init_(punet.UNet2DCondition(punet.UNetConfig.tiny(),
                                              device="cpu"), seed)
    vae = seeded_init_(pvae.AutoencoderKL(pvae.VAEConfig.tiny(),
                                          device="cpu"), seed + 1)
    write_clip_tokenizer(root / "tokenizer", "!", n_merges=60)
    n_vocab = len(json.loads((root / "tokenizer" / "vocab.json").read_text()))
    ccfg = dataclasses.replace(pclip.ClipTextConfig.tiny(),
                               vocab_size=n_vocab)
    text = seeded_init_(pclip.ClipTextEncoder(ccfg, device="cpu"), seed + 2)
    vnames = pvae.diffusers_names(pvae.VAEConfig.tiny(), {
        "encoder.conv_in.weight", "decoder.mid_block.attentions.0.to_q"
        ".weight", "encoder.mid_block.attentions.0.to_q.weight"})
    cnames = pclip.hf_names(ccfg)
    written = {"unet": unet.state_dict(), "vae": vae.state_dict(),
               "text_encoder": text.state_dict()}
    names = {"unet": punet.diffusers_name, "vae": vnames.__getitem__,
             "text_encoder": cnames.__getitem__}
    files = {"unet": "diffusion_pytorch_model.safetensors",
             "vae": "diffusion_pytorch_model.safetensors",
             "text_encoder": "model.safetensors"}
    for comp, state in written.items():
        (root / comp).mkdir(parents=True)
        out = {}
        for k, t in state.items():
            t = t.detach().contiguous()
            if comp == "vae" and k.startswith(("post_quant", "quant")) \
                    and t.ndim == 2:
                t = t[:, :, None, None]
            out[names[comp](k)] = t
        save_safetensors(out, root / comp / files[comp])
    u = punet.UNetConfig.tiny()
    (root / "unet" / "config.json").write_text(json.dumps({
        "block_out_channels": list(u.block_out), "layers_per_block": 1,
        "attention_head_dim": list(u.attn_heads),
        "cross_attention_dim": u.cross_attention_dim, "norm_num_groups": 4,
        "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
        "sample_size": 8}))
    (root / "vae" / "config.json").write_text(json.dumps({
        "block_out_channels": [8, 16], "layers_per_block": 1,
        "norm_num_groups": 4, "scaling_factor": 0.18215}))
    (root / "text_encoder" / "config.json").write_text(json.dumps({
        "vocab_size": ccfg.vocab_size, "max_position_embeddings": 16,
        "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
        "intermediate_size": 64, "layer_norm_eps": 1e-5,
        "hidden_act": "gelu"}))
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "prediction_type": "v_prediction", "steps_offset": 1}))
    (root / "model_index.json").write_text(json.dumps({
        "_class_name": "StableDiffusionPipeline"}))
    return written


def test_unit_loads_a_diffusers_directory(tmp_path):
    """``MODEL_ID=<dir>``: every tensor as written (the UNet in bf16, the
    VAE and text encoder fp32), the CLIP tokenizer, the directory's
    v-prediction schedule, HEIGHT/WIDTH; a PNG answer. A hub id, and on
    the card a head size outside B1's, are refused naming why."""
    written = _write_diffusers_dir(tmp_path / "sd")
    cfg = ServeConfig(app="sd2", model_id=str(tmp_path / "sd"), device="cpu",
                      num_inference_steps=2, height=32, width=32)
    s = UNITS["sd2"](cfg)
    s.load()
    for name, t in s.pipe.unet.state_dict().items():
        assert t.dtype == torch.bfloat16
        torch.testing.assert_close(t, written["unet"][name].bfloat16(),
                                   rtol=0, atol=0)
    for name, t in s.pipe.vae.state_dict().items():
        torch.testing.assert_close(t, written["vae"][name], rtol=0, atol=0)
    for name, t in s.text_model.state_dict().items():
        torch.testing.assert_close(t, written["text_encoder"][name], rtol=0,
                                   atol=0)
    assert isinstance(s.tokenizer, ClipTokenizer)
    assert s.seq_len == 16 and s.tokenizer.pad_token_id == 33
    assert s.pipe.variant.schedule.prediction_type == "v_prediction"
    s.warmup()
    body = s.infer({"prompt": "a photo of a fox!", "seed": 1})
    assert (body["height"], body["width"]) == (32, 32)
    assert _png(body).shape == (32, 32, 3)
    with pytest.raises(ValueError, match="does not download"):
        UNITS["sd2"](ServeConfig(app="sd2", model_id="stabilityai/"
                                 "stable-diffusion-2-1", device="cpu")).load()
    with pytest.raises(ValueError, match=r"heads of size \[40, 80, 160\]"):
        usd.check_head_dims(psd.SDVariant.sd15(), pclip.ClipTextConfig(),
                            torch.device("cuda"))
    usd.check_head_dims(psd.SDVariant.sd21(), pclip.ClipTextConfig(),
                        torch.device("cuda"))
    with pytest.raises(ValueError, match="HEIGHT and WIDTH"):
        ServeConfig(height=500).validate()


def test_unit_raises_without_cuda_unless_given_the_cpu(monkeypatch):
    """``DEVICE`` defaults to the card: without CUDA the unit's load
    raises; ``DEVICE=cpu`` loads on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = UNITS["sd"](ServeConfig(app="sd", model_id="tiny"))
    assert s.cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        s.load()
    cpu = _unit()
    cpu.load()
    assert cpu.pipe.device.type == "cpu"
    assert cpu.pipe.unet.dtype == torch.bfloat16
