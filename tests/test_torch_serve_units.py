"""The six units this port adds for the names the JAX package registers
(``llama``, ``mistral``, ``deepseek``, ``bert``, ``vit``, ``yolo``) against
the JAX units, on the CPU.

A JAX pod and a port pod serve each unit's tiny tier over sockets, the
port's carrying the JAX unit's weights (its flax ``init`` replaced by
numpy draws of the tree's shape, ``test_torch_serve_sd._load_jax_unit``):

- ``bert`` ``/predict``, ``vit`` ``/classify``, ``yolo`` ``/detectobj``
  (thresholds 0 and 0.3): the same labels and fields, scores, logits and
  box corners equal up to the responses' own rounding (``ROUND_*``: one
  unit of the last decimal the reference rounds to);
- ``llama`` (and ``mistral``, ``deepseek`` under ``QUANTIZATION=int8``)
  ``/generate`` greedy: the same ``generated_text`` and ``n_tokens``;
  ``max_new_tokens`` cut and the 400 past ``MAX_NEW_TOKENS`` on both;
  ``/sentiment`` the same;
- seeded HF-layout directories at tiny widths (``chip_smoke.py``'s
  writers: DistilBERT with a WordPiece ``tokenizer.json`` or a
  ``vocab.txt``, ViT, YOLOS, a Llama checkpoint) load into the port's
  units, whose answers equal the models built by hand from the same
  tensors; the WordPiece file equals ``BertTokenizerFast``'s ids;
- the refusals: ``MESH_SPEC=tp=4`` at ``load()`` without the ranks
  ``serve_multihost`` starts (the ``llama`` and ``mistral`` manifests),
  and at ``bert``, a ``config.json`` of another ``model_type`` at
  ``bert``, a hub id, the tiny tiers' heads of 16 on the card, an image
  that is no image (a 400).
"""

import base64
import dataclasses
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.models import bert as pbert
from scalable_hw_agnostic_inference_tpu_torch.models import llama as pllama
from scalable_hw_agnostic_inference_tpu_torch.models import vit as pvit
from scalable_hw_agnostic_inference_tpu_torch.models import yolos as pyolos
from scalable_hw_agnostic_inference_tpu_torch.models.generate import (
    make_generate,
)
from scalable_hw_agnostic_inference_tpu_torch.models.imageio import (
    encode_png,
)
from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
    quantize_state_dict,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.units import UNITS
from scalable_hw_agnostic_inference_tpu_torch.serve.units.common import (
    check_head_size,
    decode_image,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parent.parent))
import chip_smoke  # noqa: E402
from test_torch_serve_flux import _serve  # noqa: E402
from test_torch_serve_sd import _http, _load_jax_unit, _wait_ready  # noqa
from torch_threads import one_torch_thread  # noqa: E402,F401

#: the responses round scores and logits to 4 decimals and box corners to
#: 0.1 px: fp32 noise between the packages may move the last digit by one
ROUND_SCORE, ROUND_BOX = 1.5e-4, 0.15
#: the LLM units' cap on new tokens here (the reference's default, 128,
#: only makes the CPU runs longer)
NEW = 12


def _png_b64(h, w, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    return base64.b64encode(encode_png(img)).decode()


def _carry(name, drawn, service):
    """The JAX unit's drawn tree into the port unit's model."""
    if name == "bert":
        service.model = pbert.build(pbert.BertConfig.tiny(),
                                    pbert.params_from_jax(
                                        drawn["DistilBertClassifier"]))
    elif name == "vit":
        service.model = pvit.build(pvit.ViTConfig.tiny(),
                                   pvit.params_from_jax(
                                       drawn["ViTClassifier"]))
    elif name == "yolo":
        service.model = pyolos.build(pyolos.YolosConfig.tiny(),
                                     pyolos.params_from_jax(
                                         drawn["YolosForObjectDetection"]))
    else:
        cfg = service.mcfg
        state = pllama.params_from_jax(
            jax.tree.map(np.asarray, drawn["LlamaForCausalLM"]), cfg)
        if service.cfg.quantization == "int8":
            state = quantize_state_dict(state)
        service.model = pllama.LlamaForCausalLM.from_state_dict(
            cfg, state, dtype=torch.float32)
        service._gen = {}


def _pods(name, **kw):
    jcfg = JServeConfig(app=name, model_id="tiny", device="cpu",
                        warmup=False, **kw)
    jservice = get_model(name)(jcfg)
    drawn = _load_jax_unit(jservice)
    jservice.load = lambda: None
    cfg = ServeConfig(app=name, model_id="tiny", device="cpu", warmup=False,
                      **kw)
    service = UNITS[name](cfg)
    service.load()
    _carry(name, drawn, service)
    service.load = lambda: None
    jsrv, tsrv, ref, port = _serve(jcfg, jservice, cfg, service)
    _wait_ready(ref)
    _wait_ready(port)
    return jsrv, tsrv, ref, port


@pytest.fixture(scope="module")
def encoder_pods():
    out, servers = {}, []
    try:
        for name in ("bert", "vit", "yolo"):
            jsrv, tsrv, ref, port = _pods(name)
            servers += [jsrv, tsrv]
            out[name] = (ref, port)
        yield out
    finally:
        for s in servers:
            s.stop()


def _strip(body):
    """A response without the runtime's ``latency_s``."""
    return {k: v for k, v in body.items() if k != "latency_s"}


def _close(got, want, tol):
    assert abs(float(got) - float(want)) <= tol, (got, want)


BERT_TEXTS = ["i love this framework", "terrible, slow and broken!", ""]


@pytest.mark.parametrize("text", BERT_TEXTS)
def test_bert_predict_equals_the_jax_unit(encoder_pods, text):
    ref, port = encoder_pods["bert"]
    js, jb = _http(ref + "/predict", {"text": text})
    ps, pb = _http(port + "/predict", {"text": text})
    assert js == ps == 200, pb
    assert set(pb) == set(jb) >= {"label", "score", "logits"}
    assert pb["label"] == jb["label"]
    _close(pb["score"], jb["score"], ROUND_SCORE)
    assert len(pb["logits"]) == len(jb["logits"]) == 2
    for g, w in zip(pb["logits"], jb["logits"]):
        _close(g, w, ROUND_SCORE)


@pytest.mark.parametrize("image", ["random", "png"])
def test_vit_classify_equals_the_jax_unit(encoder_pods, image):
    ref, port = encoder_pods["vit"]
    payload = {"image_b64": "random" if image == "random"
               else _png_b64(48, 40, 1)}
    js, jb = _http(ref + "/classify", payload)
    ps, pb = _http(port + "/classify", payload)
    assert js == ps == 200, pb
    assert pb["label"] == jb["label"]
    assert [t["label"] for t in pb["top5"]] == [t["label"] for t in jb["top5"]]
    for g, w in zip(pb["top5"], jb["top5"]):
        _close(g["score"], w["score"], ROUND_SCORE)


@pytest.mark.parametrize("threshold", [0.0, 0.3])
@pytest.mark.parametrize("image", ["random", "png"])
def test_yolo_detectobj_equals_the_jax_unit(encoder_pods, image, threshold):
    ref, port = encoder_pods["yolo"]
    payload = {"image_b64": "random" if image == "random"
               else _png_b64(30, 50, 2), "threshold": threshold}
    js, jb = _http(ref + "/detectobj", payload)
    ps, pb = _http(port + "/detectobj", payload)
    assert js == ps == 200, pb
    assert pb["count"] == jb["count"] == len(pb["detections"])
    if threshold == 0.0:
        assert pb["count"] == 5
    for g, w in zip(pb["detections"], jb["detections"]):
        assert (g["label"], g["label_id"]) == (w["label"], w["label_id"])
        _close(g["score"], w["score"], ROUND_SCORE)
        for k in ("xmin", "ymin", "xmax", "ymax"):
            _close(g["box"][k], w["box"][k], ROUND_BOX)


def test_bad_image_is_a_400(encoder_pods):
    for name, route in (("vit", "/classify"), ("yolo", "/detectobj")):
        status, body = _http(encoder_pods[name][1] + route,
                             {"image_b64": base64.b64encode(
                                 b"no image here").decode()})
        assert status == 400, body


@pytest.fixture(scope="module", params=["llama", "deepseek_int8"])
def llm_pods(request):
    name, _, quant = request.param.partition("_")
    jsrv, tsrv, ref, port = _pods(name, max_new_tokens=NEW,
                                  quantization=quant)
    try:
        yield ref, port, quant
    finally:
        tsrv.stop()
        jsrv.stop()


#: one bucket (32 tokens): each bucket is one more JAX compile
LLM_PROMPTS = ["the quick brown fox", "a"]


@pytest.mark.parametrize("prompt", LLM_PROMPTS)
def test_generate_equals_the_jax_unit(llm_pods, prompt):
    ref, port, _ = llm_pods
    for payload in ({"prompt": prompt, "temperature": 0.0},
                    {"prompt": prompt, "temperature": 0.0,
                     "max_new_tokens": 5}):
        js, jb = _http(ref + "/generate", payload)
        ps, pb = _http(port + "/generate", payload)
        assert js == ps == 200, pb
        assert _strip(pb) == _strip(jb)
    assert pb["n_tokens"] <= 5


def test_llm_routes_and_400s(llm_pods):
    ref, port, quant = llm_pods
    if not quant:   # the sentiment prompt is one more bucket to compile
        js, jb = _http(ref + "/sentiment", {"text": "great movie"})
        ps, pb = _http(port + "/sentiment", {"text": "great movie"})
        assert js == ps == 200 and _strip(pb) == _strip(jb)
    too_many = {"prompt": "hi", "max_new_tokens": NEW + 1}
    assert _http(ref + "/generate", too_many)[0] == 400
    status, body = _http(port + "/generate", too_many)
    assert status == 400 and "MAX_NEW_TOKENS" in str(body)
    # sampled: deterministic in the seed on the port's side
    sampled = {"prompt": "hello", "temperature": 1.0, "seed": 3}
    first, again = (_http(port + "/generate", sampled) for _ in range(2))
    assert first[0] == 200 and _strip(first[1]) == _strip(again[1])


# -- directories -------------------------------------------------------------


ENCODER_CFGS = {"bert": pbert.BertConfig.tiny(), "vit": pvit.ViTConfig.tiny(),
                "yolo": pyolos.YolosConfig.tiny()}


@pytest.mark.parametrize("vocab", ["tokenizer_json", "vocab_txt"])
def test_bert_directory_serves(tmp_path, vocab):
    from transformers import BertTokenizerFast

    cfg = ENCODER_CFGS["bert"]
    state = chip_smoke._write_encoder_dir(tmp_path, "bert", cfg, seed=3,
                                          vocab_txt=vocab == "vocab_txt")
    svc = UNITS["bert"](ServeConfig(app="bert", device="cpu",
                                    model_id=str(tmp_path), max_seq_len=24))
    svc.load()
    assert svc.seq == 24 and svc.LABELS == ("NEGATIVE", "POSITIVE")
    hf = BertTokenizerFast.from_pretrained(str(tmp_path))
    text = "Hello, WORLD! this is un-tokenizable ☃"
    enc = hf(text, padding="max_length", truncation=True, max_length=24)
    ids, mask = svc._encode(text)
    assert ids[0].tolist() == enc["input_ids"]
    assert mask[0].tolist() == enc["attention_mask"]
    model = pbert.build(cfg, state, dtype=torch.bfloat16)
    with torch.inference_mode():
        want = model(torch.from_numpy(ids), torch.from_numpy(mask))[0]
    out = svc.infer({"text": text})
    np.testing.assert_allclose(out["logits"], want.numpy(), atol=1e-4)
    assert out["label"] == ("NEGATIVE", "POSITIVE")[int(want.argmax())]


@pytest.mark.parametrize("name", ["vit", "yolo"])
def test_vision_directories_serve(tmp_path, name):
    cfg = ENCODER_CFGS[name]
    state = chip_smoke._write_encoder_dir(tmp_path, name, cfg, seed=4)
    svc = UNITS[name](ServeConfig(app=name, device="cpu",
                                  model_id=str(tmp_path)))
    svc.load()
    mod = pvit if name == "vit" else pyolos
    model = mod.build(cfg, state, dtype=torch.bfloat16)
    payload = {"image_b64": _png_b64(20, 36, 5), "threshold": 0.0}
    out = svc.infer(payload)
    if name == "vit":
        px = decode_image(payload, cfg.image_size)
        with torch.inference_mode():
            want = model(torch.from_numpy(px))[0]
        assert out["label"] == svc.labels[int(want.argmax())]
        assert out["label"].startswith("label_")
    else:
        assert out["count"] == cfg.n_det_tokens
        assert all(d["label"].startswith("object_")
                   for d in out["detections"] if d["label_id"] < 3)


def test_llama_directory_serves_bf16_and_int8(tmp_path):
    cfg = dataclasses.replace(pllama.LlamaConfig(
        **{**pllama.LlamaConfig.tiny().__dict__, "vocab_size": 512}),
        rope_scaling=(32.0, 1.0, 4.0, 8192), max_seq_len=4096,
        n_heads=2, n_kv_heads=1)
    state = pllama.random_params(cfg, 5, dtype=torch.bfloat16, device="cpu")
    chip_smoke._write_checkpoint(tmp_path, state, cfg)
    for quant in ("", "int8"):
        svc = UNITS["deepseek"](ServeConfig(
            app="deepseek", device="cpu", model_id=str(tmp_path),
            max_new_tokens=8, quantization=quant))
        svc.load()
        assert svc.eos_id == svc.tokenizer.eos_token_id
        assert svc.buckets.buckets[0] == 32
        want_state = quantize_state_dict(state) if quant else state
        model = pllama.LlamaForCausalLM.from_state_dict(cfg, want_state)
        prompt = "hello world, the quick brown fox"
        ids, n, bucket = svc._encode(prompt)
        assert ids[0, 0] == svc.tokenizer.encode("")[0]   # BOS
        gen = make_generate(model, cfg, prompt_bucket=bucket,
                            max_new_tokens=8, eos_id=svc.eos_id,
                            pad_id=svc.pad_id)
        want = gen(ids, n, temperature=0.0).tokens.numpy()[0]
        np.testing.assert_array_equal(svc.generate_ids(prompt, 0.0), want)
        out = svc.infer({"prompt": prompt, "temperature": 0.0})
        assert out["n_tokens"] == int((want != svc.pad_id).sum())


# -- refusals -----------------------------------------------------------------


def test_units_cover_the_jax_registry():
    from scalable_hw_agnostic_inference_tpu.models.registry import (
        list_models,
    )

    assert sorted(UNITS) == list_models()


def test_refusals(tmp_path):
    # the llama manifest's tp=4 runs over ranks (serve_multihost gives
    # each its group): loaded without one, it is refused, naming it; the
    # encoder units stay on one device (ROADMAP A7.3c)
    with pytest.raises(ValueError, match="tp=4.*serve_multihost"):
        UNITS["llama"](ServeConfig(app="llama", device="cpu",
                                   model_id="tiny", mesh_spec="tp=4")).load()
    with pytest.raises(ValueError, match="tensor parallelism.*A7.3c"):
        UNITS["bert"](ServeConfig(app="bert", device="cpu",
                                  model_id="tiny", mesh_spec="tp=4")).load()
    chip_smoke._write_encoder_dir(tmp_path, "bert", ENCODER_CFGS["bert"],
                                  seed=1, model_type="bert")
    with pytest.raises(ValueError, match="DistilBERT"):
        UNITS["bert"](ServeConfig(app="bert", device="cpu",
                                  model_id=str(tmp_path))).load()
    for name in ("bert", "vit", "yolo", "mistral"):
        with pytest.raises(ValueError, match="download|not a directory"):
            UNITS[name](ServeConfig(app=name, device="cpu",
                                    model_id="org/some-model")).load()
    with pytest.raises(ValueError, match="heads of size 16"):
        check_head_size(16, torch.device("cuda", 0), "the tiny tier")
    check_head_size(64, torch.device("cuda", 0), "vit-base")
