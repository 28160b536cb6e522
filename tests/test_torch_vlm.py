"""The port's soft-prefix VLM (LLaVA) path against the JAX package's, on the
CPU.

One tiny HF ``LlavaForConditionalGeneration`` (``transformers``: a CLIP
tower of 3 layers at 32 px, patch 8, and a Llama text model with as many
KV heads as query heads, LLaVA-1.5's MHA) gives both packages their
weights: the JAX side through the reference's converters
(``vlm.params_from_torch``, ``llama.params_from_torch``), the port through
``params_from_jax`` of those trees. The cases:

- the tower and projector (``models/vlm.py``) in fp32 against
  ``vlm.VisionProjector`` within ``TOWER_ATOL`` (2e-4), at the tiny tier's
  config, at the HF model's and at other feature layers (the port stops
  after the block that makes the state);
- ``load_llava_checkpoint`` on the HF tensors written in both key layouts
  (``model.language_model.*`` / ``model.vision_tower.*``, and
  llava-1.5-7b-hf's ``language_model.model.*`` / ``vision_tower.*``),
  bit for bit against the reference's converted trees cast to bf16; the
  configurations read from llava-1.5-7b-hf's sparse ``config.json`` and
  from the tiny model's, against ``AutoConfig``;
- ``make_prefill`` with ``prefix_len`` against the JAX one: the pool and
  the logits within the runner's ``LOGIT_ATOL`` (6e-2);
- the engine against the JAX engine (its gather path): soft-prefix and
  text requests mixed, one text prompt chunking, and a prefix request
  preempted and resumed, greedy by ``tests/parity.py``'s tie rule; the
  warmed set with ``prefix_lens`` of the JAX engine's size, 0 recompiles;
  a prefix request is never content-addressed (the same text after it
  finds no cached block, the tier banks nothing, no block leaks);
- the tiny ``vllm`` unit with the JAX service's weights (the tower's
  too): the same ``generated_text`` for a PNG, a JPEG and ``"random"``,
  and the 400s of a bad image and of a text with no room left.
"""

import base64
import contextlib
import dataclasses
import io
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scalable_hw_agnostic_inference_tpu.engine import runner as jrunner
from scalable_hw_agnostic_inference_tpu.engine.config import (
    EngineConfig as JEngineConfig,
)
from scalable_hw_agnostic_inference_tpu.engine.engine import (
    LLMEngine as JEngine,
    SamplingParams as JParams,
)
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.models import vlm as jvlm
from scalable_hw_agnostic_inference_tpu.models.convert import (
    cast_f32_to_bf16,
)
from scalable_hw_agnostic_inference_tpu.models.registry import get_model
from scalable_hw_agnostic_inference_tpu.utils.env import (
    ServeConfig as JServeConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.core.checkpoint import (
    save_safetensors,
)
from scalable_hw_agnostic_inference_tpu_torch.engine import runner as trunner
from scalable_hw_agnostic_inference_tpu_torch.engine.cache import PagedKVCache
from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
    EngineConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.models import vlm as tvlm
from scalable_hw_agnostic_inference_tpu_torch.models.convert import (
    llava_configs,
    load_llava_checkpoint,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.asgi import HTTPError
from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
    VllmService,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
from parity import assert_greedy_parity  # noqa: E402

TOWER_ATOL = 2e-4
LOGIT_ATOL = 6e-2
BS, BPS = 8, 16
# 16-token prefixes (the tiny tower's patches) in buckets 32 and 64; a
# 70-token text prompt chunks past the largest bucket
ENGINE_KW = dict(max_model_len=128, max_num_seqs=3, block_size=BS,
                 context_encoding_buckets=(16, 32, 64), max_new_tokens=8)
BASE_ENV = {"SHAI_PAGED_DECODE": "0", "SHAI_RAGGED_ATTENTION": "0",
            "SHAI_KV_QUANT": "", "SHAI_FUSED_STEP": "0", "SHAI_KVTIER": "0",
            "SHAI_KV_COW": "0", "SHAI_ASYNC_DECODE": "1"}

#: llava-hf/llava-1.5-7b-hf's config.json as published
LLAVA_15_7B = {
    "architectures": ["LlavaForConditionalGeneration"],
    "ignore_index": -100, "image_token_index": 32000,
    "model_type": "llava", "pad_token_id": 32001,
    "projector_hidden_act": "gelu",
    "text_config": {
        "_name_or_path": "lmsys/vicuna-7b-v1.5",
        "architectures": ["LlamaForCausalLM"],
        "max_position_embeddings": 4096, "model_type": "llama",
        "rms_norm_eps": 1e-05, "torch_dtype": "float16",
        "vocab_size": 32064},
    "tie_word_embeddings": False, "torch_dtype": "float16",
    "transformers_version": "4.36.0.dev0",
    "vision_config": {
        "hidden_size": 1024, "image_size": 336, "intermediate_size": 4096,
        "model_type": "clip_vision_model", "num_attention_heads": 16,
        "num_hidden_layers": 24, "patch_size": 14, "projection_dim": 768,
        "vocab_size": 32000},
    "vision_feature_layer": -2,
    "vision_feature_select_strategy": "default", "vocab_size": 32064}


@contextlib.contextmanager
def _env(**over):
    values = dict(BASE_ENV, **over)
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _hf_model():
    from transformers import (
        CLIPVisionConfig,
        LlamaConfig as HFLlamaConfig,
        LlavaConfig,
        LlavaForConditionalGeneration,
    )

    vision = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                              num_hidden_layers=3, num_attention_heads=2,
                              image_size=32, patch_size=8)
    text = HFLlamaConfig(vocab_size=160, hidden_size=64,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=256, rms_norm_eps=1e-5)
    torch.manual_seed(0)
    return LlavaForConditionalGeneration(LlavaConfig(
        vision_config=vision, text_config=text,
        image_token_index=159)).eval()


def _lm_state_dict(sd):
    """The reference's split of the LLaVA state dict's language model."""
    out = {k[len("model.language_model."):]: v for k, v in sd.items()
           if k.startswith("model.language_model.")}
    out.update({k: v for k, v in sd.items() if k.startswith("lm_head.")})
    return out


@pytest.fixture(scope="module")
def lv():
    hf = _hf_model()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    hcfg = hf.config
    jcfg = jllama.LlamaConfig.from_hf(hcfg.text_config)
    jvcfg = jvlm.VisionTowerConfig.from_hf(hcfg, lm_dim=jcfg.dim)
    jparams = jllama.params_from_torch(_lm_state_dict(sd), jcfg)
    vparams = jvlm.params_from_torch(sd, jvcfg)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    tvcfg = tvlm.VisionTowerConfig(**dataclasses.asdict(jvcfg))
    model = tllama.LlamaForCausalLM.from_state_dict(
        tcfg, tllama.params_from_jax(jparams, tcfg))
    vnp = jax.tree_util.tree_map(np.asarray, vparams)
    tower = tvlm.build(tvcfg, tvlm.params_from_jax(vnp), dtype=torch.float32)
    return types.SimpleNamespace(hf=hf, sd=sd, jcfg=jcfg, jvcfg=jvcfg,
                                 jparams=jparams, vparams=vparams, tcfg=tcfg,
                                 tvcfg=tvcfg, model=model, tower=tower)


def _pixels(seed, n=1, size=32):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _prefix(lv, seed):
    """A real soft prefix: the JAX tower's output for seeded pixels."""
    out = jvlm.VisionProjector(lv.jvcfg).apply(lv.vparams,
                                               jnp.asarray(_pixels(seed)))
    return np.asarray(out)[0]


# -- the tower -----------------------------------------------------------------


@pytest.mark.parametrize("feature_layer", [-2, -1, -4, 0, 2])
def test_tower_matches_jax(lv, feature_layer):
    jcfg = dataclasses.replace(lv.jvcfg, feature_layer=feature_layer)
    tcfg = dataclasses.replace(lv.tvcfg, feature_layer=feature_layer)
    px = _pixels(1, n=2)
    want = np.asarray(jvlm.VisionProjector(jcfg).apply(lv.vparams,
                                                       jnp.asarray(px)))
    tower = tvlm.build(tcfg, dict(lv.tower.state_dict()),
                       dtype=torch.float32)
    with torch.inference_mode():
        got = tower(torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, tcfg.n_patches, tcfg.lm_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)


def test_tiny_tier_tower_matches_jax():
    cfg = jvlm.VisionTowerConfig.tiny(lm_dim=64)
    vm = jvlm.VisionProjector(cfg)
    params = vm.init(jax.random.PRNGKey(9), jnp.zeros((1, 32, 32, 3)))
    # pixels in the image's layout: rows differ from columns, so a
    # transposed patch grid or position table shows
    px = np.zeros((1, 32, 32, 3), np.float32)
    px[0, :, :, 0] = np.arange(32)[:, None] / 16.0
    px[0, :, :, 1] = np.arange(32)[None, :] / -8.0
    px[0, 3:9, 20:27, 2] = 1.5
    want = np.asarray(vm.apply(params, jnp.asarray(px)))
    tower = tvlm.build(tvlm.VisionTowerConfig.tiny(lm_dim=64),
                       tvlm.params_from_jax(jax.tree_util.tree_map(
                           np.asarray, params)), dtype=torch.float32)
    with torch.inference_mode():
        got = tower(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, atol=TOWER_ATOL, rtol=0)
    assert tower.cfg.n_blocks == 1     # hidden[-2] of 2 layers


def test_tower_matches_hf_get_image_features(lv):
    px = _pixels(3, n=2)
    with torch.no_grad():
        want = lv.hf.get_image_features(
            pixel_values=torch.tensor(px.transpose(0, 3, 1, 2)),
            vision_feature_layer=-2,
            vision_feature_select_strategy="default")
    if isinstance(want, (tuple, list)):
        want = torch.cat(list(want), dim=0)
    with torch.inference_mode():
        got = lv.tower(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want.numpy().reshape(got.shape),
                               atol=TOWER_ATOL, rtol=TOWER_ATOL)


# -- the checkpoint ------------------------------------------------------------


def _old_name(k: str) -> str:
    """llava-1.5-7b-hf's layout of a name in transformers' current one."""
    if k.startswith("model.language_model."):
        return "language_model.model." + k[len("model.language_model."):]
    if k == "lm_head.weight":
        return "language_model.lm_head.weight"
    return k[len("model."):] if k.startswith("model.") else k


def _sparse_config(hf) -> dict:
    """The tiny model's config.json in llava-1.5-7b-hf's sparse form: the
    text and vision configs name only what differs from the defaults."""
    t, v = hf.config.text_config, hf.config.vision_config
    return {
        "architectures": ["LlavaForConditionalGeneration"],
        "model_type": "llava", "image_token_index": 159,
        "text_config": {
            "model_type": "llama", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "max_position_embeddings": t.max_position_embeddings,
            "rms_norm_eps": t.rms_norm_eps},
        "vision_config": {
            "model_type": "clip_vision_model", "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_hidden_layers,
            "num_attention_heads": v.num_attention_heads,
            "image_size": v.image_size, "patch_size": v.patch_size}}


@pytest.fixture(scope="module")
def ckpt_dirs(lv, tmp_path_factory):
    import chip_smoke

    base = tmp_path_factory.mktemp("llava")
    for layout in ("new", "old"):
        path = base / layout
        path.mkdir()
        sd = {(k if layout == "new" else _old_name(k)): v.contiguous()
              for k, v in lv.sd.items()}
        save_safetensors(sd, path / "model.safetensors")
        (path / "config.json").write_text(json.dumps(_sparse_config(lv.hf)))
        chip_smoke._write_tokenizer(path, merges_wanted=20)
    return base


def _configs_via_autoconfig(path):
    from transformers import AutoConfig

    hcfg = AutoConfig.from_pretrained(str(path))
    jcfg = jllama.LlamaConfig.from_hf(hcfg.text_config)
    return jcfg, jvlm.VisionTowerConfig.from_hf(hcfg, lm_dim=jcfg.dim)


@pytest.mark.parametrize("layout", ["new", "old"])
def test_checkpoint_equals_reference_converters(lv, ckpt_dirs, layout):
    cfg, state, vcfg, vstate = load_llava_checkpoint(ckpt_dirs / layout,
                                                     "cpu")
    jcfg, jvcfg = _configs_via_autoconfig(ckpt_dirs / layout)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    want_text = tllama.params_from_jax(cast_f32_to_bf16(lv.jparams), cfg)
    want_vis = tvlm.params_from_jax(jax.tree_util.tree_map(
        np.asarray, cast_f32_to_bf16(lv.vparams)))
    for got, want in ((state, want_text), (vstate, want_vis)):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == torch.bfloat16, k
            assert torch.equal(got[k], v.to(torch.bfloat16)), k


def test_published_sparse_config_equals_autoconfig(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(LLAVA_15_7B))
    cfg, vcfg, full = llava_configs(LLAVA_15_7B)
    jcfg, jvcfg = _configs_via_autoconfig(tmp_path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        tllama.LlamaConfig.llava15_7b_text())
    assert vcfg == tvlm.VisionTowerConfig()
    assert full["image_token_index"] == 32000
    # what the reference refuses, and what this port cannot compute
    with pytest.raises(ValueError, match="select_strategy"):
        llava_configs(dict(LLAVA_15_7B,
                           vision_feature_select_strategy="full"))
    with pytest.raises(ValueError, match="projector_hidden_act"):
        llava_configs(dict(LLAVA_15_7B, projector_hidden_act="relu"))
    with pytest.raises(ValueError, match="hidden_act='relu'"):
        llava_configs(dict(LLAVA_15_7B, vision_config=dict(
            LLAVA_15_7B["vision_config"], hidden_act="relu")))
    # a LlavaConfig without a vision_config builds CLIP-L/14-336
    bare = {k: v for k, v in LLAVA_15_7B.items() if k != "vision_config"}
    assert llava_configs(bare)[1] == vcfg


# -- prefill -------------------------------------------------------------------


def test_prefix_prefill_matches_jax(lv):
    jcfg, tcfg = lv.jcfg, lv.tcfg
    P, bucket, K = lv.tvcfg.n_patches, 64, 2
    rng = np.random.default_rng(2)
    ids = rng.integers(3, jcfg.vocab_size, (K, bucket - P)).astype(np.int32)
    n_text = np.array([7, bucket - P], np.int32)
    ids[0, 7:] = 0
    tables = np.zeros((K, BPS), np.int32)
    tables[0, :8] = np.arange(1, 9)
    tables[1, :8] = np.arange(9, 17)[::-1]
    prefix = np.stack([_prefix(lv, 4), _prefix(lv, 5)])
    nb = 20
    jkv = [{n: jnp.zeros((nb, BS, jcfg.n_kv_heads, jcfg.head_dim),
                         jnp.bfloat16) for n in ("k", "v")}
           for _ in range(jcfg.n_layers)]
    tkv = PagedKVCache(tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim, nb, BS,
                       BPS, device=torch.device("cpu")).kv
    jkv, jlog = jrunner.make_prefill(jcfg, BS, BPS, bucket, prefix_len=P,
                                     n_seqs=K)(
        lv.jparams, jkv, jnp.asarray(ids), jnp.asarray(n_text),
        jnp.asarray(tables), jnp.asarray(prefix))
    with torch.inference_mode():
        tkv, tlog = trunner.make_prefill(tcfg, BS, BPS, bucket, n_seqs=K,
                                         prefix_len=P)(
            lv.model, tkv, torch.from_numpy(ids), torch.from_numpy(n_text),
            torch.from_numpy(tables), prefix=torch.from_numpy(prefix))
    np.testing.assert_allclose(tlog.float().numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL, rtol=0)
    assert (tlog.argmax(-1).numpy() == np.asarray(jlog).argmax(-1)).all()
    for j, t in zip(jkv, tkv):
        for n in ("k", "v"):
            np.testing.assert_allclose(
                t[n].float().numpy(), np.asarray(j[n].astype(jnp.float32)),
                atol=LOGIT_ATOL, rtol=0)
    # the variant's contract: its own prefix length, no cross model
    with pytest.raises(ValueError, match="prefix"):
        trunner.make_prefill(tcfg, BS, BPS, bucket, prefix_len=P)(
            lv.model, tkv, torch.from_numpy(ids[:1]),
            torch.from_numpy(n_text[:1]), torch.from_numpy(tables[:1]))
    with pytest.raises(ValueError, match="soft"):
        trunner.make_prefill(dataclasses.replace(
            tcfg, cross_attention_layers=(1,)), BS, BPS, bucket,
            prefix_len=P)


# -- the engine ----------------------------------------------------------------


def _requests(lv):
    """(prompt, prefix) of the engine cases: prefix rows in both prefix
    buckets, text rows, and a text prompt that chunks."""
    rng = np.random.default_rng(5)
    long = [int(x) for x in rng.integers(2, lv.tcfg.vocab_size, 70)]
    mid = [int(x) for x in rng.integers(2, lv.tcfg.vocab_size, 30)]
    return [([5, 17, 42], _prefix(lv, 10)),
            ([9, 9, 31, 7], None),
            (mid, _prefix(lv, 11)),
            (long, None),
            ([5, 17, 42], None),
            ([11, 23, 5, 8, 19], _prefix(lv, 12))]


def _drive(eng, reqs, sp):
    ids = [eng.add_request(list(p), sp, prefix=x) for p, x in reqs]
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    if hasattr(eng, "finish_pending"):
        eng.finish_pending()
    return [done[i] for i in ids]


@pytest.fixture(scope="module")
def jax_runs(lv):
    out = {}
    with _env():
        eng = JEngine(lv.jcfg, lv.jparams, JEngineConfig(**ENGINE_KW))
        out["warmed"] = eng.warm_executables([0, lv.jvcfg.n_patches])
        out["keys"] = list(eng._prefill)
        out["mixed"] = _drive(eng, _requests(lv), JParams(
            temperature=0.0, max_new_tokens=8, logprobs=2))
        # two prefix rows of 16 + 30 tokens: 6 blocks each, 7 reserved; a
        # pool of 14 (null block included) admits both with one block
        # free, and the later row to reach position 48 is preempted
        eng = JEngine(lv.jcfg, lv.jparams, JEngineConfig(
            **dict(ENGINE_KW, num_blocks=14)))
        reqs = _requests(lv)
        out["preempt"] = _drive(eng, [reqs[2], (reqs[2][0], reqs[5][1])],
                                JParams(temperature=0.0, max_new_tokens=8,
                                        logprobs=2))
        out["preemptions"] = eng.obs.preemptions
    return out


def _port_engine(lv, **over):
    return LLMEngine(lv.tcfg, lv.model, EngineConfig(**dict(ENGINE_KW,
                                                            **over)),
                     device="cpu")


def test_engine_matches_jax_engine(lv, jax_runs):
    with _env():
        eng = _port_engine(lv)
        warmed = eng.warm_executables([0, lv.tvcfg.n_patches])
        got = _drive(eng, _requests(lv),
                     SamplingParams(temperature=0.0, max_new_tokens=8))
    assert warmed == jax_runs["warmed"] == eng.n_executables
    # the JAX keys: (bucket, P, batch); the port's text keys (bucket,
    # batch) and its prefix keys ("prefix", bucket, P)
    want = {("prefix", b, p) if p else (b, k)
            for b, p, k in (key for key in jax_runs["keys"]
                            if key[0] not in ("cont", "rcont"))}
    want |= {k for k in jax_runs["keys"] if k[0] in ("cont", "rcont")}
    assert set(eng._prefill) == want
    assert eng.obs.recompiles == 0 and eng.cache.leaked_blocks == 0
    assert [f.n_prompt for f in got] == [f.n_prompt for f in
                                         jax_runs["mixed"]]
    assert_greedy_parity(got, jax_runs["mixed"], label="soft-prefix engine")
    # the prefix conditions the tokens: the same text without it differs
    assert got[0].token_ids != got[4].token_ids


def test_engine_preempts_a_prefix_request_like_jax(lv, jax_runs):
    reqs = _requests(lv)
    with _env():
        eng = _port_engine(lv, num_blocks=14)
        got = _drive(eng, [reqs[2], (reqs[2][0], reqs[5][1])],
                     SamplingParams(temperature=0.0, max_new_tokens=8))
    assert eng.obs.preemptions == jax_runs["preemptions"] >= 1
    assert eng.cache.leaked_blocks == 0
    assert all(len(f.token_ids) == 8 for f in got)
    assert_greedy_parity(got, jax_runs["preempt"], label="preempted prefix")


@pytest.mark.parametrize("async_on", ["1", "0"])
def test_engine_async_equals_lock_step(lv, async_on):
    with _env(SHAI_ASYNC_DECODE=async_on):
        got = _drive(_port_engine(lv), _requests(lv), SamplingParams(
            temperature=0.0, max_new_tokens=8, logprobs=2))
    with _env(SHAI_ASYNC_DECODE="0"):
        want = _drive(_port_engine(lv), _requests(lv), SamplingParams(
            temperature=0.0, max_new_tokens=8, logprobs=2))
    assert [(f.token_ids, f.logprobs) for f in got] == [
        (f.token_ids, f.logprobs) for f in want]


def test_prefix_request_is_never_content_addressed(lv):
    """An image request, then the same text without the image: no cached
    block, nothing banked in the tier, no leak; the text request's tokens
    are a fresh engine's."""
    reqs = _requests(lv)
    text = reqs[2][0]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    with _env(SHAI_KVTIER="1", SHAI_KVTIER_ASYNC="0"):
        eng = _port_engine(lv, enable_prefix_caching=True)
        img = _drive(eng, [(text, reqs[2][1])], sp)[0]
        assert eng.cache.cached_prefix(text) == []
        assert eng.cache.tier is not None and eng.cache.tier.n_entries == 0
        after = _drive(eng, [(text, None)], sp)[0]
        fresh = _drive(_port_engine(lv, enable_prefix_caching=True),
                       [(text, None)], sp)[0]
    assert after.token_ids == fresh.token_ids != img.token_ids
    assert eng.cache.leaked_blocks == 0
    # a soft-prefix request does not migrate: its image does not travel
    with _env():
        eng = _port_engine(lv)
        rid = eng.add_request(list(text), sp, prefix=reqs[2][1])
        assert eng.migrate_out(rid) is None
        eng.cancel(rid)


def test_add_request_checks_the_prefix(lv):
    with _env():
        eng = _port_engine(lv)
    sp = SamplingParams(temperature=0.0, max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds the largest"):
        eng.add_request([1, 2], sp, prefix=np.zeros((64, lv.tcfg.dim),
                                                    np.float32))
    with pytest.raises(ValueError, match="prefix must be"):
        eng.add_request([1, 2], sp, prefix=np.zeros((16, 8), np.float32))
    # the text is cut to the largest bucket less the prefix, tail kept
    rid = eng.add_request(list(range(100)), sp,
                          prefix=np.zeros((16, lv.tcfg.dim), np.float32))
    assert eng.waiting[-1].req_id == rid
    assert eng.waiting[-1].prompt_ids == list(range(100))[-48:]


# -- the serving unit ----------------------------------------------------------


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("units")
    jcfg = JServeConfig(app="vllm", device="cpu", model_id="tiny",
                        batch_size=4, max_new_tokens=16,
                        vllm_config=str(tmp / "absent.yaml"))
    jsvc = get_model("vllm")(jcfg)
    jsvc.load()
    params = jllama.LlamaForCausalLM(
        jllama.LlamaConfig.tiny(), dtype=jnp.float32).init(
        jax.random.PRNGKey(jcfg.seed), jnp.zeros((1, 8), jnp.int32))
    vcfg = jvlm.VisionTowerConfig.tiny(lm_dim=64)
    vparams = jvlm.VisionProjector(vcfg).init(
        jax.random.PRNGKey(jcfg.seed + 9),
        jnp.zeros((1, vcfg.image_size, vcfg.image_size, 3)))
    vstate = tvlm.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         vparams))

    def weights(mcfg, dev):
        state = tllama.params_from_jax(params, mcfg)
        state.update({f"vision.{k}": v for k, v in vstate.items()})
        return state

    cfg = ServeConfig(app="vllm", device="cpu", model_id="tiny",
                      batch_size=4, max_new_tokens=16,
                      vllm_config=str(tmp / "absent.yaml"),
                      artifact_root=str(tmp / "artifacts"))
    with _env():
        svc = VllmService(cfg, weights=weights)
        svc.load()
    try:
        yield jsvc, svc
    finally:
        svc.close()
        jsvc.loop.stop()


def _png_b64(seed):
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, (40, 52, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _jpeg_b64(seed):
    from PIL import Image

    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([x * 4, y * 5, (x + y) * 2], 2) % 256
    img = (img + np.random.default_rng(seed).integers(0, 30, img.shape)
           ).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90, progressive=True)
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("image", ["png", "jpeg", "random"])
def test_tiny_unit_image_matches_the_jax_service(services, image):
    jsvc, svc = services
    b64 = {"png": _png_b64(1), "jpeg": _jpeg_b64(2),
           "random": "random"}[image]
    base = {"prompt": "describe the image", "temperature": 0.0,
            "max_new_tokens": 6}
    want = jsvc.infer(dict(base, image_b64=b64))
    got = svc.infer(dict(base, image_b64=b64))
    assert got["generated_text"] == want["generated_text"]
    assert got["n_tokens"] == want["n_tokens"] == 6
    plain = svc.infer(base)
    assert plain["generated_text"] != got["generated_text"]
    assert svc._engine.obs.recompiles == 0


def test_tiny_unit_image_errors(services):
    _, svc = services
    assert svc._vision is not None and svc._vision[0].n_patches == 16
    for bad, words in (("abc", "base64"),
                       (base64.b64encode(b"GIF89a....").decode(), "GIF")):
        with pytest.raises(HTTPError) as e:
            svc.infer({"prompt": "x", "image_b64": bad})
        assert e.value.status == 400 and words in str(e.value)
    # the text is head-kept to the largest bucket less the prefix
    out = svc.infer({"prompt": "y" * 400, "image_b64": "random",
                     "max_new_tokens": 2, "temperature": 0.0})
    assert out["n_tokens"] == 2 and out["n_prompt"] == 128 - 16
