"""The port's mllama (Llama-3.2-Vision) path against the JAX package's, on
the CPU.

One tiny HF mllama (``transformers``, its tanh gates opened so that the
image reaches the tokens) gives both packages their weights: the JAX side
through the reference's converters (``params_from_torch``,
``vision_params_from_torch``), the port through ``params_from_jax`` and
``vision_params_from_jax`` of those trees. The cases:

- the tiled vision model and the projector in fp32, a masked tile
  included, within ``VISION_RTOL`` of the largest JAX value (measured
  4e-7: the two frameworks sum the products in other orders);
- ``make_cross_kv``, a prefill with the cross tail (an image row with
  part of its states valid, a text-only row) and decode steps gathering by
  ``slot_idx``: k/v and logits within ``LOGIT_ATOL``, the runner tests'
  bf16 bound (``tests/test_torch_runner.py``), and the same argmax wherever
  the JAX top-2 gap is decisive;
- the engine, JAX ``LLMEngine(cross_seq_len=...)`` (through its gather
  path) against the port (through the kernels' plain versions): two image
  rows (one of them with half its states valid), a text-only row and an
  image prompt that chunks through the static continuation, greedy, by
  ``tests/parity.py``'s tie rule, over a bf16 and an int8 KV pool; in the port alone: states past
  ``cross_len`` change nothing, the image changes the tokens, async equals
  lock-step, the warmed set takes the run with 0 recompiles, and
  speculative decoding (``[ngram]``, k=3, through verify's cross tail)
  equals it off (``tests/test_speculative.py:373``);
- the checkpoint: the HF model's tensors written by the port's safetensors
  writer in both key layouts (``model.language_model.*`` and
  ``language_model.model.*``), read back by
  ``load_mllama_checkpoint`` equal, bit for bit, to the reference's
  converted trees cast to bf16, configurations and aspect ratios equal; the
  CPU ``vllm`` unit on that directory serves a PNG ``image_b64`` whose
  image changes the tokens, ``"random"``, and answers 400 to a corrupt
  JPEG, to bytes that are no image and to an image sent to a text model,
  and 501 to the chat route under a chat template.
"""

import base64
import contextlib
import dataclasses
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

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
from scalable_hw_agnostic_inference_tpu.models import mllama as jmllama
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
from scalable_hw_agnostic_inference_tpu_torch.models import mllama as tmllama
from scalable_hw_agnostic_inference_tpu_torch.models.convert import (
    load_mllama_checkpoint,
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

VISION_RTOL = 1e-4
LOGIT_ATOL = 6e-2
BS, BPS = 8, 8
# the engines' shapes: a 16-token bucket, so a 40-token prompt chunks
# 16 + 16 + 8 through the static continuation
ENGINE_KW = dict(max_model_len=64, max_num_seqs=3, block_size=8,
                 context_encoding_buckets=(16,), max_new_tokens=8)
#: the switches both engines read at construction: the JAX side through its
#: gather path
BASE_ENV = {"SHAI_PAGED_DECODE": "0", "SHAI_RAGGED_ATTENTION": "0",
            "SHAI_KV_QUANT": "", "SHAI_FUSED_STEP": "0", "SHAI_KVTIER": "0",
            "SHAI_KV_COW": "0", "SHAI_ASYNC_DECODE": "1"}
N_MERGES = 20   # the tokenizer: 256 bytes, 20 merges, 3 special tokens


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
    from transformers import MllamaConfig, MllamaForConditionalGeneration
    from transformers.models.mllama.configuration_mllama import (
        MllamaTextConfig,
        MllamaVisionConfig,
    )

    vision = MllamaVisionConfig(
        hidden_size=32, image_size=32, patch_size=8, num_hidden_layers=3,
        num_global_layers=2, attention_heads=2, intermediate_size=64,
        max_num_tiles=2, intermediate_layers_indices=[1],
        supported_aspect_ratios=[[1, 1], [1, 2], [2, 1]],
        vision_output_dim=64)
    bos = 256 + N_MERGES
    text = MllamaTextConfig(
        vocab_size=320, hidden_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        cross_attention_layers=[1, 3], max_position_embeddings=256,
        rope_theta=10000.0, rope_scaling={"rope_type": "default"},
        tie_word_embeddings=False, pad_token_id=0, bos_token_id=bos,
        eos_token_id=bos + 1)
    torch.manual_seed(0)
    model = MllamaForConditionalGeneration(
        MllamaConfig(vision_config=vision, text_config=text)).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            # fresh checkpoints hold every tanh gate at 0: open them, so
            # the image, the tile and position embeddings and the global
            # stage all reach the output
            if "attn_gate" in name or "mlp_gate" in name:
                p.fill_(1.0)
            elif name.endswith("gate") or name.endswith("gate_ffn") \
                    or name.endswith("gate_attn"):
                p.fill_(0.6)
    return model


def _lm_state_dict(sd):
    """The reference test's split of the HF state dict's text tower."""
    out = {k[len("model.language_model."):]: v for k, v in sd.items()
           if k.startswith("model.language_model.")}
    out.update({k: v for k, v in sd.items() if k.startswith("lm_head.")})
    return out


@pytest.fixture(scope="module")
def mm():
    hf = _hf_model()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    hcfg = hf.config
    jcfg = jllama.LlamaConfig.from_hf(hcfg.text_config)
    jvcfg = jmllama.MllamaVisionConfig.from_hf(hcfg.vision_config)
    jparams = jllama.params_from_torch(_lm_state_dict(sd), jcfg)
    vparams, pparams = jmllama.vision_params_from_torch(sd, jvcfg, jcfg.dim)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    tvcfg = tmllama.MllamaVisionConfig(**dataclasses.asdict(jvcfg))
    tstate = tllama.params_from_jax(jparams, tcfg)
    model = tllama.LlamaForCausalLM.from_state_dict(tcfg, tstate)
    vstate = tmllama.vision_params_from_jax(vparams, pparams, tvcfg)
    return types.SimpleNamespace(
        hf=hf, sd=sd, jcfg=jcfg, jvcfg=jvcfg, jparams=jparams,
        vparams=vparams, pparams=pparams, tcfg=tcfg, tvcfg=tvcfg,
        tstate=tstate, model=model, vstate=vstate,
        supported=[list(g) for g in hcfg.vision_config.supported_aspect_ratios],
        Lv=tvcfg.cross_seq_len)


def _states(mm, seed, valid=None):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((mm.Lv, mm.tcfg.dim)).astype(np.float32)
    if valid is not None:
        s[valid:] = 1e3 * rng.standard_normal((mm.Lv - valid, mm.tcfg.dim))
    return s


# -- the vision model ---------------------------------------------------------


@pytest.mark.parametrize("ar_mask", [[1, 1], [1, 0]])
def test_vision_model_and_projector_match_jax(mm, ar_mask):
    rng = np.random.default_rng(0)
    T, ts = mm.tvcfg.max_num_tiles, mm.tvcfg.image_size
    px = rng.standard_normal((1, T, ts, ts, 3)).astype(np.float32)
    ar = np.array([2], np.int32)            # aspect ratio [1, 2]
    mask = np.array([ar_mask], np.int32)
    feats = jmllama.MllamaVisionModel(mm.jvcfg).apply(
        mm.vparams, jnp.asarray(px), jnp.asarray(ar), jnp.asarray(mask))
    want_f = np.asarray(feats)
    want_s = np.asarray(jmllama.MllamaProjector(mm.jvcfg, mm.jcfg.dim).apply(
        mm.pparams, feats))
    vision, proj = tmllama.build_vision(mm.tvcfg, mm.tcfg.dim, mm.vstate,
                                        dtype=torch.float32)
    with torch.inference_mode():
        got_f = vision(torch.from_numpy(px), torch.from_numpy(ar),
                       torch.from_numpy(mask))
        got_s = proj(got_f)
    assert got_f.shape == want_f.shape and got_s.shape == want_s.shape
    for got, want in ((got_f.numpy(), want_f), (got_s.numpy(), want_s)):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= VISION_RTOL, err


# -- the runner ---------------------------------------------------------------


def _assert_logits_close(got, want):
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] >= 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decisive],
                                  want.argmax(-1)[decisive])


def test_cross_kv_prefill_and_decode_match_jax(mm):
    jcfg, tcfg, model = mm.jcfg, mm.tcfg, mm.model
    states = _states(mm, 1)
    jcross = jrunner.make_cross_kv(jcfg)(mm.jparams, jnp.asarray(states))
    with torch.inference_mode():
        tcross = trunner.make_cross_kv(tcfg)(model, torch.from_numpy(states))
    assert len(tcross) == len(jcfg.cross_attention_layers)
    for j, t in zip(jcross, tcross):
        for name in ("k", "v"):
            assert t[name].dtype == torch.bfloat16
            np.testing.assert_allclose(
                t[name].float().numpy(),
                np.asarray(j[name].astype(jnp.float32)), atol=LOGIT_ATOL,
                rtol=0)
    # per-slot buffers [S, Lv, Hkv, D]: slot 2 holds the image, slot 0 zeros
    S, Lv, valid = 3, mm.Lv, mm.Lv // 2
    shape = (S, Lv, tcfg.n_kv_heads, tcfg.head_dim)
    tbufs = [{"k": torch.zeros(shape, dtype=torch.bfloat16),
              "v": torch.zeros(shape, dtype=torch.bfloat16)}
             for _ in tcross]
    trunner.make_cross_slot_write(tcfg)(tbufs, tcross, 2)
    jbufs = [{n: jnp.asarray(b[n].float().numpy()).astype(jnp.bfloat16)
              for n in ("k", "v")} for b in tbufs]
    # prefill: row 0 the image with half its states valid, row 1 text only
    rng = np.random.default_rng(2)
    ids = rng.integers(3, jcfg.vocab_size, (2, 16)).astype(np.int32)
    n_text = np.array([11, 16], np.int32)
    ids[0, 11:] = 0
    tables = np.zeros((2, BPS), np.int32)
    tables[0, :2], tables[1, :2] = (3, 7), (12, 4)
    has = np.array([1.0, 0.0], np.float32)
    clen = np.array([valid, Lv], np.int32)
    one = [{n: b[n][2:3] for n in ("k", "v")} for b in jbufs]
    zero = [{n: jnp.zeros_like(b[n][:1]) for n in ("k", "v")} for b in jbufs]
    jtail = [{n: jnp.concatenate([o[n], z[n]]) for n in ("k", "v")}
             for o, z in zip(one, zero)]
    ttail = [{n: torch.cat([b[n][2:3], torch.zeros_like(b[n][:1])])
              for n in ("k", "v")} for b in tbufs]
    n_pool = tcfg.n_layers - len(tcfg.cross_attention_layers)
    jkv = [{n: jnp.zeros((24, BS, tcfg.n_kv_heads, tcfg.head_dim),
                         jnp.bfloat16) for n in ("k", "v")}
           for _ in range(n_pool)]
    tkv = PagedKVCache(n_pool, tcfg.n_kv_heads, tcfg.head_dim, 24, BS, BPS,
                       device=torch.device("cpu")).kv
    jkv, jlog = jrunner.make_prefill(jcfg, BS, BPS, 16, n_seqs=2)(
        mm.jparams, jkv, jnp.asarray(ids), jnp.asarray(n_text),
        jnp.asarray(tables), jtail, jnp.asarray(has), jnp.asarray(clen))
    with torch.inference_mode():
        tkv, tlog = trunner.make_prefill(tcfg, BS, BPS, 16, n_seqs=2)(
            model, tkv, torch.from_numpy(ids), torch.from_numpy(n_text),
            torch.from_numpy(tables), ttail, torch.from_numpy(has),
            torch.from_numpy(clen))
    _assert_logits_close(tlog.numpy(), np.asarray(jlog))
    # decode: batch row 0 is slot 2 (the image), row 1 slot 0 (text only),
    # row 2 a padding row
    B = 3
    slot_idx = np.array([2, 0, 0], np.int32)
    dhas = np.array([1.0, 0.0, 0.0], np.float32)
    dlen = np.array([valid, Lv, Lv], np.int32)
    dtab = np.zeros((B, BPS), np.int32)
    dtab[0, :2], dtab[1, :3] = (3, 7), (12, 4, 9)
    jfwd = jrunner._make_token_forward(jcfg, BS, BPS, B, 1, None,
                                       paged=False)
    tfwd = trunner._make_token_forward(tcfg, BS, BPS, B, 1)
    tok = np.zeros((B,), np.int32)
    tok[:2] = np.asarray(jlog).argmax(-1)
    pos = np.array([11, 16, 0], np.int32)
    for _ in range(3):
        jkv, jl = jfwd(mm.jparams, jkv, jnp.asarray(tok)[:, None],
                       jnp.asarray(pos)[:, None], jnp.asarray(dtab),
                       cross_kv=jbufs, has_image=jnp.asarray(dhas),
                       slot_idx=jnp.asarray(slot_idx),
                       cross_len=jnp.asarray(dlen))
        with torch.inference_mode():
            tkv, tl = tfwd(model, tkv, torch.from_numpy(tok)[:, None],
                           torch.from_numpy(pos)[:, None],
                           torch.from_numpy(dtab),
                           (tbufs, torch.from_numpy(dhas),
                            torch.from_numpy(slot_idx),
                            torch.from_numpy(dlen)))
        jl, tl = np.asarray(jl)[:2, 0], tl.numpy()[:2, 0]
        _assert_logits_close(tl, jl)
        tok[:2] = jl.argmax(-1)
        pos[:2] += 1


def test_runner_refuses_what_an_mllama_engine_does_not_run(mm):
    with pytest.raises(ValueError, match="ragged"):
        trunner.make_prefill_cont(mm.tcfg, BS, BPS, 16, ragged=True)
    with pytest.raises(ValueError, match="fused"):
        trunner.make_fused_step(mm.tcfg, BS, BPS, 2, 16)
    with pytest.raises(ValueError, match="cross_seq_len"):
        LLMEngine(mm.tcfg, mm.model, EngineConfig(**ENGINE_KW), device="cpu")


# -- the engine ---------------------------------------------------------------


def _requests(mm):
    """(prompt, states, cross_len) of the engine cases: an image row, a
    text-only row, an image with half its states valid (garbage past them)
    and an image prompt that chunks."""
    rng = np.random.default_rng(5)
    long = [int(x) for x in rng.integers(2, mm.tcfg.vocab_size, 40)]
    half = mm.Lv // 2
    return [([5, 17, 42], _states(mm, 10), mm.Lv),
            ([9, 9, 31, 7], None, 0),
            ([11, 23, 5, 8, 19], _states(mm, 11, valid=half), half),
            (long, _states(mm, 12), mm.Lv)]


def _drive(eng, reqs, sp):
    ids = [eng.add_request(list(p), sp, cross_states=s, cross_len=n)
           for p, s, n in reqs]
    done = {}
    while eng.has_work:
        for f in eng.step():
            done[f.req_id] = f
    return [done[i] for i in ids]


def _port_engine(mm, **over):
    return LLMEngine(mm.tcfg, mm.model, EngineConfig(**dict(ENGINE_KW,
                                                            **over)),
                     device="cpu", cross_seq_len=mm.Lv)


#: the KV pool of each engine case: bf16, and int8 (the reference takes
#: ``SHAI_KV_QUANT=int8`` on a cross engine: the self-attention layers'
#: pool is int8, the cross buffers stay bf16; the port's decode then reads
#: the pool through B3's plain version)
KV = {"bf16": {}, "int8": {"SHAI_KV_QUANT": "int8"}}


@pytest.fixture(scope="module", params=sorted(KV))
def jax_run(mm, request):
    with _env(**KV[request.param]):
        eng = JEngine(mm.jcfg, mm.jparams, JEngineConfig(**ENGINE_KW),
                      cross_seq_len=mm.Lv)
        fins = _drive(eng, _requests(mm), JParams(
            temperature=0.0, max_new_tokens=8, logprobs=2))
    return request.param, fins


def test_engine_matches_jax_engine(mm, jax_run):
    kv, want = jax_run
    with _env(**KV[kv]):
        eng = _port_engine(mm)
        # the closed set takes the run (warmed on the bf16 pool only: the
        # int8 one builds the same keys)
        warmed = eng.warm_executables() if kv == "bf16" else None
        got = _drive(eng, _requests(mm),
                     SamplingParams(temperature=0.0, max_new_tokens=8))
    assert eng._kv_quant == (kv == "int8")
    assert warmed in (None, eng.n_executables)   # 0 recompiles
    assert eng.cache.allocator.n_free == eng.ecfg.total_blocks - 1
    assert len(eng.cache.kv) == 2      # the pool skips the cross layers
    assert [f.n_prompt for f in got] == [f.n_prompt for f in want]
    assert_greedy_parity(got, want, label=f"mllama engine, {kv} KV")


def test_engine_cross_semantics(mm):
    """In the port alone: states past cross_len change nothing, an image
    changes the tokens, async equals lock-step."""
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    reqs = _requests(mm)
    prompt, states, half = reqs[2]
    clean = states.copy()
    clean[half:] = 0.0
    with _env():
        runs = [_drive(_port_engine(mm), [(prompt, s, half)], sp)[0]
                for s in (states, clean)]
        assert runs[0].token_ids == runs[1].token_ids
        img, text = (_drive(_port_engine(mm), [(reqs[0][0], s, 0)], sp)[0]
                     for s in (reqs[0][1], None))
        assert img.token_ids != text.token_ids
        async_run = _drive(_port_engine(mm), reqs, sp)
    with _env(SHAI_ASYNC_DECODE="0"):
        sync_run = _drive(_port_engine(mm), reqs, sp)
    assert [f.token_ids for f in async_run] == [f.token_ids for f in sync_run]


def test_engine_speculative_equals_spec_off(mm):
    """Verify's cross tail keeps greedy spec-on equal to spec-off, through
    the warmed verify ladder."""
    states = _states(mm, 13)
    reqs = [(([7, 11, 13] * 4)[:10], states, mm.Lv),
            ([7, 11, 13, 7, 11], None, 0)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=8)
    with _env():
        off = _drive(_port_engine(mm), reqs, sp)
        eng = _port_engine(mm, speculative_model="[ngram]",
                           num_speculative_tokens=3)
        eng.warm_executables()
        warmed = eng.n_executables
        on = _drive(eng, reqs, sp)
    assert [f.token_ids for f in on] == [f.token_ids for f in off]
    assert eng.spec.verify_steps > 0 and eng.n_executables == warmed


# -- the checkpoint and the unit ----------------------------------------------


def _write_dir(mm, path: Path, old_layout: bool, stats: bool):
    import chip_smoke

    path.mkdir(parents=True)
    sd = dict(mm.sd)
    if old_layout:
        sd = {("language_model.model." + k[len("model.language_model."):]
               if k.startswith("model.language_model.")
               else "language_model.lm_head.weight" if k == "lm_head.weight"
               else k[len("model."):] if k.startswith("model.") else k): v
              for k, v in sd.items()}
    save_safetensors({k: v.contiguous() for k, v in sd.items()},
                     path / "model.safetensors")
    (path / "config.json").write_text(json.dumps(mm.hf.config.to_dict()))
    if stats:
        (path / "preprocessor_config.json").write_text(json.dumps(
            {"image_mean": [0.5, 0.5, 0.5], "image_std": [0.25, 0.5, 0.75]}))
    chip_smoke._write_tokenizer(path, merges_wanted=N_MERGES)


@pytest.fixture(scope="module")
def ckpt_dirs(mm, tmp_path_factory):
    base = tmp_path_factory.mktemp("mllama")
    _write_dir(mm, base / "new", False, True)
    _write_dir(mm, base / "old", True, False)
    return base


@pytest.mark.parametrize("layout", ["new", "old"])
def test_checkpoint_equals_reference_converters(mm, ckpt_dirs, layout):
    cfg, state, vcfg, vstate, meta = load_mllama_checkpoint(
        ckpt_dirs / layout, "cpu")
    assert cfg == mm.tcfg and vcfg == mm.tvcfg
    assert meta["supported_aspect_ratios"] == mm.supported
    if layout == "new":
        assert meta["image_mean"] == (0.5, 0.5, 0.5)
    else:
        assert meta["image_mean"] == tmllama.CLIP_MEAN
    # HF's embedding carries 8 image-token rows past the vocabulary
    assert state["embed.weight"].shape[0] == cfg.vocab_size + 8
    for got, want in ((state, mm.tstate), (vstate, mm.vstate)):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == torch.bfloat16, k
            assert torch.equal(got[k], v.to(torch.bfloat16)), k


def _serve_cfg(path, tmp):
    return ServeConfig(app="vllm", model_id=str(path), device="cpu",
                       max_seq_len=32, max_new_tokens=8,
                       artifact_root=str(tmp / "artifacts"),
                       vllm_config=str(tmp / "absent.yaml"))


def test_unit_serves_png_image(mm, ckpt_dirs, tmp_path):
    conf = json.loads((ckpt_dirs / "new" / "tokenizer_config.json")
                      .read_text())
    conf["chat_template"] = "{% for m in messages %}{{ m.content }}{% endfor %}"
    (ckpt_dirs / "new" / "tokenizer_config.json").write_text(json.dumps(conf))
    with _env():
        svc = VllmService(_serve_cfg(ckpt_dirs / "new", tmp_path))
        svc.load()
    try:
        assert svc._mllama is not None
        assert svc._engine.cross_seq_len == mm.Lv
        import chip_smoke

        rng = np.random.default_rng(3)
        png = base64.b64encode(chip_smoke._png_bytes(rng.integers(
            0, 256, (40, 70, 3), np.uint8))).decode()
        base = {"prompt": "the quick brown fox", "temperature": 0.0,
                "max_new_tokens": 6, "logprobs": 1}
        text = svc.infer(base)
        img = svc.infer(dict(base, image_b64=png))
        again = svc.infer(dict(base, image_b64=png))
        rand = svc.infer(dict(base, image_b64="random"))
        ids = [[e["token"] for e in r["logprobs"]] for r in (text, img,
                                                             again, rand)]
        assert all(len(i) == 6 for i in ids)
        assert ids[1] != ids[0] and ids[1] == ids[2]
        jpeg = base64.b64encode(b"\xff\xd8\xff\xe0" + bytes(64)).decode()
        for bad, words in ((jpeg, "JPEG"),
                           (base64.b64encode(b"nonsense").decode(), "PNG"),
                           ("!!not base64!!", "base64")):
            with pytest.raises(HTTPError) as e:
                svc.infer(dict(base, image_b64=bad))
            assert e.value.status == 400 and words in str(e.value)
        chat = dict((r, fn) for r, _, fn in svc.extra_routes())[
            "/v1/chat/completions"]
        req = types.SimpleNamespace(json=lambda: {
            "messages": [{"role": "user", "content": "hi"}]})
        with pytest.raises(HTTPError) as e:
            chat(req)
        assert e.value.status == 501
    finally:
        svc.close()


def test_text_unit_refuses_an_image(tmp_path):
    """A text checkpoint (no vision tower) answers an image with the
    reference's 400 (the tiny tier carries a tower, as the reference's
    does, so the text model here is a Llama directory)."""
    import chip_smoke
    from scalable_hw_agnostic_inference_tpu_torch.models.convert import (
        hf_name,
    )

    cfg = tllama.LlamaConfig(vocab_size=320, dim=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                             rope_theta=10000.0)
    path = tmp_path / "text"
    path.mkdir()
    state = tllama.random_params(cfg, seed=0, device="cpu")
    save_safetensors({hf_name(k): v.contiguous() for k, v in state.items()},
                     path / "model.safetensors")
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": 320, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 256, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5}))
    chip_smoke._write_tokenizer(path, merges_wanted=N_MERGES)
    with _env():
        svc = VllmService(_serve_cfg(path, tmp_path))
        svc.load()
    try:
        assert svc._vision is None and svc._mllama is None
        with pytest.raises(HTTPError) as e:
            svc.infer({"prompt": "hi", "image_b64": "random"})
        assert e.value.status == 400 and "vision" in str(e.value)
    finally:
        svc.close()
