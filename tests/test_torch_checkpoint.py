"""Serving a local Llama checkpoint directory: the port against
``transformers``, ``safetensors``, ``tokenizers`` and the JAX package, on
the CPU.

The test writes a tiny HF Llama with ``save_pretrained`` (its weights from
a numpy seed), once as one bf16 file with tied embeddings and once f32,
untied, with llama3 rope scaling and sharded in three, and beside each a
byte-level BPE trained by ``tokenizers`` with Llama-3's ``Split`` regex,
its BOS template and special tokens. What is held:

- the safetensors reader equals ``safetensors.torch.load_file``, file by
  file, and the writer's files read back equal under both;
- the converted state dict (bf16, and int8 at boot) equals the JAX
  package's ``params_from_torch`` -> ``cast_f32_to_bf16`` (->
  ``quantize_params_tree``) -> ``params_from_jax``, bit for bit, and the
  config equals ``LlamaConfig.from_hf``;
- the tokenizer equals ``AutoTokenizer`` on encode (with and without the
  template), truncation at several caps, and decode (whole and every
  prefix, so cut UTF-8 gives the same U+FFFD), over ASCII, accented
  Latin, CJK, emoji, digit runs, contractions in both cases, whitespace
  and newline runs and special tokens in the text;
- a JAX pod and a port pod on the same ``MODEL_ID=<dir>``, bf16 and int8,
  give equal ``/generate`` greedy tokens and text, or part only at a bf16
  tie (``tests/parity.py``'s rule on the JAX side's top-2 logprobs), and
  the same ``/v1/chat/completions`` fallback prompt; a ``chat_template``
  makes the port's chat route 501;
- what is not ported raises, naming it: a hub id, a directory of
  ``pytorch_model.bin`` only, a SentencePiece-style ``tokenizer.json``
  whose ``Replace`` decoder has no pattern.
"""

import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from scalable_hw_agnostic_inference_tpu.models import convert as jconvert
from scalable_hw_agnostic_inference_tpu.models import llama as jllama
from scalable_hw_agnostic_inference_tpu.ops import quant as jquant
from scalable_hw_agnostic_inference_tpu_torch.core import checkpoint as ckpt
from scalable_hw_agnostic_inference_tpu_torch.models import convert
from scalable_hw_agnostic_inference_tpu_torch.models import llama as tllama
from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    LLAMA3_SPLIT,
    BpeTokenizer,
)
from scalable_hw_agnostic_inference_tpu_torch.serve.asgi import HTTPError
from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
    VllmService,
)
from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig

sys.path.insert(0, str(Path(__file__).resolve().parent))
from parity import assert_greedy_parity  # noqa: E402

SPECIAL = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
           "<|start_header_id|>"]
CORPUS = [
    "Hello world! It's a test, isn't it? We'RE here, they'LL go; I'M done.",
    "Café déjà vu, naïve façade — Ærøskøbing, Ångström, Straße, œuvre.",
    "日本語のテキストと中文文本，한국어 텍스트。",
    "Emoji 🚀🔥👍🏽 family 👨‍👩‍👧 flags 🇫🇷 and ✨ sparkles.",
    "Numbers 1234567 and 3.14159, 1,000,000 and 2024-10-17 at 12:30.",
    "Tabs\tand  double  spaces   and\n\nnewlines\r\n and \n  \n trailing   ",
    "code: def f(x):\n    return x ** 2  # comment\n",
    "<|begin_of_text|>special<|eot_id|> tokens <|end_of_text|>in text",
    "DON'T can't WON'T Y'ALL 'S 's 'sup O'Neil rock'n'roll she'D",
    "\xa0nbsp　ideographic em space​zero-width",
    "Mixed123abc ABC123 a1b2c3 ½ ² Ⅻ ٣٤٥ ' ?!\r\n!!!\n\n",
]
VOCAB = 640   # the model's rows; the tokenizer's vocab is 600


def _tokenizer_files(path: Path) -> None:
    from tokenizers import (
        Regex,
        Tokenizer,
        decoders,
        models,
        pre_tokenizers,
        processors,
        trainers,
    )
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_SPLIT), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS * 20, trainers.BpeTrainer(
        vocab_size=600, special_tokens=SPECIAL, min_frequency=1,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    bos = tok.token_to_id(SPECIAL[0])
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single=f"{SPECIAL[0]} $A", pair=f"{SPECIAL[0]} $A {SPECIAL[0]} $B",
            special_tokens=[(SPECIAL[0], bos)])])
    PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token=SPECIAL[0], eos_token=SPECIAL[1],
        clean_up_tokenization_spaces=True).save_pretrained(path)


def _write_checkpoint(path: Path, tie: bool, dtype, shards: int,
                      rope_scaling=None) -> None:
    import transformers

    cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=tie, rope_scaling=rope_scaling,
        bos_token_id=0, eos_token_id=1)
    model = transformers.LlamaForCausalLM(cfg)
    rng = np.random.default_rng(11 + shards)
    with torch.no_grad():
        for name, p in model.named_parameters():
            base = 1.0 if name.endswith("norm.weight") else 0.0
            p.copy_(torch.from_numpy(
                base + 0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    model.to(dtype).save_pretrained(
        path, max_shard_size="200KB" if shards > 1 else "10GB")
    _tokenizer_files(path)


LLAMA3_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    single, sharded = root / "single", root / "sharded"
    _write_checkpoint(single, True, torch.bfloat16, 1)
    _write_checkpoint(sharded, False, torch.float32, 3, LLAMA3_ROPE)
    assert len(list(sharded.glob("*.safetensors"))) > 1
    assert (sharded / ckpt.INDEX).is_file()
    return {"single": single, "sharded": sharded}


@pytest.mark.parametrize("which", ["single", "sharded"])
def test_reader_equals_safetensors(ckpts, which):
    from safetensors.torch import load_file

    c = ckpt.Checkpoint(ckpts[which])
    seen = set()
    for f in sorted(ckpts[which].glob("*.safetensors")):
        want = load_file(str(f))
        for name, t in want.items():
            got = c.tensor(name, "cpu")
            assert got.dtype == t.dtype and torch.equal(got, t), name
            assert c.shape(name) == tuple(t.shape)
        seen |= set(want)
    assert seen == set(c.keys())


def test_writer_round_trips(tmp_path):
    from safetensors.torch import load_file

    rng = np.random.default_rng(3)
    tensors = {
        "a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal(9).astype(np.float32)
                              ).to(torch.bfloat16),
        "c": torch.from_numpy(rng.integers(-127, 128, (3, 16), np.int8)),
        "d": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float16)),
    }
    ckpt.save_safetensors(tensors, tmp_path / "one.safetensors")
    back = load_file(str(tmp_path / "one.safetensors"))
    assert all(torch.equal(back[k], v) for k, v in tensors.items())
    ckpt.save_sharded(tensors, tmp_path / "dir", 2)
    c = ckpt.Checkpoint(tmp_path / "dir")
    assert len(c.files) == 2
    assert all(torch.equal(c.tensor(k), v) for k, v in tensors.items())


def _jax_state(path: Path, quant: bool):
    """The JAX package's conversion of the same directory, as a port state
    dict (``transformers`` loads it, as the reference's pod does)."""
    from transformers import AutoModelForCausalLM

    tm = AutoModelForCausalLM.from_pretrained(path)
    mcfg = jllama.LlamaConfig.from_hf(tm.config)
    params = jconvert.cast_f32_to_bf16(jllama.params_from_torch(tm, mcfg))
    if quant:
        params = jquant.quantize_params_tree(params)
    tcfg = tllama.LlamaConfig(**{
        f: getattr(mcfg, f) for f in tllama.LlamaConfig.__dataclass_fields__})
    return mcfg, tllama.params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg)


@pytest.mark.parametrize("which,quant", [("single", False),
                                         ("sharded", False),
                                         ("sharded", True)])
def test_conversion_equals_jax_bit_for_bit(ckpts, which, quant):
    mcfg, want = _jax_state(ckpts[which], quant)
    cfg, got = convert.load_hf_checkpoint(ckpts[which], "cpu",
                                          quantize=quant)
    for f in tllama.LlamaConfig.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(mcfg, f), f
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == want[name].dtype, name
        assert torch.equal(t, want[name]), name
    model = tllama.LlamaForCausalLM.from_state_dict(cfg, got)
    assert model.quantized == quant


def test_tokenizer_equals_autotokenizer(ckpts):
    from transformers import AutoTokenizer

    path = ckpts["single"]
    hf = AutoTokenizer.from_pretrained(path)
    tok = BpeTokenizer.from_dir(path)
    assert (tok.eos_token_id, tok.pad_token_id, tok.bos_token_id) == (
        hf.eos_token_id, hf.pad_token_id, hf.bos_token_id)
    extra = ["'s", "x'S", "'ſ", "  a", " \n a", "a  \n\n  b", "a \t",
             "\r\n\r\n", "    x", "x    ", "123456789", "a\x1cb", ""]
    for text in CORPUS + extra:
        for add in (True, False):
            assert tok.encode(text, add_special_tokens=add) == hf(
                text, add_special_tokens=add)["input_ids"], repr(text)
        for cap in (1, 2, 5, 17):
            assert tok.encode(text, max_length=cap) == hf(
                text, truncation=True, max_length=cap)["input_ids"], \
                (repr(text), cap)
        ids = hf(text)["input_ids"]
        for skip in (True, False):
            assert tok.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), repr(text)
        for k in range(1, len(ids)):
            assert tok.decode(ids[:k]) == hf.decode(
                ids[:k], skip_special_tokens=True), (repr(text), k)
    # ids past the tokenizer's vocabulary (the model has more rows) drop
    assert tok.decode([VOCAB - 1, 5]) == hf.decode([VOCAB - 1, 5],
                                                   skip_special_tokens=True)


def _finished(out):
    """A /generate response as what ``assert_greedy_parity`` reads."""
    return types.SimpleNamespace(
        token_ids=[e["token"] for e in out["logprobs"]],
        logprobs=out["logprobs"])


PROMPTS = [CORPUS[0], CORPUS[2], CORPUS[7], "Ångström " * 40]
MESSAGES = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Café? 🚀"}]


def _serve_cfg(cls, ckpt_dir, tmp, quant):
    return cls(app="vllm", model_id=str(ckpt_dir), device="cpu",
               max_seq_len=32, max_new_tokens=8,
               artifact_root=str(tmp / "artifacts"),
               vllm_config=str(tmp / "absent.yaml"),
               quantization="int8" if quant else "")


@pytest.mark.parametrize("quant", [False, True])
def test_jax_pod_and_port_pod_agree(ckpts, tmp_path, monkeypatch, quant):
    from scalable_hw_agnostic_inference_tpu.models.registry import get_model
    from scalable_hw_agnostic_inference_tpu.utils.env import (
        ServeConfig as JServeConfig,
    )

    path = ckpts["sharded"]
    monkeypatch.setenv("SHAI_PAGED_DECODE", "1")
    jsvc = get_model("vllm")(_serve_cfg(JServeConfig, path, tmp_path, quant))
    jsvc.load()
    tsvc = VllmService(_serve_cfg(ServeConfig, path, tmp_path, quant))
    tsvc.load()
    try:
        assert tsvc._engine.model.quantized == quant
        assert tsvc._engine.max_prompt_len == jsvc._engine.max_prompt_len
        for prompt in PROMPTS:
            assert tsvc._encode(prompt) == jsvc._encode(prompt)
            payload = {"prompt": prompt, "temperature": 0.0,
                       "max_new_tokens": 8, "logprobs": 2}
            want, got = jsvc.infer(payload), tsvc.infer(payload)
            assert got["n_prompt"] == want["n_prompt"]
            assert_greedy_parity([_finished(got)], [_finished(want)],
                                 label=f"pod int8={quant}")
            if _finished(got).token_ids == _finished(want).token_ids:
                assert got["generated_text"] == want["generated_text"]
        text, templated = jsvc._chat_prompt(MESSAGES)
        assert not templated and tsvc._chat_prompt(MESSAGES) == text
    finally:
        jsvc.loop.stop()
        tsvc.close()


def test_chat_template_answers_501(ckpts, tmp_path):
    path = tmp_path / "templated"
    shutil.copytree(ckpts["single"], path)
    conf = json.loads((path / "tokenizer_config.json").read_text())
    conf["chat_template"] = "{% for m in messages %}{{ m.content }}{% endfor %}"
    (path / "tokenizer_config.json").write_text(json.dumps(conf))
    svc = VllmService(_serve_cfg(ServeConfig, path, tmp_path, False))
    svc.load()
    try:
        chat = dict((r, fn) for r, _, fn in svc.extra_routes())[
            "/v1/chat/completions"]
        req = types.SimpleNamespace(json=lambda: {"messages": MESSAGES})
        with pytest.raises(HTTPError) as e:
            chat(req)
        assert e.value.status == 501 and "chat template" in str(e.value)
        # the completions route serves the same pod
        out = svc._openai_generate("Hello", {"max_tokens": 4,
                                             "temperature": 0}, "completion")
        assert out["usage"]["completion_tokens"] >= 1
    finally:
        svc.close()


def test_what_is_not_ported_raises(ckpts, tmp_path):
    svc = VllmService(_serve_cfg(ServeConfig, "meta-llama/Llama-3.2-1B",
                                 tmp_path, False))
    with pytest.raises(ValueError, match="not a directory"):
        svc.load()
    bins = tmp_path / "bins"
    bins.mkdir()
    shutil.copy(ckpts["single"] / "config.json", bins)
    (bins / "pytorch_model.bin").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="pytorch_model.bin"):
        convert.load_hf_checkpoint(bins, "cpu")
    # a SentencePiece-style spec is read since the soft-prefix slice
    # (tests/test_torch_sp_tokenizer.py); a Replace decoder without its
    # pattern is not, and is named
    spec = json.loads((ckpts["single"] / "tokenizer.json").read_text())
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": False}
    spec["decoder"] = {"type": "Sequence", "decoders": [
        {"type": "Replace"}, {"type": "ByteFallback"}, {"type": "Fuse"}]}
    spec["model"]["byte_fallback"] = True
    with pytest.raises(ValueError, match="not ported.*decoder.*Replace"):
        BpeTokenizer(spec)
