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
  the same ``/v1/chat/completions`` fallback prompt;
- a JAX pod and a port pod over sockets on a copy whose
  ``tokenizer_config.json`` carries Meta-Llama-3-8B-Instruct's template:
  ``/generate`` with ``"add_special_tokens": false`` gives the reference's
  ``n_prompt`` (one less than with it) and greedy tokens, and an empty
  prompt without them its 400; the chat route renders the reference's
  prompt, tokenizes it with one BOS, and gives ``/generate``'s tokens of
  the rendered text without special tokens, buffered and streamed, with
  the reference's usage and its 400s for bad ``messages``;
- what is not ported raises, naming it: a hub id, a directory of
  ``pytorch_model.bin`` only, a SentencePiece-style ``tokenizer.json``
  whose ``Replace`` decoder has no pattern.
"""

import json
import shutil
import sys
import time
import types
import urllib.error
import urllib.request
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
import chat_templates  # noqa: E402
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
        assert not templated and tsvc._chat_prompt(MESSAGES) == (text, False)
    finally:
        jsvc.loop.stop()
        tsvc.close()


def _http(url, payload=None, timeout=120.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read().decode()
            if r.headers.get("content-type", "").startswith(
                    "text/event-stream"):
                return r.status, body
            return r.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _sse_text(body: str) -> str:
    out = []
    for line in body.splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            out.append(json.loads(line[6:])["choices"][0]["delta"].get(
                "content") or "")
    return "".join(out)


#: what ``_serve_cfg``'s pods derive (``max_seq_len`` 32, 8 new tokens),
#: with one slot over the pool of four
ONE_SLOT = {"max_model_len": 48, "max_num_seqs": 1, "block_size": 16,
            "num_blocks": 13, "context_encoding_buckets": [32],
            "max_new_tokens": 8}


@pytest.fixture(scope="module")
def chat_pods(ckpts, tmp_path_factory):
    """A JAX pod and a port pod, each behind its package's server, on a copy
    of the bf16 directory whose ``tokenizer_config.json`` carries
    Meta-Llama-3-8B-Instruct's template."""
    from scalable_hw_agnostic_inference_tpu.models.registry import get_model
    from scalable_hw_agnostic_inference_tpu.serve.app import (
        create_app as jcreate_app,
    )
    from scalable_hw_agnostic_inference_tpu.serve.httpd import (
        Server as JServer,
    )
    from scalable_hw_agnostic_inference_tpu.utils.env import (
        ServeConfig as JServeConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server

    tmp = tmp_path_factory.mktemp("chat")
    path = tmp / "templated"
    shutil.copytree(ckpts["single"], path)
    conf = json.loads((path / "tokenizer_config.json").read_text())
    conf["chat_template"] = chat_templates.LLAMA3_8B_INSTRUCT
    (path / "tokenizer_config.json").write_text(json.dumps(conf))
    # the engine shapes the pods would derive, in one slot: requests come
    # one at a time, and the JAX pod compiles a third of the executables
    (tmp / "one-slot.json").write_text(json.dumps(ONE_SLOT))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SHAI_PAGED_DECODE", "1")
        jcfg = _serve_cfg(JServeConfig, path, tmp, False)
        cfg = _serve_cfg(ServeConfig, path, tmp, False)
        jcfg.vllm_config = cfg.vllm_config = str(tmp / "one-slot.json")
        jsvc = get_model("vllm")(jcfg)
        jsrv = JServer(jcreate_app(jcfg, jsvc), host="127.0.0.1", port=0)
        tsvc = VllmService(cfg)
        tsrv = Server(create_app(cfg, tsvc), host="127.0.0.1", port=0)
        urls = []
        for srv in (jsrv, tsrv):
            # one load at a time: transformers' loading patches torch's
            # parameter registration process-wide
            urls.append("http://%s:%d" % srv.start_background())
            t0 = time.monotonic()
            while (status := _http(urls[-1] + "/readiness")[0]) != 200:
                assert status != 500 and time.monotonic() - t0 < 300, \
                    f"{urls[-1]} failed its load"
                time.sleep(0.1)
    try:
        yield types.SimpleNamespace(ref=urls[0], port=urls[1], jsvc=jsvc,
                                    tsvc=tsvc)
    finally:
        tsrv.stop()
        jsrv.stop()


def test_generate_without_special_tokens_equals_reference(chat_pods):
    """``/generate`` reads ``add_special_tokens`` as the reference does:
    without it the prompt has no BOS, ``n_prompt`` one less."""
    bos = chat_pods.tsvc.tokenizer.bos_token_id
    for prompt in (CORPUS[0], "<|begin_of_text|>numbers 12345"):
        outs = {}
        for add in (True, False):
            payload = {"prompt": prompt, "temperature": 0.0,
                       "max_new_tokens": 8, "logprobs": 2,
                       "add_special_tokens": add}
            (sj, want), (st, got) = (_http(url + "/generate", payload)
                                     for url in (chat_pods.ref,
                                                 chat_pods.port))
            assert sj == st == 200, (want, got)
            assert got["n_prompt"] == want["n_prompt"], add
            assert_greedy_parity([_finished(got)], [_finished(want)],
                                 label=f"add_special_tokens={add}")
            outs[add] = got
        assert outs[True]["n_prompt"] == outs[False]["n_prompt"] + 1
        assert chat_pods.tsvc._encode(prompt)[0] == bos
        assert chat_pods.tsvc._encode(prompt, add_special=False) == \
            chat_pods.jsvc._encode(prompt, add_special=False)
    # nothing left to tokenize: the reference's 400
    payload = {"prompt": "", "add_special_tokens": False}
    assert _http(chat_pods.ref + "/generate", payload)[0] == \
        _http(chat_pods.port + "/generate", payload)[0] == 400


CHAT_MESSAGES = [{"role": "system", "content": "  Be brief. "},
                 {"role": "user", "content": "Café? 🚀"},
                 {"role": "assistant", "content": "Oui."},
                 {"role": "user", "content": "numbers 12345"}]


def test_chat_template_route_equals_reference(chat_pods):
    """The chat route renders the template as the reference does and
    tokenizes it with one BOS (the template's): its tokens are a
    ``/generate`` of the rendered text without special tokens."""
    jsvc, tsvc = chat_pods.jsvc, chat_pods.tsvc
    text, templated = tsvc._chat_prompt(CHAT_MESSAGES)
    assert (text, templated) == jsvc._chat_prompt(CHAT_MESSAGES)
    assert templated and text.startswith("<|begin_of_text|><|start_header_"
                                         "id|>system<|end_header_id|>\n\n"
                                         "Be brief.<|eot_id|>")
    ids = tsvc._encode(text, add_special=False)
    assert ids == jsvc._encode(text, add_special=False)
    bos = tsvc.tokenizer.bos_token_id
    assert ids[0] == bos and ids.count(bos) == 1
    gen = {"prompt": text, "temperature": 0.0, "max_new_tokens": 8,
           "logprobs": 2, "add_special_tokens": False}
    (sj, want), (st, got) = (_http(url + "/generate", gen)
                             for url in (chat_pods.ref, chat_pods.port))
    assert sj == st == 200 and got["n_prompt"] == want["n_prompt"] == len(ids)
    assert_greedy_parity([_finished(got)], [_finished(want)],
                         label="chat template")
    body = {"messages": CHAT_MESSAGES, "max_tokens": 8, "temperature": 0}
    chats = [_http(url + "/v1/chat/completions", body)
             for url in (chat_pods.ref, chat_pods.port)]
    streams = [_http(url + "/v1/chat/completions", dict(body, stream=True))
               for url in (chat_pods.ref, chat_pods.port)]
    assert [c[0] for c in chats + streams] == [200] * 4
    (_, jchat), (_, tchat) = chats
    assert tchat["usage"] == jchat["usage"]
    assert tchat["usage"]["prompt_tokens"] == len(ids)
    # the port's chat tokens are its /generate's of the rendered text
    assert tchat["choices"][0]["message"]["content"] == \
        got["generated_text"]
    if _finished(got).token_ids == _finished(want).token_ids:
        assert jchat["choices"][0]["message"]["content"] == \
            want["generated_text"] == got["generated_text"]
        assert _sse_text(streams[0][1]) == _sse_text(streams[1][1])
    # the reference's 400s, before any template renders
    for bad in ({}, {"messages": []}, {"messages": [{"role": "user"}]},
                {"messages": "hello"}):
        assert _http(chat_pods.ref + "/v1/chat/completions", bad)[0] == \
            _http(chat_pods.port + "/v1/chat/completions", bad)[0] == 400


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
