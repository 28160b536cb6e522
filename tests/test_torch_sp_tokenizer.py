"""The port's SentencePiece-style BPE (``models/tokenizer.py``) against
``transformers``' ``AutoTokenizer`` on the same files, on the CPU.

The JAX package tokenizes a LLaVA directory through ``AutoTokenizer``
(``serve/units/causal_lm.py:79-80``), so that is the yardstick. Tiny
Llama-2-style ``tokenizer.json`` files are built here with ``tokenizers``
(trained on a small corpus, no download): the legacy spelling
(``Prepend("▁"), Replace(" ", "▁")`` normalizer, ``Replace, ByteFallback,
Fuse, Strip`` decoder) and the ``Metaspace`` one (prepend scheme
``first``, ``always`` and ``never``, ``split`` on and off), byte
fallback to ``<0xXX>`` tokens, fused ``<unk>``, added ``<s>``, ``</s>``,
``<unk>``, ``<image>``, ``<pad>`` (not normalized) and one normalized
token, with a ``LlamaTokenizerFast`` config. Ids of ASCII, whitespace
runs, CJK, emoji (byte fallback), added tokens and the empty string, and
the text of those ids and of byte runs that are not UTF-8, with and
without special tokens, equal ``AutoTokenizer``'s. The tokenizer that
``chip_smoke.py`` writes into its LLaVA directory loads and tokenizes
alike, and a SentencePiece Unigram model still raises, naming it.
"""

import json
import sys
from pathlib import Path

import pytest

from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    BpeTokenizer,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

SP = "▁"
CORPUS = ["the quick brown fox jumps over the lazy dog",
          "hello world, hello there!",
          "USER: what is in the image? ASSISTANT: a cat on a mat",
          "numbers 12345 and 6789", "  leading spaces and trailing  ",
          "tabs\tand\nnewlines"] * 20
TEXTS = ["the quick brown fox", "  two  leading", "trailing  ", "a  b   c",
         "\n\ttabs\n", "你好世界 and 日本語", "emoji 🙂👍🏽!",
         "<image>\nUSER: what is this? ASSISTANT:", "x<image>y",
         "<s>hello</s>", "", " ", "hello <extra> world", "<extra>",
         "zzz qqq ÿ ©", "the<pad>lazy  dog"]
CONFIG = {"tokenizer_class": "LlamaTokenizerFast", "bos_token": "<s>",
          "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
          "add_bos_token": True, "add_eos_token": False, "legacy": False,
          "clean_up_tokenization_spaces": False}


def _build(tmp: Path, kind: str, scheme: str = "first",
           split: bool = False) -> Path:
    from tokenizers import (
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
        trainers,
    )

    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True,
                               fuse_unk=True))
    if kind == "legacy":
        tok.normalizer = normalizers.Sequence(
            [normalizers.Prepend(SP), normalizers.Replace(" ", SP)])
        tok.decoder = decoders.Sequence(
            [decoders.Replace(SP, " "), decoders.ByteFallback(),
             decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement=SP, prepend_scheme=scheme, split=split)
        tok.decoder = decoders.Metaspace(replacement=SP,
                                         prepend_scheme=scheme, split=split)
    specials = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>"
                                          for b in range(256)]
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=420, special_tokens=specials, show_progress=False))
    spec = json.loads(tok.to_str())
    # the byte tokens live in the model's vocabulary, not as added tokens
    spec["added_tokens"] = [t for t in spec["added_tokens"]
                            if not t["content"].startswith("<0x")]
    n = len(spec["model"]["vocab"])
    flags = {"single_word": False, "lstrip": False, "rstrip": False}
    spec["added_tokens"] += [
        dict(flags, id=n, content="<image>", normalized=False, special=True),
        dict(flags, id=n + 1, content="<pad>", normalized=False,
             special=True),
        dict(flags, id=n + 2, content="<extra>", normalized=True,
             special=False)]
    bos = {"SpecialToken": {"id": "<s>", "type_id": 0}}
    spec["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
        "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}},
                 {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                   "tokens": ["<s>"]}}}
    d = tmp / f"{kind}-{scheme}-{split}"
    d.mkdir()
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (d / "tokenizer_config.json").write_text(json.dumps(CONFIG))
    return d


def _pair(d: Path):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(str(d)), BpeTokenizer.from_dir(d)


def _decode_cases(port):
    v = port.vocab
    return [[v["<0xE4>"], v["<0xB8>"]], [v["<0xFF>"]],
            [v["<0xE4>"], v["<0xB8>"], v["<0xAD>"], v["<0xFF>"], 5,
             v["<0xC3>"]], [1, 5, 2, v["<0x41>"]], [0, 0, 7],
            [v["<0x0A>"], v[SP] if SP in v else 5, 2]]


@pytest.mark.parametrize("layout", [("legacy",), ("metaspace", "first", False),
                                    ("metaspace", "first", True),
                                    ("metaspace", "always", True),
                                    ("metaspace", "never", False)],
                         ids=lambda a: "-".join(map(str, a)))
def test_ids_and_text_equal_autotokenizer(tmp_path, layout):
    hf, port = _pair(_build(tmp_path, *layout))
    assert port.sp is not None
    assert (port.bos_token_id, port.eos_token_id, port.pad_token_id) == (
        hf.bos_token_id, hf.eos_token_id, hf.pad_token_id)
    for text in TEXTS:
        want = hf(text)["input_ids"]
        assert port.encode(text) == want, text
        assert port.encode(text, add_special_tokens=False) == hf(
            text, add_special_tokens=False)["input_ids"], text
        for skip in (True, False):
            assert port.decode(want, skip_special_tokens=skip) == hf.decode(
                want, skip_special_tokens=skip), (text, skip)
    for ids in _decode_cases(port):
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), (ids, skip)
    # truncation keeps BOS, as the fast tokenizer's does
    long = " ".join(CORPUS[:3])
    assert port.encode(long, max_length=7) == hf(
        long, truncation=True, max_length=7)["input_ids"]


def test_chip_smoke_llava_tokenizer_equals_autotokenizer(tmp_path):
    from transformers import AutoTokenizer

    chip_smoke._write_sp_tokenizer(tmp_path)
    hf = AutoTokenizer.from_pretrained(str(tmp_path))
    port = BpeTokenizer.from_dir(tmp_path)
    assert len(port.vocab) == 32000 and port.added["<image>"] == 32000
    for text in TEXTS + ["USER: <image>\nimage 3: describe it in detail. "
                         "ASSISTANT:"]:
        ids = hf(text)["input_ids"]
        assert port.encode(text) == ids, text
        assert port.decode(ids) == hf.decode(ids, skip_special_tokens=True)


def test_unigram_still_raises(tmp_path):
    spec = json.loads((_build(tmp_path, "legacy") / "tokenizer.json"
                       ).read_text())
    spec["model"] = {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0]],
                     "byte_fallback": True}
    with pytest.raises(ValueError, match="not ported.*Unigram"):
        BpeTokenizer(spec)
