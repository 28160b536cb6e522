"""The port's WordPiece tokenizer (``models/tokenizer.py``
``WordPieceTokenizer``) against ``transformers``' ``BertTokenizerFast``.

A synthetic BERT vocabulary (the special tokens, letters and digits with
their ``##`` forms, a few whole words and suffixes, punctuation, some CJK
ideographs and accented letters) is written here as a ``tokenizer.json``
built by ``tokenizers`` (``BertNormalizer``, ``BertPreTokenizer``,
``WordPiece``, ``[CLS] $A [SEP]``; once more with ``BertProcessing``) and
as a ``vocab.txt``-only directory, which ``BertTokenizerFast`` converts as
``transformers``' ``BertConverter`` does. Uncased, cased and cased with
accents stripped. Over every test string (accents, CJK, punctuation and
ASCII symbols, control and zero-width characters, Unicode whitespace,
special tokens in the text, a word past ``max_input_chars_per_word``,
characters outside the vocabulary) the ids and the attention mask padded
to ``max_length`` are equal, truncated or not.
"""

import json

import pytest

from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    BpeTokenizer,
    WordPieceTokenizer,
)

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
WORDS = ["hello", "world", "test", "play", "token", "bert", "the", "un",
         "caf", "naive", "over", "long", "snow", "man", "zero", "width"]
SUFFIXES = ["##s", "##ing", "##ed", "##er", "##izer", "##able", "##e",
            "##é", "##ve"]
CJK = ["我", "爱", "北", "京", "〇"]
ACCENTED = ["é", "ï", "à", "ü", "Ω", "σ", "ς", "i̇", "İ"]


def _vocab():
    toks = list(SPECIALS)
    for c in "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789":
        toks += [c, "##" + c]
    toks += WORDS + [w.capitalize() for w in WORDS] + SUFFIXES
    toks += list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~§¶«»") + CJK + ACCENTED
    out = {}
    for t in toks:
        out.setdefault(t, len(out))
    return out


TEXTS = [
    "",
    "Hello world",
    "hello, world! (testing)... $5+3=8 <tag> a|b ~c^d `e`",
    "Café Déjà naïve ÜBER",
    "我爱北京 天安门〇",
    "tab\there\x07bell\x00null​zero�width",
    "ideographic　space\xa0nbsp em line",
    "[CLS] inside [MASK] text [SEP][PAD]",
    "a" * 101 + " " + "b" * 100,
    "☃ snowman ∑ sum ΣΑΣ İstanbul",
    "playing played tokenizer unplayable",
    "HELLO\nWORLD\r\nTest",
    "«quoted» §12 ¶3",
]

#: normalizer settings: (lowercase, strip_accents)
CASINGS = {"uncased": (True, None), "cased": (False, None),
           "cased_stripped": (False, True)}


def _tokenizers_file(path, lowercase, strip_accents, bert_processing):
    from tokenizers import Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers, processors

    vocab = _vocab()
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]",
                                     max_input_chars_per_word=100))
    tok.normalizer = normalizers.BertNormalizer(
        clean_text=True, handle_chinese_chars=True,
        strip_accents=strip_accents, lowercase=lowercase)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    cls, sep = vocab["[CLS]"], vocab["[SEP]"]
    if bert_processing:
        tok.post_processor = processors.BertProcessing(("[SEP]", sep),
                                                       ("[CLS]", cls))
    else:
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", cls), ("[SEP]", sep)])
    tok.decoder = decoders.WordPiece(prefix="##")
    tok.add_special_tokens(SPECIALS)
    path.mkdir(parents=True, exist_ok=True)
    tok.save(str(path / "tokenizer.json"))


def _config(path, lowercase, strip_accents):
    cfg = {"do_lower_case": lowercase, "model_max_length": 512,
           "tokenize_chinese_chars": True, "unk_token": "[UNK]",
           "sep_token": "[SEP]", "pad_token": "[PAD]",
           "cls_token": "[CLS]", "mask_token": "[MASK]",
           "tokenizer_class": "BertTokenizer"}
    if strip_accents is not None:
        cfg["strip_accents"] = strip_accents
    (path / "tokenizer_config.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """``(port, BertTokenizerFast)`` by layout and casing."""
    from transformers import BertTokenizerFast

    out = {}
    root = tmp_path_factory.mktemp("wordpiece")
    for casing, (lower, strip) in CASINGS.items():
        for layout in ("tokenizer_json", "bert_processing", "vocab_txt"):
            path = root / f"{casing}_{layout}"
            if layout == "vocab_txt":
                path.mkdir()
                (path / "vocab.txt").write_text(
                    "\n".join(_vocab()) + "\n", encoding="utf-8")
            else:
                _tokenizers_file(path, lower, strip,
                                 layout == "bert_processing")
            _config(path, lower, strip)
            out[casing, layout] = (WordPieceTokenizer.from_dir(path),
                                   BertTokenizerFast.from_pretrained(
                                       str(path)))
    return out


@pytest.mark.parametrize("layout", ["tokenizer_json", "bert_processing",
                                    "vocab_txt"])
@pytest.mark.parametrize("casing", sorted(CASINGS))
@pytest.mark.parametrize("text", range(len(TEXTS)))
def test_ids_and_masks_equal_bert_tokenizer_fast(pairs, casing, layout,
                                                 text):
    port, hf = pairs[casing, layout]
    s = TEXTS[text]
    assert port.encode(s) == hf(s)["input_ids"], repr(s)
    for n in (4, 8, 64):
        got = port(s, padding="max_length", truncation=True, max_length=n)
        want = hf(s, padding="max_length", truncation=True, max_length=n)
        assert got["input_ids"] == want["input_ids"], (repr(s), n)
        assert got["attention_mask"] == want["attention_mask"], (repr(s), n)


def test_long_word_and_unknown_characters_are_unk(pairs):
    port, hf = pairs["uncased", "tokenizer_json"]
    unk, cls, sep = (port.vocab[t] for t in ("[UNK]", "[CLS]", "[SEP]"))
    assert port.encode("a" * 101) == [cls, unk, sep]
    assert port.encode("a" * 100)[1:-1] == [port.vocab["a"]] + \
        [port.vocab["##a"]] * 99
    assert port.encode("天") == [cls, unk, sep] == hf("天")["input_ids"]
    assert port.pad_token_id == port.vocab["[PAD]"] == hf.pad_token_id
    assert port.model_max_length == 512


def test_other_pipelines_are_refused(tmp_path):
    _tokenizers_file(tmp_path, True, None, False)
    spec = json.loads((tmp_path / "tokenizer.json").read_text())
    for key, bad in (("normalizer", {"type": "Lowercase"}),
                     ("pre_tokenizer", {"type": "Whitespace"})):
        with pytest.raises(ValueError, match="not ported"):
            WordPieceTokenizer.from_spec({**spec, key: bad})
    with pytest.raises(ValueError, match="not WordPiece"):
        WordPieceTokenizer.from_spec({**spec, "model": {"type": "BPE"}})
    with pytest.raises(ValueError, match="WordPieceTokenizer"):
        BpeTokenizer(spec)
    with pytest.raises(ValueError, match="no tokenizer.json or vocab.txt"):
        WordPieceTokenizer.from_dir(tmp_path / "absent")


def test_chip_smoke_vocabulary_equals_bert_tokenizer_fast(tmp_path):
    """``chip_smoke.py``'s synthetic DistilBERT tokenizer (30,522 pieces,
    the ``tokenizer.json`` it writes by hand) read by both tokenizers."""
    import sys
    from pathlib import Path

    from transformers import BertTokenizerFast

    sys.path.insert(0, str(Path(__file__).parent.parent))
    import chip_smoke

    vocab = chip_smoke._wordpiece_vocab(30522)
    assert len(vocab) == 30522 and vocab["[UNK]"] == 1
    (tmp_path / "tokenizer.json").write_text(
        json.dumps(chip_smoke._wordpiece_spec(vocab)), encoding="utf-8")
    _config(tmp_path, True, None)
    port = WordPieceTokenizer.from_dir(tmp_path)
    hf = BertTokenizerFast.from_pretrained(str(tmp_path))
    for s in chip_smoke.ENCODER_TEXTS + tuple(TEXTS):
        got = port(s, padding="max_length", truncation=True, max_length=64)
        want = hf(s, padding="max_length", truncation=True, max_length=64)
        assert got == {k: want[k] for k in got}, repr(s)
