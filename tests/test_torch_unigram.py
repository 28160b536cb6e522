"""The port's Unigram tokenizer (``models/tokenizer.py``
``UnigramTokenizer``) against ``transformers``' ``T5TokenizerFast`` on a
``tokenizer.json`` this file builds in T5's layout.

The vocabulary is synthetic (T5's is not part of the repo): ``<pad>``,
``</s>``, ``<unk>`` at ids 0 to 2, the pieces of a seeded corpus with
seeded scores, and ``<extra_id_N>`` appended in reverse as T5's converter
appends them. Two pipelines, each ``transformers``' T5 conversion:

- the current one: ``Sequence[Precompiled, Strip(right), Replace(" {2,}",
  "▁")]``, ``Metaspace(prepend_scheme="always")``;
- the older one: ``Precompiled`` alone, ``Sequence[WhitespaceSplit,
  Metaspace(add_prefix_space=true)]``;

each with a ``Precompiled`` charsmap this file writes (a darts-clone
double array of NFKC-style entries, a decomposed accent composed, control
characters deleted, one entry that is a prefix of a grapheme cluster) and
without one. Over a seeded corpus with unknown characters, combining
marks, CRLF, tabs and runs of spaces, added tokens, and ``max_length``
truncation and padding, the ids and attention masks are equal, exactly.
"""

import json
import sys
import unicodedata

import numpy as np
import pytest

from scalable_hw_agnostic_inference_tpu_torch.models.tokenizer import (
    BpeTokenizer,
    Precompiled,
    UnigramTokenizer,
    graphemes,
)

tokenizers = pytest.importorskip("tokenizers")

#: the entries of the test's charsmap: fullwidth letters and digits, the
#: "fi" ligature, the ellipsis, NBSP, a decomposed e-acute composed,
#: control characters deleted, and "k" alone (a prefix of "k" + a
#: combining mark: the whole cluster takes "k"'s replacement)
CHARSMAP = {
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
    **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
    **{chr(0xFF10 + i): chr(0x30 + i) for i in range(10)},
    "ﬁ": "fi", "…": "...", "\xa0": " ", "’": "'",
    "e\u0301": "é", "a\u0308": "ä", "Å": "A\u030a",
    "\x07": "", "\x0b": " ", "\u200b": "", "k": "K",
}

WORDS = ("the quick brown fox jumps over lazy dog photo of an astronaut "
         "riding horse moon painting red snow cat sitting window sunset "
         "café naïve résumé straße 東京 서울 fiancé façade über coöperate "
         "Ｆｕｌｌ ｗｉｄｔｈ ﬁle …").split()
#: characters no piece begins with: unknowns (fused into one unk per run)
UNKNOWN = ("☃", "\U0001F600", "Ж", "א", "ก",
           "\U0001F44D\U0001F3FD", "¿")
EXTRA_IDS = 8


def transformers_names(*names):
    """``transformers``' ``names``, imported without TensorFlow: nothing
    here uses TensorFlow, and its import (``transformers.image_transforms``
    asks for it, under ``T5EncoderModel``) costs a test worker some 10 s.
    Before this process's first import of ``transformers`` ``USE_TF=0``
    says so; after it, the flag ``transformers`` read from the environment
    is held off while ``names`` import."""
    with pytest.MonkeyPatch.context() as mp:
        if "transformers" not in sys.modules:
            mp.setenv("USE_TF", "0")
            import transformers
        else:
            import transformers
            from transformers.utils import import_utils

            mp.setattr(import_utils, "_tf_available", False, raising=False)
        return tuple(getattr(transformers, n) for n in names)


def darts_charsmap(mapping) -> bytes:
    """A SentencePiece ``precompiled_charsmap``: a u32 trie size, the
    darts-clone double-array units over the keys' UTF-8 bytes (a key's
    value in the unit behind its label-0 child: the replacement's offset),
    then the NUL-terminated replacements."""
    norm = bytearray()
    root = {}
    for key, rep in sorted(mapping.items()):
        node = root
        for b in key.encode("utf-8"):
            node = node.setdefault(b, {})
        node[0] = len(norm)
        norm += rep.encode("utf-8") + b"\0"
    units = [0] * 64
    used, bases = {0}, set()
    queue = [(root, 0)]
    while queue:
        node, pos = queue.pop(0)
        labels = sorted(node)
        base = 1
        while base in bases or any((base ^ l) in used or (base ^ l) == 0
                                   for l in labels):
            base += 1
        bases.add(base)
        top = base | 0xFF
        if top >= len(units):
            units += [0] * (top + 1 - len(units))
        units[pos] |= (pos ^ base) << 10
        assert pos ^ base < 1 << 21
        for l in labels:
            used.add(base ^ l)
            if l == 0:
                units[pos] |= 1 << 8
                units[base] = node[0] | (1 << 31)
            else:
                units[base ^ l] |= l
                queue.append((node[l], base ^ l))
    # whole 256-unit blocks: a lookup of any byte from a used base stays
    # inside the array, as darts-clone's arrays are laid out
    size = (max(bases) | 0xFF) + 1
    units = (units + [0] * size)[:size]
    trie = b"".join(u.to_bytes(4, "little") for u in units)
    return len(trie).to_bytes(4, "little") + trie + bytes(norm)


def _vocab(rng):
    """T5-layout pieces with seeded scores: ids 0-2 special, every
    character of the normalized words (but the unknowns), "▁", "▁" + each
    word, and each word's prefixes and suffixes."""
    pieces = {}
    normalize = Precompiled(darts_charsmap(CHARSMAP))
    for w in WORDS:
        for form in {w, normalize(w), unicodedata.normalize("NFD", w)}:
            for c in form:
                pieces.setdefault(c, None)
            pieces.setdefault("▁" + form, None)
            for i in range(1, len(form)):
                pieces.setdefault(form[:i], None)
                pieces.setdefault("▁" + form[:i], None)
                pieces.setdefault(form[i:], None)
    for c in "▁.,!?'-0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ":
        pieces.setdefault(c, None)
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    for p in pieces:
        vocab.append([p, float(-rng.uniform(1.0, 14.0))])
    vocab += [[f"<extra_id_{i}>", 0.0] for i in range(EXTRA_IDS - 1, -1, -1)]
    return vocab


def build_spec(rng, charsmap: bool, older: bool):
    """A T5 ``tokenizer.json`` (dict) built by ``tokenizers``."""
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models
    from tokenizers import normalizers, pre_tokenizers, processors

    vocab = _vocab(rng)
    tok = Tokenizer(models.Unigram([tuple(v) for v in vocab], unk_id=2,
                                   byte_fallback=False))
    pre = [normalizers.Precompiled(darts_charsmap(CHARSMAP))] \
        if charsmap else []
    if older:
        tok.normalizer = pre[0] if pre else None
        tok.pre_tokenizer = pre_tokenizers.Sequence([
            pre_tokenizers.WhitespaceSplit(),
            pre_tokenizers.Metaspace(replacement="▁",
                                     prepend_scheme="always")])
    else:
        tok.normalizer = normalizers.Sequence(pre + [
            normalizers.Strip(left=False, right=True),
            normalizers.Replace(Regex(" {2,}"), "▁")])
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="always")
    tok.decoder = decoders.Metaspace(replacement="▁",
                                     prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"],
        special_tokens=[("</s>", 1)])
    specials = ["<pad>", "</s>", "<unk>"] + [
        f"<extra_id_{i}>" for i in range(EXTRA_IDS - 1, -1, -1)]
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True)
                            for t in specials])
    return json.loads(tok.to_str())


def write_t5_tokenizer(path, spec):
    path.mkdir(parents=True, exist_ok=True)
    (path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>",
        "extra_ids": EXTRA_IDS, "model_max_length": 512,
        "tokenizer_class": "T5Tokenizer"}))


def corpus(rng, n: int):
    """Seeded texts: words, their fullwidth and decomposed forms, unknown
    characters, runs of spaces, tabs, CRLF, added tokens, edge spaces."""
    seps = [" ", " ", " ", "  ", "   ", "\t", "\r\n", " \xa0", "\u3000"]
    extra = [f"<extra_id_{i}>" for i in range(EXTRA_IDS)] + ["</s>"]
    out = ["", " ", "hello", "k\u0301ey", "x\u0301\u0302", "\u0301start",
           "ab<extra_id_0>cd", "<extra_id_1> trailing ", "  lead",
           "\x07bell\x0bvt", "\u1100\u1161\u11a8 가"]
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 14))):
            r = rng.random()
            if r < 0.6:
                w = str(rng.choice(WORDS))
                if rng.random() < 0.2:
                    w = unicodedata.normalize("NFD", w)
                if rng.random() < 0.15:
                    w = w.upper()
            elif r < 0.75:
                w = str(rng.choice(UNKNOWN)) * int(rng.integers(1, 3))
            elif r < 0.85:
                w = str(rng.choice(extra))
            else:
                w = "".join(str(rng.choice(list("abkez.,!?'\u0301…")))
                            for _ in range(int(rng.integers(1, 6))))
            parts.append(w)
            parts.append(str(rng.choice(seps)))
        text = "".join(parts)
        if rng.random() < 0.3:
            text = " " + text
        out.append(text)
    return out


@pytest.fixture(scope="module", params=[(True, False), (False, False),
                                        (True, True), (False, True)],
                ids=["charsmap", "no-charsmap", "charsmap-older",
                     "no-charsmap-older"])
def pair(request, tmp_path_factory):
    (T5TokenizerFast,) = transformers_names("T5TokenizerFast")
    charsmap, older = request.param
    spec = build_spec(np.random.default_rng(0), charsmap, older)
    path = tmp_path_factory.mktemp("t5tok")
    write_t5_tokenizer(path, spec)
    hf = T5TokenizerFast(tokenizer_file=str(path / "tokenizer.json"),
                         extra_ids=EXTRA_IDS)
    return hf, UnigramTokenizer.from_dir(path), spec


def test_ids_equal_t5_tokenizer_fast(pair):
    """Every text's ids, with and without the template's ``</s>``."""
    hf, tok, _ = pair
    for text in corpus(np.random.default_rng(1), 120):
        want = hf(text)["input_ids"]
        assert tok.encode(text) == want, text
        assert tok.encode(text, add_special_tokens=False) == hf(
            text, add_special_tokens=False)["input_ids"], text


@pytest.mark.parametrize("max_length", [1, 2, 5, 16, 77])
def test_truncation_and_padding_equal_t5_tokenizer_fast(pair, max_length):
    """``padding="max_length", truncation=True``: ``</s>`` kept last, pads
    of id 0, the mask."""
    hf, tok, _ = pair
    for text in corpus(np.random.default_rng(2), 25):
        want = hf(text, padding="max_length", truncation=True,
                  max_length=max_length)
        got = tok(text, padding="max_length", truncation=True,
                  max_length=max_length)
        assert got["input_ids"] == want["input_ids"], text
        assert got["attention_mask"] == want["attention_mask"], text
    assert tok.pad_token_id == hf.pad_token_id == 0


def test_unknown_runs_fuse_and_the_charsmap_is_live(pair):
    """A run of characters no piece begins with is one ``<unk>``; with the
    charsmap, fullwidth text normalizes to the ASCII pieces (so the blob
    this file writes is read by both sides)."""
    hf, tok, spec = pair
    ids = tok.encode("☃☃\U0001F600 cat", add_special_tokens=False)
    assert ids == hf("☃☃\U0001F600 cat",
                     add_special_tokens=False)["input_ids"]
    assert ids.count(2) == 1
    has_map = "Precompiled" in json.dumps(spec["normalizer"])
    full = tok.encode("ｃａｔ", add_special_tokens=False)
    assert (full == tok.encode("cat", add_special_tokens=False)) == has_map


def test_charsmap_reader_against_tokenizers():
    """The blob's entries read back through the port's ``Precompiled`` as
    the ``tokenizers`` normalizer applies them, grapheme clusters
    included."""
    from tokenizers import normalizers

    blob = darts_charsmap(CHARSMAP)
    port = Precompiled(blob)
    hf = normalizers.Precompiled(blob)
    for key, rep in CHARSMAP.items():
        assert port.transform(key) == rep
    for text in ["Ｆｕll ﬁle…", "cafe\u0301 k\u0301",
                 "k\u0301\u0301x", "a\u0308\u0301", "\x07a\x0bb\u200bc",
                 "\r\n\r", "\u1100\u1161\u11a8", "\U0001F1EF\U0001F1F5x",
                 "\U0001F468\u200d\U0001F469", "e\u0301\u0301\u0301"]:
        assert port(text) == hf.normalize_str(text), text


def test_graphemes_cut_as_uax29():
    assert graphemes("e\u0301x") == ["e\u0301", "x"]
    assert graphemes("\r\n\n") == ["\r\n", "\n"]
    assert graphemes("\u1100\u1161\u11a8가") == [
        "\u1100\u1161\u11a8", "가"]
    assert graphemes("\U0001F1EF\U0001F1F5\U0001F1FA") == [
        "\U0001F1EF\U0001F1F5", "\U0001F1FA"]
    assert graphemes("\U0001F468\u200d\U0001F469!") == [
        "\U0001F468\u200d\U0001F469", "!"]
    assert graphemes("\x07\u0301") == ["\x07", "\u0301"]


def test_parts_outside_the_subset_raise():
    spec = build_spec(np.random.default_rng(0), False, False)
    bad = dict(spec, normalizer={"type": "NFKC"})
    with pytest.raises(ValueError, match="normalizer 'NFKC'"):
        UnigramTokenizer(bad)
    bad = dict(spec, pre_tokenizer={"type": "ByteLevel"})
    with pytest.raises(ValueError, match="pre-tokenizer 'ByteLevel'"):
        UnigramTokenizer(bad)
    bad = dict(spec, added_tokens=[dict(spec["added_tokens"][0],
                                        lstrip=True)])
    with pytest.raises(ValueError, match="lstrip"):
        UnigramTokenizer(bad)
    # the BPE reader names the Unigram reader instead of refusing blindly
    with pytest.raises(ValueError, match="UnigramTokenizer"):
        BpeTokenizer(spec)
