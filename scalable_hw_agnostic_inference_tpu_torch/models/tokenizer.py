"""BPE tokenizers read from ``tokenizer.json``: the Llama-3 family's
byte-level one, and the SentencePiece-style one of Llama-2, Vicuna and
LLaVA-1.5.

The JAX package tokenizes a checkpoint's text through ``transformers``
(``serve/units/common.py:127`` ``_hf_tokenizer``, ``AutoTokenizer``),
which the machine with the card does not have. This module reads the same
files (``tokenizer.json``, ``tokenizer_config.json``,
``special_tokens_map.json``) and gives the same ids and text as the fast
tokenizer does for the Llama-3 layout:

- added and special tokens are matched in the raw text first (leftmost,
  longest), and the text between them is tokenized on its own;
- the ``Split`` pre-tokenizer's regex (Llama-3's, :data:`LLAMA3_SPLIT`) is
  matched by hand, alternative by alternative, with ``\\p{L}`` and
  ``\\p{N}`` from ``unicodedata.category`` and ``\\s`` as Unicode's
  White_Space (Python's ``re`` has no ``\\p``);
- each piece is mapped byte by byte through the ByteLevel table;
- BPE with ``ignore_merges`` (a piece that is a vocabulary entry is one
  token) and the ``tokenizers`` merge order: lowest rank first, then the
  leftmost position, new pairs queued as merges form; merges read as
  ``"a b"`` strings or ``[a, b]`` pairs;
- the ``TemplateProcessing`` post-processor's special tokens (Llama-3's
  BOS), with right (or ``truncation_side``) truncation to a cap that keeps
  them;
- ``decode(skip_special_tokens=True)``: the ByteLevel decoder with U+FFFD
  for bytes that are not UTF-8, then ``clean_up_tokenization_spaces`` as
  ``tokenizer_config.json`` sets it;
- ``eos_token_id``, ``pad_token_id`` and the special tokens map from
  ``tokenizer_config.json``, and from ``special_tokens_map.json`` as
  ``transformers`` reads it: over the config's values, and only when the
  config lists no ``added_tokens_decoder``;
- the chat template from the files ``AutoTokenizer`` reads:
  ``chat_template.jinja`` and ``additional_chat_templates/*.jinja`` over
  ``tokenizer_config.json``'s ``chat_template`` (a string, or a list of
  ``{name, template}``), rendered by :mod:`.chat_template` in
  :meth:`BpeTokenizer.apply_chat_template` (``"default"`` of several).

The SentencePiece-style layout (``SP_SPACE``, "▁", stands for a space),
in either of its two spellings:

- the legacy one: the normalizer ``Sequence[Prepend("▁"), Replace(" ",
  "▁")]`` and no pre-tokenizer: each stretch of text between added tokens
  is one word, "▁" prepended;
- the ``Metaspace`` pre-tokenizer (``replacement`` "▁", ``prepend_scheme``
  ``first``, ``always`` or ``never``, ``split`` true or false) and no
  normalizer: ``first`` prepends only to the stretch at the start of the
  text, ``split`` cuts a word before each "▁";

then BPE with ``byte_fallback`` (a character outside the vocabulary
becomes its UTF-8 bytes as ``<0xXX>`` tokens) and ``unk_token`` with
``fuse_unk``; added tokens with their ``normalized`` flags (a normalized
one is matched in the normalized text, its own content normalized alike);
and the decoders ``Replace``, ``ByteFallback`` (a run of byte tokens that
is not UTF-8 gives one U+FFFD a byte, as ``tokenizers`` gives it),
``Fuse``, ``Strip`` and ``Metaspace``, chained as ``tokenizer.json`` lists
them. A ``LlamaTokenizerFast`` config rebuilds the template from its
``add_bos_token`` and ``add_eos_token``, as ``transformers`` does.

Anything else raises, naming what is missing: another pre-tokenizer,
normalizer, decoder or regex, BPE dropout or word affixes, added tokens
that strip or match whole words only. A Unigram model is
:class:`UnigramTokenizer`'s, a WordPiece model
:class:`WordPieceTokenizer`'s.

:class:`UnigramTokenizer` reads T5's ``tokenizer.json`` (a FLUX.1
snapshot's ``tokenizer_2/``, a T5 checkpoint's) and gives the ids
``T5TokenizerFast`` gives: the ``Precompiled`` charsmap (darts-clone
double array, grapheme clusters as ``tokenizers`` walks them),
``Replace``, ``Strip``, ``WhitespaceSplit``, ``Metaspace``, Unigram's
Viterbi with fused unknowns, added tokens and the ``$A </s>`` template.

:class:`ClipTokenizer` reads a CLIP ``tokenizer/`` directory
(``vocab.json``, ``merges.txt``, ``tokenizer_config.json``,
``special_tokens_map.json``: SD's layout, without a ``tokenizer.json``)
and gives the ids ``CLIPTokenizerFast`` gives, the pipeline
``transformers``' ``CLIPConverter`` builds: NFC, runs of whitespace to one
space, lowercase; CLIP's ``Split`` (``'s|'t|'re|'ve|'m|'ll|'d|
[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``, whitespace dropped); ByteLevel
characters; BPE with ``</w>`` ending each word and the slow tokenizer's
merge list (``merges.txt`` past its header line, at most 48,894 merges);
``<|startoftext|> ... <|endoftext|>``, truncated and padded to the length
asked for with the configuration's pad token. SD2.1 pads with ``!``,
which ``transformers`` adds as a special token matched in the raw text
(so a prompt's own ``!`` is that token, not ``!</w>``); SD1.x pads with
the end-of-text token.

:class:`WordPieceTokenizer` reads a BERT-family ``tokenizer.json``
(model ``WordPiece``), or a directory whose only vocabulary is
``vocab.txt`` (what ``transformers``' ``BertConverter`` builds from it),
and gives the ids and attention mask ``BertTokenizerFast`` gives:
``BertNormalizer`` (control characters dropped and whitespace made a
space, CJK ideographs spaced apart, accents stripped when lowercasing,
lowercase character by character), ``BertPreTokenizer`` (split on
whitespace, each punctuation character its own word), greedy
longest-match WordPiece with the ``##`` prefix and ``[UNK]`` for a word
past ``max_input_chars_per_word`` or with no match, ``[CLS] $A [SEP]``,
truncation that keeps both, and right padding with ``[PAD]``.
"""

from __future__ import annotations

import heapq
import json
import unicodedata
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from . import chat_template as chat_mod

#: Llama-3's Split pre-tokenizer regex, the one this module matches
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                r"\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                r"\s+(?!\S)|\s+")

#: Unicode White_Space, what ``\s`` matches in the tokenizers' regex engine
WHITE_SPACE = frozenset(map(chr, (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000)))

#: SentencePiece's visible space
SP_SPACE = "\u2581"

#: the contraction alternatives in order, as case-folded tails after "'"
#: (``(?i:...)``: "S", and U+017F, fold to "s")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def bytes_to_unicode() -> Dict[int, str]:
    """The ByteLevel table: each byte -> a printable character (GPT-2's)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_TO_CHAR = bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}


def _letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _other(c: str) -> bool:
    """``[^\\s\\p{L}\\p{N}]``"""
    return not (c in WHITE_SPACE or _letter(c) or _number(c))


def _fold(c: str) -> str:
    return "s" if c == "ſ" else c.lower()


def _run(text: str, i: int, pred) -> int:
    """The end of the run of ``pred`` characters starting at ``i``."""
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def _match_at(text: str, i: int) -> int:
    """The end of :data:`LLAMA3_SPLIT`'s match at ``i``: the first
    alternative that matches, each with its greedy backtracking."""
    n = len(text)
    c = text[i]
    # (?i:'s|'t|'re|'ve|'m|'ll|'d)
    if c == "'":
        for tail in _CONTRACTIONS:
            end = i + 1 + len(tail)
            if end <= n and "".join(map(_fold, text[i + 1:end])) == tail:
                return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if (c not in "\r\n" and not _letter(c) and not _number(c)
            and i + 1 < n and _letter(text[i + 1])):
        return _run(text, i + 1, _letter)
    if _letter(c):
        return _run(text, i, _letter)
    # \p{N}{1,3}
    if _number(c):
        j = i
        while j < n and j - i < 3 and _number(text[j]):
            j += 1
        return j
    #  ?[^\s\p{L}\p{N}]+[\r\n]*
    start = i + 1 if c == " " and i + 1 < n and _other(text[i + 1]) else i
    if _other(text[start]):
        j = _run(text, start, _other)
        return _run(text, j, lambda ch: ch in "\r\n")
    # \s*[\r\n]+: up to the last CR or LF of the whitespace run
    j = _run(text, i, lambda ch: ch in WHITE_SPACE)
    last = max((k for k in range(i, j) if text[k] in "\r\n"), default=-1)
    if last >= 0:
        return last + 1
    # \s+(?!\S), then \s+
    if j == n or j - i < 2:
        return j
    return j - 1


def pre_tokenize(text: str) -> List[str]:
    """Split ``text`` as Llama-3's ``Split`` pre-tokenizer does (every
    character starts some alternative, so the pieces cover the text)."""
    pieces, i = [], 0
    while i < len(text):
        j = _match_at(text, i)
        pieces.append(text[i:j])
        i = j
    return pieces


def clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _byte_fallback(tokens: List[str]) -> List[str]:
    """The ``ByteFallback`` decoder: each run of ``<0xXX>`` tokens becomes
    its UTF-8 text, or one U+FFFD a byte when it is not UTF-8."""
    out: List[str] = []
    run = bytearray()
    for t in tokens + [None]:
        if t is not None and len(t) == 6 and t.startswith("<0x") \
                and t.endswith(">"):
            try:
                run.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("\ufffd" * len(run))
            run = bytearray()
        if t is not None:
            out.append(t)
    return out


def _strip(t: str, ch: str, start: int, stop: int) -> str:
    """The ``Strip`` decoder: up to ``start`` leading and ``stop``
    trailing ``ch``."""
    a = 0
    while a < min(start, len(t)) and t[a] == ch:
        a += 1
    b = len(t)
    while len(t) - b < stop and b > a and t[b - 1] == ch:
        b -= 1
    return t[a:b]


#: the decoders a SentencePiece-style tokenizer.json may chain
_SP_DECODERS = ("Replace", "ByteFallback", "Fuse", "Strip", "Metaspace")


def _sp_pipeline(spec: Dict) -> Optional[Dict]:
    """The SentencePiece-style settings of ``spec`` (see the module note),
    None when its pipeline is not that layout (the byte-level checks then
    name what is missing); raises, naming it, for a SentencePiece-style
    spec with a part this module does not take."""
    model = spec.get("model") or {}
    norm = spec.get("normalizer")
    pre = spec.get("pre_tokenizer")
    sp = None
    if pre is None and norm is not None:
        steps = norm.get("normalizers", []) if norm.get("type") == \
            "Sequence" else [norm]
        if [n.get("type") for n in steps] == ["Prepend", "Replace"] \
                and steps[0].get("prepend") == SP_SPACE \
                and steps[1].get("pattern") == {"String": " "} \
                and steps[1].get("content") == SP_SPACE:
            sp = {"kind": "legacy"}
    elif norm is None and (pre or {}).get("type") == "Metaspace":
        scheme = pre.get("prepend_scheme")
        if scheme is None:      # the older spelling
            scheme = "always" if pre.get("add_prefix_space", True) \
                else "never"
        if pre.get("replacement", SP_SPACE) != SP_SPACE or scheme not in (
                "first", "always", "never"):
            raise ValueError(f"tokenizer.json: not ported: Metaspace "
                             f"{pre}")
        sp = {"kind": "metaspace", "prepend_scheme": scheme,
              "split": bool(pre.get("split", True))}
    if sp is None:
        return None
    missing = []
    if model.get("type") != "BPE":
        missing.append(_not_bpe(model))
    if model.get("dropout") or model.get("continuing_subword_prefix") or \
            model.get("end_of_word_suffix"):
        missing.append("BPE dropout or word prefixes and suffixes")
    dec = spec.get("decoder") or {}
    dsteps = dec.get("decoders", []) if dec.get("type") == "Sequence" \
        else [dec]
    for d in dsteps:
        kind = d.get("type")
        ok = kind in _SP_DECODERS
        if kind == "Replace":
            ok = isinstance(d.get("pattern"), dict) and isinstance(
                d["pattern"].get("String"), str) and "content" in d
        elif kind == "Strip":
            ok = all(k in d for k in ("content", "start", "stop"))
        if not ok:
            missing.append(f"decoder {d}")
    if missing:
        raise ValueError("tokenizer.json: not ported (SentencePiece-style): "
                         + "; ".join(missing))
    sp["decoders"] = dsteps
    return sp


def _not_bpe(model: Dict) -> str:
    kind = model.get("type")
    if kind == "Unigram":
        return "model 'Unigram' (read by UnigramTokenizer, not here)"
    if kind == "WordPiece":
        return "model 'WordPiece' (read by WordPieceTokenizer, not here)"
    return f"model {kind!r} (only BPE)"


def _token_content(v) -> Optional[str]:
    if v is None or isinstance(v, str):
        return v
    return v.get("content")


#: the special token attributes of ``transformers``' tokenizers, in order
SPECIAL_TOKEN_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                      "pad_token", "cls_token", "mask_token")
#: ``LlamaTokenizerFast``'s defaults for the special tokens a config omits
LLAMA_SPECIAL_DEFAULTS = {"unk_token": "<unk>", "bos_token": "<s>",
                          "eos_token": "</s>"}
#: where ``AutoTokenizer`` finds template files beside the tokenizer
CHAT_TEMPLATE_FILE = "chat_template.jinja"
CHAT_TEMPLATE_DIR = "additional_chat_templates"


def split_added(text: str, added: Dict[str, int]
                ) -> List[Tuple[bool, str, int]]:
    """``(is an added token, text, offset)`` segments: the ``added``
    tokens matched in ``text``, leftmost first and the longest at a
    position."""
    out: List[Tuple[bool, str, int]] = []
    if not added:
        return [(False, text, 0)] if text else []
    i = start = 0
    n = len(text)
    while i < n:
        best = max((t for t in added if text.startswith(t, i)),
                   key=len, default=None)
        if best is None:
            i += 1
            continue
        if i > start:
            out.append((False, text[start:i], start))
        out.append((True, best, i))
        i = start = i + len(best)
    if start < n:
        out.append((False, text[start:], start))
    return out


def merge_ids(ids: List[int], merges: Dict[Tuple[int, int], Tuple[int, int]]
              ) -> List[int]:
    """A word's initial ids merged as the ``tokenizers`` BPE model merges
    them (``merges``: pair -> (rank, merged id)): a heap of (rank,
    position), stale entries skipped when their pair no longer makes the
    same token."""
    ids = list(ids)
    n = len(ids)
    nxt = list(range(1, n)) + [-1]
    prv = list(range(-1, n - 1))
    alive = [True] * n
    heap = []
    for i in range(n - 1):
        m = merges.get((ids[i], ids[i + 1]))
        if m is not None:
            heap.append((m[0], i, m[1]))
    heapq.heapify(heap)
    while heap:
        rank, pos, new_id = heapq.heappop(heap)
        if not alive[pos] or nxt[pos] == -1:
            continue
        right = nxt[pos]
        m = merges.get((ids[pos], ids[right]))
        if m is None or m[1] != new_id:
            continue
        ids[pos] = new_id
        alive[right] = False
        nxt[pos] = nxt[right]
        if nxt[right] != -1:
            prv[nxt[right]] = pos
        if prv[pos] != -1:
            m = merges.get((ids[prv[pos]], ids[pos]))
            if m is not None:
                heapq.heappush(heap, (m[0], prv[pos], m[1]))
        if nxt[pos] != -1:
            m = merges.get((ids[pos], ids[nxt[pos]]))
            if m is not None:
                heapq.heappush(heap, (m[0], pos, m[1]))
    return [t for t, a in zip(ids, alive) if a]


class BpeTokenizer:
    """``encode(text, add_special_tokens, max_length)`` and
    ``decode(ids, skip_special_tokens)`` as the fast tokenizer of the same
    files gives them."""

    def __init__(self, spec: Dict, config: Optional[Dict] = None):
        config = config or {}
        #: the SentencePiece-style pipeline's settings, None for byte-level
        self.sp = _sp_pipeline(spec)
        if self.sp is None:
            self._check_pipeline(spec)
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (
                rank, self.vocab[a + b])
        self.unk_id = (self.vocab.get(model["unk_token"])
                       if model.get("unk_token") is not None else None)
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.fuse_unk = bool(model.get("fuse_unk"))
        #: added tokens matched in the raw text, and (SentencePiece-style)
        #: the normalized ones, by their normalized content
        self.added: Dict[str, int] = {}
        self.added_norm: Dict[str, int] = {}
        self.special_ids = set()
        added_ids: Dict[str, int] = {}
        for t in spec.get("added_tokens") or []:
            if t.get("lstrip") or t.get("rstrip") or t.get("single_word"):
                raise ValueError(f"added token {t['content']!r}: lstrip, "
                                 f"rstrip and single_word are not ported")
            added_ids[t["content"]] = t["id"]
            normalized = t.get("normalized", not t.get("special"))
            if self.sp is not None and normalized:
                self.added_norm[self._normalize(t["content"])] = t["id"]
            else:
                self.added[t["content"]] = t["id"]
            if t.get("special"):
                self.special_ids.add(t["id"])
        self.id_to_token = {i: s for s, i in self.vocab.items()}
        self.id_to_token.update({i: s for s, i in added_ids.items()})
        self._added_ids = added_ids
        self._template = self._parse_template(spec.get("post_processor"))
        self.truncation_side = config.get("truncation_side", "right")
        self.clean_up_spaces = bool(config.get(
            "clean_up_tokenization_spaces", False))
        if str(config.get("tokenizer_class", "")).startswith(
                "LlamaTokenizer"):
            config = {**LLAMA_SPECIAL_DEFAULTS, **config}
        template = config.get("chat_template")
        if isinstance(template, (list, tuple)):
            template = {t["name"]: t["template"] for t in template}
        #: a template string, a dict of named ones, or None
        self.chat_template: Union[str, Dict[str, str], None] = template
        self.special_tokens_map = self._special_tokens_map(config)
        self.bos_token_id = self._token_id(config.get("bos_token"))
        self.eos_token_id = self._token_id(config.get("eos_token"))
        self.pad_token_id = self._token_id(config.get("pad_token"))
        if str(config.get("tokenizer_class", "")).startswith(
                "LlamaTokenizer"):
            # LlamaTokenizerFast.update_post_processor: the template is
            # BOS (add_bos_token, default on) $A EOS (add_eos_token, off)
            self._template = (
                [self.bos_token_id] if config.get("add_bos_token", True)
                and self.bos_token_id is not None else [],
                [self.eos_token_id] if config.get("add_eos_token", False)
                and self.eos_token_id is not None else [])

    @classmethod
    def from_dir(cls, path: Union[str, Path]) -> "BpeTokenizer":
        """Read ``tokenizer.json`` and ``tokenizer_config.json`` (with
        ``special_tokens_map.json`` filling the special tokens it does not
        name) from a checkpoint directory."""
        path = Path(path)
        if not (path / "tokenizer.json").is_file():
            raise ValueError(
                f"{path}: no tokenizer.json (a SentencePiece "
                f"tokenizer.model alone is not read by this port)")
        spec = json.loads((path / "tokenizer.json").read_text())
        config = {}
        if (path / "tokenizer_config.json").is_file():
            config = json.loads((path / "tokenizer_config.json").read_text())
        if (path / "special_tokens_map.json").is_file() \
                and "added_tokens_decoder" not in config:
            # transformers' legacy path: the map's entries replace the
            # config's (its additional tokens are appended to the config's)
            smap = json.loads((path / "special_tokens_map.json").read_text())
            for key, value in smap.items():
                if key == "additional_special_tokens" and isinstance(
                        value, list):
                    extra = list(config.get("additional_special_tokens")
                                 or [])
                    have = {_token_content(t) for t in extra}
                    value = extra + [t for t in value
                                     if _token_content(t) not in have]
                config[key] = value
        templates = {}
        if (path / CHAT_TEMPLATE_FILE).is_file():
            templates["default"] = (path / CHAT_TEMPLATE_FILE).read_text(
                encoding="utf-8")
        if (path / CHAT_TEMPLATE_DIR).is_dir():
            for f in sorted((path / CHAT_TEMPLATE_DIR).glob("*.jinja")):
                templates[f.name[:-len(".jinja")]] = f.read_text(
                    encoding="utf-8")
        if templates:
            # template files take priority over the config's entry
            config["chat_template"] = (templates["default"]
                                       if list(templates) == ["default"]
                                       else templates)
        return cls(spec, config)

    @staticmethod
    def _special_tokens_map(config: Dict) -> Dict[str, Any]:
        """``special_tokens_map`` as ``transformers`` gives it: each set
        special token's content, the additional special tokens, and the
        config's ``extra_special_tokens``."""
        out: Dict[str, Any] = {}
        for key in SPECIAL_TOKEN_KEYS:
            content = _token_content(config.get(key))
            if content:
                out[key] = content
        extra = [_token_content(t) for t in
                 config.get("additional_special_tokens") or []]
        if extra:
            out["additional_special_tokens"] = extra
        for key, value in (config.get("extra_special_tokens") or {}).items():
            content = _token_content(value)
            if content:
                out[key] = content
        return out

    # -- the chat template ---------------------------------------------------

    def get_chat_template(self) -> str:
        """The template the chat route renders: the one template, or
        ``"default"`` of several (no tools are passed), as
        ``transformers``' ``get_chat_template`` chooses."""
        template = self.chat_template
        if isinstance(template, dict):
            if "default" not in template:
                raise ValueError(
                    f"This model has multiple chat templates with no default "
                    f"specified! Available template names are "
                    f"{sorted(template)}.")
            return template["default"]
        if template is None:
            raise ValueError("this tokenizer has no chat template")
        return template

    def compile_chat_template(self) -> None:
        """Compile the template the chat route renders, if there is one:
        a construct outside :mod:`.chat_template`'s subset raises
        ``chat_template.UnsupportedConstruct`` here, naming it and its
        line. A dict without ``"default"`` is left to the render, which
        raises as ``transformers`` does."""
        if isinstance(self.chat_template, str) or (
                isinstance(self.chat_template, dict)
                and "default" in self.chat_template):
            chat_mod.compile_template(self.get_chat_template())

    def apply_chat_template(self, messages, add_generation_prompt: bool =
                            False) -> str:
        """The rendered prompt, as ``apply_chat_template(messages,
        tokenize=False, add_generation_prompt=...)`` gives it."""
        return chat_mod.render_chat(self.get_chat_template(), messages,
                                    add_generation_prompt,
                                    self.special_tokens_map)

    # -- the pipeline's parts ----------------------------------------------

    @staticmethod
    def _check_pipeline(spec: Dict) -> None:
        model = spec.get("model") or {}
        missing = []
        if model.get("type") != "BPE":
            missing.append(_not_bpe(model))
        if model.get("byte_fallback") or model.get("dropout"):
            missing.append("BPE byte_fallback or dropout (SentencePiece-"
                           "style BPE)")
        if model.get("continuing_subword_prefix") or \
                model.get("end_of_word_suffix"):
            missing.append("BPE word prefixes and suffixes")
        if spec.get("normalizer") is not None:
            missing.append(f"normalizer {spec['normalizer'].get('type')!r}")
        pre = spec.get("pre_tokenizer") or {}
        steps = pre.get("pretokenizers", []) if pre.get("type") == \
            "Sequence" else [pre]
        kinds = [s.get("type") for s in steps]
        ok = kinds == ["Split", "ByteLevel"]
        if ok:
            split, byte_level = steps
            pattern = split.get("pattern", {}).get("Regex")
            ok = (pattern == LLAMA3_SPLIT
                  and split.get("behavior") == "Isolated"
                  and not split.get("invert")
                  and not byte_level.get("add_prefix_space")
                  and byte_level.get("use_regex") is False)
        if not ok:
            missing.append(f"pre-tokenizer {kinds} (only Llama-3's Split "
                           f"regex then ByteLevel without its own regex)")
        dec = spec.get("decoder") or {}
        dsteps = dec.get("decoders", []) if dec.get("type") == "Sequence" \
            else [dec]
        if [d.get("type") for d in dsteps] != ["ByteLevel"]:
            missing.append(f"decoder {[d.get('type') for d in dsteps]} "
                           f"(only ByteLevel; Metaspace and ByteFallback "
                           f"decoders are SentencePiece-style)")
        if missing:
            raise ValueError("tokenizer.json: not ported: "
                             + "; ".join(missing))

    @staticmethod
    def _parse_template(post) -> Tuple[List[int], List[int]]:
        """The ``TemplateProcessing`` single template as (ids before $A,
        ids after $A); a ByteLevel step changes offsets only."""
        if post is None:
            return [], []
        steps = post.get("processors", []) if post.get("type") == \
            "Sequence" else [post]
        before: List[int] = []
        after: List[int] = []
        seen_a = False
        for p in steps:
            if p.get("type") == "ByteLevel":
                continue
            if p.get("type") != "TemplateProcessing":
                raise ValueError(f"tokenizer.json: post-processor "
                                 f"{p.get('type')!r} is not ported")
            for item in p["single"]:
                if "Sequence" in item:
                    if item["Sequence"]["id"] != "A":
                        raise ValueError("template sequence other than $A")
                    seen_a = True
                    continue
                ids = p["special_tokens"][item["SpecialToken"]["id"]]["ids"]
                (after if seen_a else before).extend(ids)
        return before, after

    def _token_id(self, token) -> Optional[int]:
        content = _token_content(token)
        if content is None:
            return None
        if content in self._added_ids:
            return self._added_ids[content]
        return self.vocab.get(content)

    def _split_added(self, text: str, added: Optional[Dict[str, int]] = None
                     ) -> List[Tuple[bool, str, int]]:
        return split_added(text, self.added if added is None else added)

    # -- the SentencePiece-style pipeline ------------------------------------

    def _normalize(self, text: str) -> str:
        """The legacy normalizer (Prepend "▁" to a non-empty text, then
        every space to "▁"); the identity under ``Metaspace``."""
        if self.sp["kind"] != "legacy" or not text:
            return text
        return (SP_SPACE + text).replace(" ", SP_SPACE)

    def _sp_words(self, piece: str, offset: int) -> List[str]:
        """A normalized stretch -> the BPE model's words: the legacy form
        takes it whole; ``Metaspace`` replaces spaces, prepends "▁" as
        its scheme says (``first``: only at offset 0 of the text) and, with
        ``split``, cuts before each "▁"."""
        sp = self.sp
        if sp["kind"] == "legacy":
            return [piece] if piece else []
        s = piece.replace(" ", SP_SPACE)
        scheme = sp["prepend_scheme"]
        if not s.startswith(SP_SPACE) and (
                scheme == "always" or (scheme == "first" and offset == 0)):
            s = SP_SPACE + s
        if not sp["split"]:
            return [s] if s else []
        cuts = [i for i, c in enumerate(s) if c == SP_SPACE and i] + [len(s)]
        words, start = [], 0
        for c in cuts:
            if c > start:
                words.append(s[start:c])
            start = c
        return words

    def _initial(self, word: str) -> List[int]:
        """A word's ids before the merges (``BPE::merge_word``): a
        character in the vocabulary is its token; else, with
        ``byte_fallback``, its UTF-8 bytes as ``<0xXX>`` tokens when all
        are in the vocabulary; else ``unk`` (runs fused under
        ``fuse_unk``), or nothing without an ``unk_token``."""
        ids: List[int] = []
        unk_run = False
        for c in word:
            tid = self.vocab.get(c)
            if tid is not None:
                ids.append(tid)
                unk_run = False
                continue
            if self.byte_fallback:
                bts = [self.vocab.get(f"<0x{b:02X}>")
                       for b in c.encode("utf-8")]
                if all(t is not None for t in bts):
                    ids.extend(bts)
                    unk_run = False
                    continue
            if self.unk_id is not None:
                if not (unk_run and self.fuse_unk):
                    ids.append(self.unk_id)
                unk_run = True
        return ids

    def _decode_sp(self, tokens: List[str]) -> str:
        """``tokenizer.json``'s decoders in their order over the token
        strings, then joined."""
        for d in self.sp["decoders"]:
            kind = d["type"]
            if kind == "Replace":
                pat, to = d["pattern"]["String"], d["content"]
                tokens = [t.replace(pat, to) for t in tokens]
            elif kind == "ByteFallback":
                tokens = _byte_fallback(tokens)
            elif kind == "Fuse":
                tokens = ["".join(tokens)]
            elif kind == "Strip":
                tokens = [_strip(t, d["content"], d["start"], d["stop"])
                          for t in tokens]
            else:   # Metaspace
                rep, never = d.get("replacement", SP_SPACE), \
                    d.get("prepend_scheme") == "never"
                tokens = [t.replace(rep, "" if i == 0 and not never
                                    else " ") for i, t in enumerate(tokens)]
        return "".join(tokens)

    def _bpe(self, piece: str) -> List[int]:
        """One pre-tokenized piece (ByteLevel characters, or a
        SentencePiece-style word) -> ids (:func:`merge_ids`)."""
        if self.ignore_merges and piece in self.vocab:
            return [self.vocab[piece]]
        if self.sp is not None:
            ids = self._initial(piece)
        else:
            ids = [self.vocab[c] for c in piece if c in self.vocab]
        return merge_ids(ids, self.merges)

    # -- the public surface ------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        """Token ids of ``text``; with ``max_length`` truncated (on
        ``truncation_side``) so that the ids, template tokens included,
        number at most ``max_length``."""
        ids: List[int] = []
        for is_added, seg, off in self._split_added(text):
            if is_added:
                ids.append(self.added[seg])
            elif self.sp is not None:
                for is_norm, piece, off2 in self._split_added(
                        self._normalize(seg), self.added_norm):
                    if is_norm:
                        ids.append(self.added_norm[piece])
                        continue
                    for word in self._sp_words(piece, off + off2):
                        ids.extend(self._bpe(word))
            else:
                for piece in pre_tokenize(seg):
                    ids.extend(self._bpe("".join(
                        BYTE_TO_CHAR[b] for b in piece.encode("utf-8"))))
        before, after = self._template if add_special_tokens else ([], [])
        if max_length is not None:
            keep = max(0, max_length - len(before) - len(after))
            ids = ids[:keep] if self.truncation_side == "right" \
                else ids[len(ids) - keep:] if keep else []
        return before + ids + after

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        """Text of ``ids``: the ByteLevel decoder (a token whose characters
        are not all in its table contributes its own UTF-8), U+FFFD for
        invalid UTF-8, or the SentencePiece-style decoders; then the
        clean-up the config asks for."""
        if self.sp is not None:
            toks = [self.id_to_token[int(i)] for i in ids
                    if int(i) in self.id_to_token and not (
                        skip_special_tokens and int(i) in self.special_ids)]
            text = self._decode_sp(toks)
            return clean_up_tokenization(text) if self.clean_up_spaces \
                else text
        data = bytearray()
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None or (skip_special_tokens and i in self.special_ids):
                continue
            if all(c in CHAR_TO_BYTE for c in tok):
                data.extend(CHAR_TO_BYTE[c] for c in tok)
            else:
                data.extend(tok.encode("utf-8"))
        text = data.decode("utf-8", errors="replace")
        return clean_up_tokenization(text) if self.clean_up_spaces else text


# -- CLIP ---------------------------------------------------------------------

#: the merges the slow ``CLIPTokenizer`` reads (``49152 - 256 - 2``)
CLIP_MAX_MERGES = 49152 - 256 - 2


def _clip_piece_end(text: str, i: int) -> int:
    """The end of CLIP's ``Split`` match at ``i`` (``text[i]`` not
    whitespace): a contraction, a run of letters, one digit, or a run of
    what is neither."""
    if text[i] == "'":
        for tail in ("s", "t", "re", "ve", "m", "ll", "d"):
            if text.startswith(tail, i + 1):
                return i + 1 + len(tail)
    if _letter(text[i]):
        return _run(text, i, _letter)
    if _number(text[i]):
        return i + 1
    return _run(text, i, _other)


def clip_pre_tokenize(text: str) -> List[str]:
    """CLIP's ``Split`` with ``invert`` and ``removed``: the matches, the
    whitespace between them dropped."""
    pieces, i = [], 0
    while i < len(text):
        if text[i] in WHITE_SPACE:
            i += 1
            continue
        j = _clip_piece_end(text, i)
        pieces.append(text[i:j])
        i = j
    return pieces


class ClipTokenizer:
    """``CLIPTokenizerFast`` over a CLIP ``tokenizer/`` directory (see the
    module note): :meth:`encode`, and ``__call__`` with
    ``padding="max_length", truncation=True`` as the pipelines call it."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[str],
                 config: Optional[Dict] = None):
        config = config or {}
        self.vocab = dict(vocab)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(merges):
            a, b = m.split(" ", 1)
            self.merges[(self.vocab[a], self.vocab[b])] = (
                rank, self.vocab[a + b])
        self.unk_id = self._id(config.get("unk_token", "<|endoftext|>"))
        self.bos_token_id = self._id(config.get("bos_token",
                                                "<|startoftext|>"))
        self.eos_token_id = self._id(config.get("eos_token",
                                                "<|endoftext|>"))
        self.pad_token_id = self._id(config.get("pad_token",
                                                "<|endoftext|>"))
        self.model_max_length = int(config.get("model_max_length", 77))
        #: special tokens matched before normalization (added from a plain
        #: string, or with ``normalized`` false) and after it
        self.added: Dict[str, int] = {}
        self.added_norm: Dict[str, int] = {}
        decoder = config.get("added_tokens_decoder")
        if decoder:
            entries = [(int(i), t) for i, t in decoder.items()]
        else:
            entries = []
            for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                if config.get(key) is not None:
                    entries.append((None, config[key]))
            entries += [(None, t) for t in
                        config.get("additional_special_tokens") or []]
        for tid, tok in entries:
            content = _token_content(tok)
            if content in self.added or content in self.added_norm:
                continue
            normalized = isinstance(tok, dict) and tok.get(
                "normalized", not tok.get("special", True))
            tid = self._id(content) if tid is None else tid
            if tid is None:
                raise ValueError(f"special token {content!r} is not in the "
                                 f"vocabulary (adding tokens is not ported)")
            (self.added_norm if normalized else self.added)[content] = tid

    def _id(self, token) -> Optional[int]:
        content = _token_content(token)
        return None if content is None else self.vocab.get(content)

    @classmethod
    def from_dir(cls, path: Union[str, Path]) -> "ClipTokenizer":
        """Read ``vocab.json`` and ``merges.txt`` with
        ``tokenizer_config.json``, and ``special_tokens_map.json`` over
        its entries when the config lists no ``added_tokens_decoder`` (as
        ``transformers`` reads them)."""
        path = Path(path)
        for f in ("vocab.json", "merges.txt"):
            if not (path / f).is_file():
                raise ValueError(f"{path}: no {f} (a CLIP tokenizer "
                                 f"directory holds vocab.json and "
                                 f"merges.txt)")
        vocab = json.loads((path / "vocab.json").read_text(encoding="utf-8"))
        lines = (path / "merges.txt").read_text(
            encoding="utf-8").strip().split("\n")
        merges = lines[1:CLIP_MAX_MERGES + 1]
        config = {}
        if (path / "tokenizer_config.json").is_file():
            config = json.loads((path / "tokenizer_config.json").read_text())
        if (path / "special_tokens_map.json").is_file() \
                and "added_tokens_decoder" not in config:
            config.update(json.loads(
                (path / "special_tokens_map.json").read_text()))
        return cls(vocab, merges, config)

    @staticmethod
    def normalize(text: str) -> str:
        """NFC, every run of whitespace one space, lowercase."""
        text = unicodedata.normalize("NFC", text)
        out, i = [], 0
        while i < len(text):
            if text[i] in WHITE_SPACE:
                i = _run(text, i, lambda c: c in WHITE_SPACE)
                out.append(" ")
            else:
                out.append(text[i])
                i += 1
        return "".join(out).lower()

    def _word(self, piece: str) -> List[int]:
        chars = [BYTE_TO_CHAR[b] for b in piece.encode("utf-8")]
        chars[-1] += "</w>"
        return merge_ids([self.vocab.get(c, self.unk_id) for c in chars],
                         self.merges)

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        """Token ids of ``text``, with ``max_length`` truncated on the
        right so that the ids, start and end tokens included, number at
        most ``max_length``."""
        ids: List[int] = []
        for is_added, seg, _ in split_added(text, self.added):
            if is_added:
                ids.append(self.added[seg])
                continue
            for is_norm, piece, _ in split_added(self.normalize(seg),
                                                 self.added_norm):
                if is_norm:
                    ids.append(self.added_norm[piece])
                else:
                    for word in clip_pre_tokenize(piece):
                        ids.extend(self._word(word))
        if not add_special_tokens:
            return ids[:max_length] if max_length is not None else ids
        if max_length is not None:
            ids = ids[:max(0, max_length - 2)]
        return [self.bos_token_id] + ids + [self.eos_token_id]

    def __call__(self, text: str, padding: str = "max_length",
                 truncation: bool = True, max_length: Optional[int] = None
                 ) -> Dict[str, List[int]]:
        """``{"input_ids", "attention_mask"}``: the ids truncated to
        ``max_length`` (``model_max_length`` by default) and padded to it
        with the pad token."""
        if padding != "max_length" or not truncation:
            raise ValueError("ClipTokenizer pads to max_length with "
                             "truncation only")
        n = self.model_max_length if max_length is None else max_length
        ids = self.encode(text, max_length=n)
        pad = n - len(ids)
        return {"input_ids": ids + [self.pad_token_id] * pad,
                "attention_mask": [1] * len(ids) + [0] * pad}


# -- Unigram (T5's tokenizer.json) --------------------------------------------

#: the score below the vocabulary's lowest that an unknown character takes
#: (``tokenizers``' ``K_UNK_PENALTY``)
UNK_PENALTY = 10.0

#: Prepended_Concatenation_Mark and the other Grapheme_Cluster_Break=Prepend
#: code points
_PREPEND = frozenset((*range(0x600, 0x606), 0x6DD, 0x70F, 0x890, 0x891,
                      0x8E2, 0xD4E, 0x110BD, 0x110CD, 0x111C2, 0x111C3,
                      0x1193F, 0x11941, 0x11A3A, *range(0x11A84, 0x11A8A),
                      0x11D46))
#: spacing marks (gc Mc) that are Grapheme_Extend, so Extend
_EXTEND_MC = frozenset((0x9BE, 0x9D7, 0xB3E, 0xB57, 0xBBE, 0xBD7, 0xCC2,
                        0xCD5, 0xCD6, 0xD3E, 0xD57, 0xDCF, 0xDDF, 0x1B35,
                        0x302E, 0x302F, 0x1133E, 0x11357, 0x114B0, 0x114BD,
                        0x115AF, 0x11930, 0x1D165, *range(0x1D16E,
                                                          0x1D173)))
#: Extended_Pictographic, as ranges (emoji and the pictographic blocks)
_PICTOGRAPHIC = (
    (0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA),
    (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
    (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB),
    (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
    (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721),
    (0x2728, 0x2728), (0x2733, 0x2734), (0x2744, 0x2744), (0x2747, 0x2747),
    (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
    (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C),
    (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
    (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
    (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
    (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
    (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
    (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
    (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
    (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
    (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


def _grapheme_class(c: str) -> str:
    """The Grapheme_Cluster_Break class of ``c`` (UAX #29), from
    ``unicodedata``'s categories and the tables above."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if cp in _PREPEND:
        return "Prepend"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or cp == 0x200C or cp in _EXTEND_MC or \
            cp in (0xFF9E, 0xFF9F) or 0x1F3FB <= cp <= 0x1F3FF or \
            0xE0020 <= cp <= 0xE007F:
        return "Extend"
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return "Control"
    if cat == "Mc" or cp in (0xE33, 0xEB3):
        return "SpacingMark"
    if any(a <= cp <= b for a, b in _PICTOGRAPHIC):
        return "ExtPict"
    return "Other"


def graphemes(text: str) -> List[str]:
    """``text`` cut into extended grapheme clusters by UAX #29's rules GB3
    to GB13 (the Indic conjunct rule GB9c left out: a conjunct is then
    several clusters)."""
    out: List[str] = []
    start = 0
    prev = None
    ri_run = 0          # regional indicators in a row before this one
    pict_zwj = False    # ExtPict Extend* ZWJ just before this character
    pict_ext = False    # ExtPict Extend* just before this character
    for i, c in enumerate(text):
        cls = _grapheme_class(c)
        if prev is None:
            join = True
        elif prev == "CR" and cls == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or \
                cls in ("Control", "CR", "LF"):
            join = False
        elif prev == "L" and cls in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and cls in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and cls == "T":
            join = True
        elif cls in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif pict_zwj and cls == "ExtPict":
            join = True
        elif prev == "RI" and cls == "RI":
            join = ri_run % 2 == 1
        else:
            join = False
        if not join and i:
            out.append(text[start:i])
            start = i
        pict_zwj = pict_ext and cls == "ZWJ"
        pict_ext = cls == "ExtPict" or (pict_ext and cls == "Extend")
        ri_run = ri_run + 1 if cls == "RI" else 0
        prev = cls
    if start < len(text):
        out.append(text[start:])
    return out


class Precompiled:
    """The ``Precompiled`` normalizer: a SentencePiece charsmap (a u32 trie
    size, the darts-clone double-array units, then the NUL-terminated
    replacement strings) applied as ``tokenizers`` applies it. Each
    grapheme cluster under 6 bytes that has a match is replaced whole by
    the replacement of its SHORTEST matching prefix; otherwise each of its
    characters is replaced by its own match, or kept."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("Precompiled charsmap: short blob")
        n = int.from_bytes(blob[:4], "little")
        if n % 4 or 4 + n > len(blob):
            raise ValueError(f"Precompiled charsmap: trie size {n} does "
                             f"not fit a {len(blob)}-byte blob")
        self.units = [int.from_bytes(blob[4 + j:8 + j], "little")
                      for j in range(0, n, 4)]
        self.normalized = blob[4 + n:]

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def _prefix_values(self, key: bytes) -> List[int]:
        """darts-clone's common-prefix search: the value of each key in
        the trie that is a prefix of ``key``, shortest first."""
        units = self.units
        pos = self._offset(units[0]) if units else 0
        out: List[int] = []
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                break
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                break
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                out.append(units[pos] & ((1 << 31) - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        found = self._prefix_values(chunk.encode("utf-8"))
        if not found:
            return None
        start = found[0]
        end = self.normalized.find(b"\0", start)
        end = len(self.normalized) if end < 0 else end
        return self.normalized[start:end].decode("utf-8")

    def __call__(self, text: str) -> str:
        out: List[str] = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                rep = self.transform(g)
                if rep is not None:
                    out.append(rep)
                    continue
            for c in g:
                rep = self.transform(c)
                out.append(c if rep is None else rep)
        return "".join(out)


def _ws_strip(text: str, left: bool, right: bool) -> str:
    a, b = 0, len(text)
    while left and a < b and text[a] in WHITE_SPACE:
        a += 1
    while right and b > a and text[b - 1] in WHITE_SPACE:
        b -= 1
    return text[a:b]


def _unigram_normalizer(spec: Optional[Dict]):
    """``tokenizer.json``'s normalizer as a function on strings: a
    ``Sequence`` of ``Precompiled``, ``Replace`` (a string or a regex
    Python's ``re`` reads) and ``Strip``; None is the identity. Anything
    else raises, naming it."""
    import base64
    import re

    if spec is None:
        return lambda s: s
    steps = spec.get("normalizers", []) if spec.get("type") == "Sequence" \
        else [spec]
    fns = []
    for st in steps:
        kind = st.get("type")
        if kind == "Precompiled":
            fns.append(Precompiled(base64.b64decode(
                st.get("precompiled_charsmap") or "")))
        elif kind == "Replace":
            pat, to = st.get("pattern") or {}, st.get("content", "")
            if isinstance(pat.get("String"), str):
                fns.append(lambda s, p=pat["String"], t=to: s.replace(p, t))
            elif isinstance(pat.get("Regex"), str):
                try:
                    rx = re.compile(pat["Regex"])
                except re.error as e:
                    raise ValueError(f"tokenizer.json: Replace regex "
                                     f"{pat['Regex']!r} is not ported "
                                     f"({e})") from None
                fns.append(lambda s, r=rx, t=to: r.sub(lambda _m: t, s))
            else:
                raise ValueError(f"tokenizer.json: Replace pattern {pat} "
                                 f"is not ported")
        elif kind == "Strip":
            fns.append(lambda s, a=bool(st.get("strip_left")),
                       b=bool(st.get("strip_right")): _ws_strip(s, a, b))
        else:
            raise ValueError(f"tokenizer.json: normalizer {kind!r} is not "
                             f"ported for Unigram (Precompiled, Replace, "
                             f"Strip, Sequence)")

    def normalize(s: str) -> str:
        for fn in fns:
            s = fn(s)
        return s

    return normalize


def _unigram_pre_tokenizer(spec: Optional[Dict]) -> List[Dict]:
    """The pre-tokenizer steps: ``WhitespaceSplit`` and ``Metaspace`` (in a
    ``Sequence`` or alone). Anything else raises, naming it."""
    if spec is None:
        return []
    steps = spec.get("pretokenizers", []) if spec.get("type") == \
        "Sequence" else [spec]
    out = []
    for st in steps:
        kind = st.get("type")
        if kind == "WhitespaceSplit":
            out.append({"kind": "ws"})
        elif kind == "Metaspace":
            scheme = st.get("prepend_scheme")
            if scheme is None:      # the older spelling
                scheme = "always" if st.get("add_prefix_space", True) \
                    else "never"
            rep = st.get("replacement", SP_SPACE)
            if scheme not in ("first", "always", "never") or len(rep) != 1:
                raise ValueError(f"tokenizer.json: not ported: Metaspace "
                                 f"{st}")
            out.append({"kind": "meta", "rep": rep, "scheme": scheme,
                        "split": bool(st.get("split", True))})
        else:
            raise ValueError(f"tokenizer.json: pre-tokenizer {kind!r} is "
                             f"not ported for Unigram (WhitespaceSplit, "
                             f"Metaspace)")
    return out


class UnigramTokenizer:
    """A Unigram ``tokenizer.json`` (T5's, ``T5TokenizerFast``'s file) read
    and applied as ``tokenizers`` applies it:

    - added tokens matched leftmost-longest in the raw text (those marked
      ``normalized`` in each normalized stretch), the text between them
      normalized, pre-tokenized and encoded on its own;
    - the normalizers :func:`_unigram_normalizer` takes, and the
      pre-tokenizers ``WhitespaceSplit`` and ``Metaspace``
      (``prepend_scheme`` ``always``, ``first`` or ``never``; ``first``
      read off the stretch's offset in the raw text);
    - Viterbi over the pieces' scores, ties kept by the first path found
      (shorter pieces first at each start); a character no piece begins
      with scores the lowest score less :data:`UNK_PENALTY`, and a run of
      such unknowns is one ``unk`` token; ``byte_fallback`` pieces
      ``<0xXX>`` for a piece outside the vocabulary when all its bytes
      have one;
    - the ``TemplateProcessing`` post-processor (T5's ``$A </s>``), right
      truncation keeping its tokens;
    - ``__call__(text, padding="max_length", truncation=True,
      max_length=n)`` as ``transformers`` pads: the pad token of
      ``tokenizer_config.json`` (``<pad>`` by default, T5's id 0).

    Anything else in the file raises, naming what is missing."""

    def __init__(self, spec: Dict, config: Optional[Dict] = None):
        config = config or {}
        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise ValueError(f"tokenizer.json: model "
                             f"{model.get('type')!r} is not Unigram")
        self.pieces: Dict[str, Tuple[int, float]] = {}
        self.max_piece = 1
        scores = []
        for i, (piece, score) in enumerate(model["vocab"]):
            self.pieces[piece] = (i, float(score))
            self.max_piece = max(self.max_piece, len(piece))
            scores.append(float(score))
        self.unk_id = model.get("unk_id")
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.unk_score = min(scores) - UNK_PENALTY
        self.normalize = _unigram_normalizer(spec.get("normalizer"))
        self.pre = _unigram_pre_tokenizer(spec.get("pre_tokenizer"))
        self.added: Dict[str, int] = {}
        self.added_norm: Dict[str, int] = {}
        for t in spec.get("added_tokens") or []:
            if t.get("lstrip") or t.get("rstrip") or t.get("single_word"):
                raise ValueError(f"added token {t['content']!r}: lstrip, "
                                 f"rstrip and single_word are not ported")
            if t.get("normalized", not t.get("special")):
                self.added_norm[self.normalize(t["content"])] = t["id"]
            else:
                self.added[t["content"]] = t["id"]
        self._template = BpeTokenizer._parse_template(
            spec.get("post_processor"))
        pad = _token_content(config.get("pad_token", "<pad>"))
        self.pad_token_id = self._token_id(pad)
        self.model_max_length = int(config.get("model_max_length", 512))

    def _token_id(self, content: Optional[str]) -> Optional[int]:
        if content is None:
            return None
        if content in self.added:
            return self.added[content]
        hit = self.pieces.get(content)
        return None if hit is None else hit[0]

    @classmethod
    def from_dir(cls, path: Union[str, Path]) -> "UnigramTokenizer":
        """Read ``tokenizer.json`` and ``tokenizer_config.json`` (a T5
        ``tokenizer/`` or a FLUX.1 snapshot's ``tokenizer_2/``)."""
        path = Path(path)
        if not (path / "tokenizer.json").is_file():
            raise ValueError(
                f"{path}: no tokenizer.json (a SentencePiece spiece.model "
                f"alone is not read by this port)")
        spec = json.loads((path / "tokenizer.json").read_text(
            encoding="utf-8"))
        config = {}
        if (path / "tokenizer_config.json").is_file():
            config = json.loads((path / "tokenizer_config.json").read_text())
        return cls(spec, config)

    # -- the pipeline --------------------------------------------------------

    def _words(self, text: str, offset: int) -> List[str]:
        words = [(text, offset)]
        for st in self.pre:
            nxt = []
            for w, off in words:
                if st["kind"] == "ws":
                    i = 0
                    while i < len(w):
                        if w[i] in WHITE_SPACE:
                            i += 1
                            continue
                        j = _run(w, i, lambda c: c not in WHITE_SPACE)
                        nxt.append((w[i:j], off + i))
                        i = j
                    continue
                rep = st["rep"]
                s = w.replace(" ", rep)
                if not s.startswith(rep) and (
                        st["scheme"] == "always"
                        or (st["scheme"] == "first" and off == 0)):
                    s = rep + s
                if not st["split"]:
                    nxt.append((s, off))
                    continue
                cuts = [i for i, c in enumerate(s) if c == rep and i]
                start = 0
                for c in cuts + [len(s)]:
                    if c > start:
                        nxt.append((s[start:c], off))
                    start = c
            words = nxt
        return [w for w, _ in words if w]

    def viterbi(self, word: str) -> List[str]:
        """The best segmentation of ``word`` into pieces (``tokenizers``'
        ``encode_optimized``)."""
        n = len(word)
        if not n:
            return []
        # per end position: (score, start, id); start -1 = not reached
        best: List[Tuple[float, int, int]] = [(0.0, -1, -1)] * (n + 1)
        for i in range(n):
            here = best[i][0]
            single = False
            for j in range(i + 1, min(n, i + self.max_piece) + 1):
                hit = self.pieces.get(word[i:j])
                if hit is None:
                    continue
                cand = hit[1] + here
                if best[j][1] < 0 or cand > best[j][0]:
                    best[j] = (cand, i, hit[0])
                if j == i + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram: {word[i]!r} is not in the "
                                     f"vocabulary and there is no unk_id")
                cand = self.unk_score + here
                if best[i + 1][1] < 0 or cand > best[i + 1][0]:
                    best[i + 1] = (cand, i, self.unk_id)
        out: List[str] = []
        unk_run: List[str] = []
        end = n
        while end > 0:
            _, start, tid = best[end]
            if tid == self.unk_id:
                unk_run.append(word[start:end])
            else:
                if unk_run:
                    out.append("".join(reversed(unk_run)))
                    unk_run = []
                out.append(word[start:end])
            end = start
        if unk_run:
            out.append("".join(reversed(unk_run)))
        return out[::-1]

    def _piece_ids(self, word: str) -> List[int]:
        ids: List[int] = []
        for piece in self.viterbi(word):
            hit = self.pieces.get(piece)
            if hit is not None:
                ids.append(hit[0])
                continue
            if self.byte_fallback:
                bts = [self.pieces.get(f"<0x{b:02X}>")
                       for b in piece.encode("utf-8")]
                if all(b is not None for b in bts):
                    ids.extend(b[0] for b in bts)
                    continue
            ids.append(self.unk_id)
        return ids

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        """Token ids of ``text``; with ``max_length`` truncated on the right
        so that the ids, template tokens included, number at most
        ``max_length``."""
        ids: List[int] = []
        for is_added, seg, off in split_added(text, self.added):
            if is_added:
                ids.append(self.added[seg])
                continue
            for is_norm, piece, _ in split_added(self.normalize(seg),
                                                 self.added_norm):
                if is_norm:
                    ids.append(self.added_norm[piece])
                    continue
                for word in self._words(piece, off):
                    ids.extend(self._piece_ids(word))
        before, after = self._template if add_special_tokens else ([], [])
        if max_length is not None:
            ids = ids[:max(0, max_length - len(before) - len(after))]
        return before + ids + after

    def __call__(self, text: str, padding: str = "max_length",
                 truncation: bool = True, max_length: Optional[int] = None
                 ) -> Dict[str, List[int]]:
        """``{"input_ids", "attention_mask"}``: the ids truncated to
        ``max_length`` (``model_max_length`` by default) and padded to it
        with the pad token."""
        if padding != "max_length" or not truncation:
            raise ValueError("UnigramTokenizer pads to max_length with "
                             "truncation only")
        if self.pad_token_id is None:
            raise ValueError("UnigramTokenizer: no pad token in the "
                             "vocabulary")
        n = self.model_max_length if max_length is None else max_length
        ids = self.encode(text, max_length=n)
        pad = n - len(ids)
        return {"input_ids": ids + [self.pad_token_id] * pad,
                "attention_mask": [1] * len(ids) + [0] * pad}


# -- WordPiece (BERT) -------------------------------------------------------

#: the CJK ideograph blocks ``BertNormalizer`` spaces apart
CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
              (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
              (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
#: ASCII punctuation, which ``BertPreTokenizer`` isolates beside Unicode's
#: P* categories (``$``, ``+``, ``<``, ``=``, ``>``, ``^``, ``\```, ``|``
#: and ``~`` are symbols to Unicode)
ASCII_PUNCT = frozenset("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _bert_whitespace(c: str) -> bool:
    return c in "\t\n\r" or c in WHITE_SPACE


def _bert_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c)[0] == "C"


def _cjk(c: str) -> bool:
    o = ord(c)
    return any(lo <= o <= hi for lo, hi in CJK_RANGES)


def _bert_punct(c: str) -> bool:
    return c in ASCII_PUNCT or unicodedata.category(c)[0] == "P"


class WordPieceTokenizer:
    """A BERT-family tokenizer (``BertTokenizerFast``'s pipeline): see the
    module note. ``encode(text, add_special_tokens, max_length)`` gives
    the ids; ``__call__(text, padding="max_length", truncation=True,
    max_length=n)`` gives ``{"input_ids", "attention_mask"}`` padded on
    the right to ``n``. Anything in ``tokenizer.json`` outside that
    pipeline raises, naming it."""

    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = True,
                 strip_accents: Optional[bool] = None,
                 clean_text: bool = True, handle_chinese_chars: bool = True,
                 unk_token: str = "[UNK]", prefix: str = "##",
                 max_input_chars_per_word: int = 100,
                 template: Tuple[List[int], List[int]] = ([], []),
                 added: Optional[Dict[str, int]] = None,
                 added_normalized: Optional[Dict[str, int]] = None,
                 pad_token: Optional[str] = "[PAD]",
                 model_max_length: int = 512):
        self.vocab = dict(vocab)
        self.lowercase = lowercase
        self.strip_accents = lowercase if strip_accents is None \
            else strip_accents
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        if unk_token not in self.vocab:
            raise ValueError(f"WordPiece: unk token {unk_token!r} is not in "
                             f"the vocabulary")
        self.unk_id = self.vocab[unk_token]
        self.prefix = prefix
        self.max_chars = max_input_chars_per_word
        self._template = template
        self.added = dict(added or {})
        self.added_norm = {self.normalize(t): i
                           for t, i in (added_normalized or {}).items()}
        self.pad_token_id = None if pad_token is None else (
            self.added.get(pad_token, self.vocab.get(pad_token)))
        self.model_max_length = model_max_length

    @classmethod
    def from_spec(cls, spec: Dict, config: Optional[Dict] = None
                  ) -> "WordPieceTokenizer":
        """From a ``tokenizer.json`` (a dict) and ``tokenizer_config.json``
        (a dict or None)."""
        config = config or {}
        model = spec.get("model") or {}
        if model.get("type") != "WordPiece":
            raise ValueError(f"tokenizer.json: model {model.get('type')!r} "
                             f"is not WordPiece")
        norm = spec.get("normalizer") or {}
        pre = spec.get("pre_tokenizer") or {}
        missing = []
        if norm.get("type") != "BertNormalizer":
            missing.append(f"normalizer {norm.get('type')!r}")
        if pre.get("type") != "BertPreTokenizer":
            missing.append(f"pre-tokenizer {pre.get('type')!r}")
        post = spec.get("post_processor")
        if post is not None and post.get("type") == "BertProcessing":
            template = ([post["cls"][1]], [post["sep"][1]])
        else:
            try:
                template = BpeTokenizer._parse_template(post)
            except ValueError as e:
                missing.append(str(e))
        if missing:
            raise ValueError("tokenizer.json: not ported (WordPiece): "
                             + "; ".join(missing))
        added, added_norm = {}, {}
        for t in spec.get("added_tokens") or []:
            if t.get("lstrip") or t.get("rstrip") or t.get("single_word"):
                raise ValueError(f"added token {t['content']!r}: lstrip, "
                                 f"rstrip and single_word are not ported")
            (added_norm if t.get("normalized", not t.get("special"))
             else added)[t["content"]] = t["id"]
        return cls(
            model["vocab"], lowercase=norm.get("lowercase", True),
            strip_accents=norm.get("strip_accents"),
            clean_text=norm.get("clean_text", True),
            handle_chinese_chars=norm.get("handle_chinese_chars", True),
            unk_token=model.get("unk_token", "[UNK]"),
            prefix=model.get("continuing_subword_prefix", "##"),
            max_input_chars_per_word=model.get("max_input_chars_per_word",
                                               100),
            template=template, added=added, added_normalized=added_norm,
            pad_token=_token_content(config.get("pad_token", "[PAD]")),
            model_max_length=int(config.get("model_max_length", 512)))

    @classmethod
    def from_vocab_txt(cls, path: Union[str, Path],
                       config: Optional[Dict] = None
                       ) -> "WordPieceTokenizer":
        """From ``vocab.txt`` (one token a line, its line number its id)
        and ``tokenizer_config.json``'s ``do_lower_case``,
        ``tokenize_chinese_chars`` and ``strip_accents``: the pipeline
        ``transformers``' ``BertConverter`` builds, with the special tokens
        as added tokens matched in the raw text."""
        config = config or {}
        lines = Path(path).read_text(encoding="utf-8").split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        vocab: Dict[str, int] = {}
        for i, tok in enumerate(lines):
            vocab.setdefault(tok.rstrip("\r"), i)
        special = {}
        for key, default in (("unk_token", "[UNK]"), ("sep_token", "[SEP]"),
                             ("pad_token", "[PAD]"), ("cls_token", "[CLS]"),
                             ("mask_token", "[MASK]")):
            tok = _token_content(config.get(key, default))
            if tok is not None and tok in vocab:
                special[key] = tok
        for key in ("cls_token", "sep_token"):
            if key not in special:
                raise ValueError(f"{path}: the {key} is not in vocab.txt")
        template = ([vocab[special["cls_token"]]],
                    [vocab[special["sep_token"]]])
        return cls(
            vocab, lowercase=config.get("do_lower_case", True),
            strip_accents=config.get("strip_accents"),
            handle_chinese_chars=config.get("tokenize_chinese_chars", True),
            unk_token=special.get("unk_token", "[UNK]"),
            template=template,
            added={t: vocab[t] for t in special.values()},
            pad_token=special.get("pad_token"),
            model_max_length=int(config.get("model_max_length", 512)))

    @classmethod
    def from_dir(cls, path: Union[str, Path]) -> "WordPieceTokenizer":
        """Read ``tokenizer.json`` (or, where it is the only vocabulary,
        ``vocab.txt``) with ``tokenizer_config.json``."""
        path = Path(path)
        config = {}
        if (path / "tokenizer_config.json").is_file():
            config = json.loads((path / "tokenizer_config.json").read_text())
        if (path / "tokenizer.json").is_file():
            return cls.from_spec(json.loads((path / "tokenizer.json")
                                            .read_text(encoding="utf-8")),
                                 config)
        if (path / "vocab.txt").is_file():
            return cls.from_vocab_txt(path / "vocab.txt", config)
        raise ValueError(f"{path}: no tokenizer.json or vocab.txt")

    # -- the pipeline --------------------------------------------------------

    def normalize(self, text: str) -> str:
        """``BertNormalizer``: clean, CJK, accents, lowercase, in that
        order."""
        if self.clean_text:
            text = "".join(" " if _bert_whitespace(c) else c for c in text
                           if c not in "\x00\ufffd" and not _bert_control(c))
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if _cjk(c) else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if self.lowercase:
            text = "".join(c.lower() for c in text)
        return text

    @staticmethod
    def pre_tokenize(text: str) -> List[str]:
        """``BertPreTokenizer``: whitespace removed, each punctuation
        character a word of its own."""
        words: List[str] = []
        cur: List[str] = []
        for c in text:
            if c in WHITE_SPACE or _bert_punct(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                if c not in WHITE_SPACE:
                    words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def wordpiece(self, word: str) -> List[int]:
        """Greedy longest-match-first pieces of ``word``; the unknown token
        for a word past ``max_input_chars_per_word`` characters or one
        with a stretch no piece matches."""
        if len(word) > self.max_chars:
            return [self.unk_id]
        out: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            hit = None
            while start < end:
                piece = word[start:end]
                if start:
                    piece = self.prefix + piece
                hit = self.vocab.get(piece)
                if hit is not None:
                    break
                end -= 1
            if hit is None:
                return [self.unk_id]
            out.append(hit)
            start = end
        return out

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None) -> List[int]:
        """Token ids of ``text``; with ``max_length`` truncated on the right
        so that the ids, ``[CLS]`` and ``[SEP]`` included, number at most
        ``max_length``."""
        ids: List[int] = []
        for is_added, seg, _ in split_added(text, self.added):
            if is_added:
                ids.append(self.added[seg])
                continue
            for is_norm, piece, _ in split_added(self.normalize(seg),
                                                 self.added_norm):
                if is_norm:
                    ids.append(self.added_norm[piece])
                    continue
                for word in self.pre_tokenize(piece):
                    ids.extend(self.wordpiece(word))
        before, after = self._template if add_special_tokens else ([], [])
        if max_length is not None:
            ids = ids[:max(0, max_length - len(before) - len(after))]
        return before + ids + after

    def __call__(self, text: str, padding: str = "max_length",
                 truncation: bool = True, max_length: Optional[int] = None
                 ) -> Dict[str, List[int]]:
        """``{"input_ids", "attention_mask"}``: the ids truncated to
        ``max_length`` (``model_max_length`` by default) and padded on the
        right with the pad token."""
        if padding != "max_length" or not truncation:
            raise ValueError("WordPieceTokenizer pads to max_length with "
                             "truncation only")
        if self.pad_token_id is None:
            raise ValueError("WordPieceTokenizer: no pad token in the "
                             "vocabulary")
        n = self.model_max_length if max_length is None else max_length
        ids = self.encode(text, max_length=n)
        pad = n - len(ids)
        return {"input_ids": ids + [self.pad_token_id] * pad,
                "attention_mask": [1] * len(ids) + [0] * pad}
