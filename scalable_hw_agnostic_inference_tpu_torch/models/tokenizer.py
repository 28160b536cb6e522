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
- ``eos_token_id``, ``pad_token_id`` and ``chat_template`` from
  ``tokenizer_config.json`` (``special_tokens_map.json`` where it is
  silent).

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
normalizer, decoder or regex, a Unigram or WordPiece model, BPE dropout or
word affixes, added tokens that strip or match whole words only.
"""

from __future__ import annotations

import heapq
import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
        missing.append(f"model {model.get('type')!r} (only BPE)")
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


def _token_content(v) -> Optional[str]:
    if v is None or isinstance(v, str):
        return v
    return v.get("content")


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
        self.chat_template = config.get("chat_template")
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
        if (path / "special_tokens_map.json").is_file():
            smap = json.loads((path / "special_tokens_map.json").read_text())
            for key in ("bos_token", "eos_token", "pad_token"):
                if config.get(key) is None and smap.get(key) is not None:
                    config[key] = smap[key]
        return cls(spec, config)

    # -- the pipeline's parts ----------------------------------------------

    @staticmethod
    def _check_pipeline(spec: Dict) -> None:
        model = spec.get("model") or {}
        missing = []
        if model.get("type") != "BPE":
            missing.append(f"model {model.get('type')!r} (only BPE)")
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
        """``(is an added token, text, offset)`` segments: the ``added``
        tokens (the raw-matched ones by default) matched in ``text``,
        leftmost first and the longest at a position."""
        added = self.added if added is None else added
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
        SentencePiece-style word) -> ids, merged as the ``tokenizers`` BPE
        model merges: a heap of (rank, position), stale entries skipped
        when their pair no longer makes the same token."""
        if self.ignore_merges and piece in self.vocab:
            return [self.vocab[piece]]
        if self.sp is not None:
            ids = self._initial(piece)
        else:
            ids = [self.vocab[c] for c in piece if c in self.vocab]
        n = len(ids)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = self.merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = pos
            if prv[pos] != -1:
                m = self.merges.get((ids[prv[pos]], ids[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] != -1:
                m = self.merges.get((ids[pos], ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]

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
