"""A byte-level BPE tokenizer read from ``tokenizer.json``: the Llama-3
family's.

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

Anything else raises, naming what is missing: another pre-tokenizer or
regex, a normalizer, a SentencePiece-style model (``Metaspace`` with byte
fallback, e.g. Mistral's), BPE dropout or word affixes, added tokens that
strip or match whole words only.
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
        self._check_pipeline(spec)
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.merges[(self.vocab[a], self.vocab[b])] = (
                rank, self.vocab[a + b])
        self.added: Dict[str, int] = {}
        self.special_ids = set()
        for t in spec.get("added_tokens") or []:
            if t.get("lstrip") or t.get("rstrip") or t.get("single_word"):
                raise ValueError(f"added token {t['content']!r}: lstrip, "
                                 f"rstrip and single_word are not ported")
            self.added[t["content"]] = t["id"]
            if t.get("special"):
                self.special_ids.add(t["id"])
        self.id_to_token = {i: s for s, i in self.vocab.items()}
        self.id_to_token.update({i: s for s, i in self.added.items()})
        self._template = self._parse_template(spec.get("post_processor"))
        self.truncation_side = config.get("truncation_side", "right")
        self.clean_up_spaces = bool(config.get(
            "clean_up_tokenization_spaces", False))
        self.chat_template = config.get("chat_template")
        self.bos_token_id = self._token_id(config.get("bos_token"))
        self.eos_token_id = self._token_id(config.get("eos_token"))
        self.pad_token_id = self._token_id(config.get("pad_token"))

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
        if content in self.added:
            return self.added[content]
        return self.vocab.get(content)

    def _split_added(self, text: str) -> List[Tuple[bool, str]]:
        """``(is an added token, text)`` segments: added tokens matched in
        the raw text, leftmost first and the longest at a position."""
        out: List[Tuple[bool, str]] = []
        if not self.added:
            return [(False, text)] if text else []
        i = start = 0
        n = len(text)
        while i < n:
            best = max((t for t in self.added if text.startswith(t, i)),
                       key=len, default=None)
            if best is None:
                i += 1
                continue
            if i > start:
                out.append((False, text[start:i]))
            out.append((True, best))
            i = start = i + len(best)
        if start < n:
            out.append((False, text[start:]))
        return out

    def _bpe(self, piece: str) -> List[int]:
        """One pre-tokenized piece (ByteLevel characters) -> ids, merged as
        the ``tokenizers`` BPE model merges: a heap of (rank, position),
        stale entries skipped when their pair no longer makes the same
        token."""
        if self.ignore_merges and piece in self.vocab:
            return [self.vocab[piece]]
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
        for is_added, seg in self._split_added(text):
            if is_added:
                ids.append(self.added[seg])
                continue
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
        invalid UTF-8, then the clean-up the config asks for."""
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
