"""Shared per-unit helpers: SSE detokenization, request images, and the
fixed-length tokenization of the conditioning paths.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/serve/units/common.py``
(``HashTokenizer``, ``:23``; ``SseTextAssembler``, ``:43``;
``IMAGENET_MEAN``, ``IMAGENET_STD``, ``:166``; ``tokenize_to_length``,
``:170``; ``decode_image``, ``:180``). The
reference's ``_hf_tokenizer`` (``AutoTokenizer``) becomes the port's own
tokenizers (``models/tokenizer.py``). :func:`unit_ranks` reads the
placement knobs the reference reads with ``core/mesh.py``'s
``parse_submesh`` and ``build_mesh``, through the port's ``core/mesh.py``.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.device import distributed_env, resolve_device
from ...core.mesh import (
    MeshSpec,
    RankLayout,
    cards,
    parse_submesh,
    rank_layout,
    submesh,
)
from ...models import imageio
from ...ops.cuda.flash_attention import HEAD_DIMS
from ...parallel.distributed import DistGroup


class HashTokenizer:
    """Deterministic offline tokenizer (the tiny tier): words hashed into
    ids."""

    def __init__(self, vocab_size: int, max_len: int):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __call__(self, text: str):
        ids = [1]  # [CLS]-ish
        for w in text.lower().split()[: self.max_len - 2]:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(2 + h % (self.vocab_size - 3))
        ids.append(self.vocab_size - 1)  # [SEP]/eot, also the argmax id
        mask = [1] * len(ids) + [0] * (self.max_len - len(ids))
        ids = ids + [0] * (self.max_len - len(ids))
        return np.array(ids), np.array(mask)


#: the ROADMAP item that would bring the remaining units over ranks
RANKS_LATER = "ROADMAP A7.3c"

#: the reference's reason to refuse several hosts at a unit without
#: ``supports_multihost`` (``serve/multihost.py:219-223``)
HOSTS_REFUSED = ("does not declare supports_multihost: its device entries "
                 "are not guaranteed to funnel through mirror_methods, and "
                 "an unmirrored entry would wedge the ranks")


def unit_layout(cfg, multihost: bool = False,
                backend: Optional[str] = None,
                ranks_over: Optional[str] = None
                ) -> Tuple[torch.device, RankLayout]:
    """The unit's device and :class:`~...core.mesh.RankLayout` from
    ``DEVICE``, ``SUBMESH``, ``MESH_SPEC`` and the ``SHAI_COORDINATOR``
    contract (``core.device.distributed_env``). ``ranks_over``: the knob
    that lays the unit out over local ranks (``MESH_SPEC``: ``tp=N``
    ranks, the LLM units and ``t5``; ``SUBMESH``: ``a:b`` gives the ranks
    cards ``a`` to ``b - 1``, and unset every local card, ``flux``, as the
    reference's ``flux`` unit reads it; None: one device). ``multihost``:
    the unit declares ``supports_multihost`` (its ranks may span hosts;
    it implies ``MESH_SPEC``). ``backend``: the group's (default: NCCL on
    the card, gloo on the CPU). Every refusal comes here, before anything
    is allocated or started: a ``SUBMESH`` naming several devices at a
    unit that does not lay its ranks over it, and ``MESH_SPEC`` over
    several devices or a coordinator at a unit that lays none out (both
    :data:`RANKS_LATER`); ``MESH_SPEC`` over several devices where
    ``SUBMESH`` lays the ranks out; several hosts at a unit without
    ``supports_multihost`` (the reference's reason); and
    ``core.mesh.rank_layout``'s (an axis other than tp, a host count that
    does not divide tp, more NCCL ranks than cards)."""
    over = ranks_over or ("MESH_SPEC" if multihost else None)
    device = resolve_device(cfg.device)
    sub = parse_submesh(cfg.submesh)
    if sub is not None and sub[1] > 1 and over != "SUBMESH":
        raise ValueError(
            f"SUBMESH names {sub[1]} devices: packing this unit over "
            f"several devices is tensor parallelism, which this port brings "
            f"to it with {RANKS_LATER} (the flux unit packs its transformer "
            f"over SUBMESH); name one device (SUBMESH=a:a+1) or leave it "
            f"unset")
    place = distributed_env()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    sizes = [s for _, s in MeshSpec.parse(cfg.mesh_spec).axes]
    many = any(s != 1 for s in sizes)
    if over is None:
        if many or place is not None:
            what = (f"SHAI_COORDINATOR={place.coordinator!r} asks for ranks"
                    if place is not None else
                    f"MESH_SPEC names {math.prod(sizes)} devices"
                    if min(sizes) > 0 else
                    f"MESH_SPEC={cfg.mesh_spec!r} names every device")
            raise ValueError(
                f"{what}: this unit runs on one device; its tensor "
                f"parallelism over ranks comes with {RANKS_LATER} (the "
                f"llama, mistral, deepseek and t5 units serve MESH_SPEC="
                f"tp=N, and flux SUBMESH=a:b, through serve_multihost); "
                f"name one device (MESH_SPEC=tp=1) or leave it unset")
        return device, rank_layout("", device, backend)
    if place is not None and place.num_processes > 1 and not multihost:
        raise ValueError(
            f"SHAI_NUM_PROCESSES={place.num_processes} runs the unit over "
            f"{place.num_processes} hosts, and it {HOSTS_REFUSED}; it runs "
            f"over the local ranks of one host (SHAI_NUM_PROCESSES=1)")
    if over == "MESH_SPEC":
        layout = rank_layout(cfg.mesh_spec, device, backend, place)
        if layout.ranked and sub is not None:
            raise ValueError(f"SUBMESH={cfg.submesh!r} places one device, "
                             f"and MESH_SPEC={cfg.mesh_spec!r} runs the unit "
                             f"over ranks: leave SUBMESH unset")
        return device, layout
    if many:
        raise ValueError(
            f"MESH_SPEC={cfg.mesh_spec!r} names several devices, and this "
            f"unit lays its ranks over SUBMESH=a:b, as the reference reads "
            f"it: name the transformer's cards there, and leave MESH_SPEC "
            f"unset")
    if sub is None:
        # the reference's flux spans every local device without SUBMESH
        start, tp = 0, (len(cards()) if device.type == "cuda" else 1)
    else:
        start, tp = sub
    if start and device.type == "cpu":
        raise ValueError(f"SUBMESH={cfg.submesh!r}: the CPU is device 0 "
                         f"only")
    last = start + (tp if backend == "nccl" else 1)
    if device.type == "cuda" and last > len(cards()):
        how = "a card a rank" if backend == "nccl" else "the ranks share one"
        raise ValueError(f"SUBMESH={cfg.submesh!r} asks for cards {start} "
                         f"to {last - 1} ({backend}: {how}), and this host "
                         f"has {len(cards())} card(s)")
    return device, rank_layout(f"tp={tp}", device, backend, place,
                               first=start if backend == "nccl" else 0)


def unit_ranks(cfg, multihost: bool = False,
               group: Optional[DistGroup] = None,
               ranks_over: Optional[str] = None
               ) -> Tuple[torch.device, Optional[DistGroup]]:
    """``(device, group)``: the device this rank of the unit runs on and
    its group, or ``(device, None)`` for a unit on one device (moved to
    the card ``SUBMESH`` names when it names one). A unit over ranks
    (:func:`unit_layout`'s ``ranked``) runs in ``group``, the one
    ``serve.multihost`` gives the service (``ModelService.group``);
    without one, or with one of another size, it raises: nothing runs on
    one rank in place of several."""
    device, layout = unit_layout(cfg, multihost,
                                 group.backend if group else None,
                                 ranks_over)
    if layout.ranked:
        knob = (f"SUBMESH={cfg.submesh!r}" if ranks_over == "SUBMESH"
                else f"MESH_SPEC={cfg.mesh_spec!r}")
        if group is None:
            raise ValueError(
                f"{knob} (tp={layout.tp}, {layout.hosts} host(s)) runs the "
                f"unit as one process a rank: serve it through "
                f"serve.multihost.serve_multihost (python -m "
                f"scalable_hw_agnostic_inference_tpu_torch.serve <unit> "
                f"does), which starts the ranks and gives each its group")
        if group.size != layout.tp:
            raise ValueError(f"{knob} asks tp={layout.tp}, and this "
                             f"process's group has {group.size} ranks")
        return group.device, group
    sub = parse_submesh(cfg.submesh)
    if sub is None:
        return device, None
    if device.type == "cpu":
        if sub[0]:
            raise ValueError(f"SUBMESH={cfg.submesh!r}: the CPU is device "
                             f"0 only")
        return device, None
    if sub[0] >= torch.cuda.device_count():
        raise ValueError(f"SUBMESH={cfg.submesh!r}: this host has "
                         f"{torch.cuda.device_count()} cards")
    return submesh(sub[0], 1)[0], None


def rest_device(devices: Sequence[torch.device]) -> torch.device:
    """The reference's ``rest[0]`` (``serve/units/flux.py:50-56``) for a
    transformer on ``devices`` (every rank's, in rank order): the first
    card outside them, or the first card when they take every one; on the
    CPU, or for gloo ranks sharing one card, that device itself."""
    first = torch.device(devices[0])
    if first.type != "cuda" or len(set(devices)) < len(devices):
        return first
    every = [torch.device("cuda", i) for i in range(len(cards()))]
    rest = [d for d in every if d not in set(devices)] or every[:1]
    return rest[0]


def unit_device(cfg) -> torch.device:
    """The device of a unit that runs on one device (:func:`unit_ranks`
    for a unit without ``supports_multihost``)."""
    return unit_ranks(cfg)[0]


def check_head_size(head_dim: int, device: torch.device, what: str) -> None:
    """On the card every attention runs on B1: refuse a model whose head
    size B1 does not take (the tiny tiers' 16), naming it."""
    if device.type == "cuda" and head_dim not in HEAD_DIMS:
        raise ValueError(
            f"{what} has attention heads of size {head_dim}: on the card "
            f"attention runs only through the B1 kernel, which takes head "
            f"sizes {list(HEAD_DIMS)}; serve a checkpoint (or a geometry "
            f"tier) there, or this model with DEVICE=cpu")


def id2label(hf: Dict[str, Any]) -> Dict[int, str]:
    """``config.json``'s ``id2label`` with integer keys (the JSON file
    spells them as strings, ``transformers`` reads them as ints)."""
    return {int(k): v for k, v in (hf.get("id2label") or {}).items()}


def tokenize_to_length(tok, text: str, length: int) -> np.ndarray:
    """Fixed-length ``[1, length]`` int32 ids from a :class:`HashTokenizer`
    or a tokenizer called as ``tok(text, padding="max_length",
    truncation=True, max_length=length)`` (``models.tokenizer.
    ClipTokenizer``)."""
    if isinstance(tok, HashTokenizer):
        ids, _ = tok(text)
        return np.asarray(ids)[None, :length].astype(np.int32)
    enc = tok(text, padding="max_length", truncation=True, max_length=length)
    return np.asarray(enc["input_ids"], np.int32)[None]


#: HF ``YolosImageProcessor``'s normalization (ImageNet's statistics)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_image(payload: Dict[str, Any], size: int,
                 width: Optional[int] = None, mean=(0.5, 0.5, 0.5),
                 std=(0.5, 0.5, 0.5)) -> np.ndarray:
    """A request's ``image_b64`` (base64 PNG or JPEG, or ``"random"``) ->
    normalized NHWC ``[1, size, width, 3]`` f32 (``width`` defaults to
    ``size``), the reference's ``decode_image``: ``"random"`` (or none)
    is ``default_rng(0)``'s standard normals, unnormalized; an image is
    decoded to RGB as PIL's ``open(...).convert("RGB")`` gives it, resized
    as PIL's default ``resize((width, size))`` does (bicubic), scaled to
    [0, 1] and normalized by ``mean`` and ``std`` (HF CLIP's and ViT's
    0.5/0.5 by default; detection passes :data:`IMAGENET_MEAN` and
    :data:`IMAGENET_STD`), all through ``models.imageio``. Bytes that are
    no base64, or no image it reads, raise ``imageio.ImageError``."""
    h = size
    w = size if width is None else width
    b64 = payload.get("image_b64", "")
    if not b64 or b64 == "random":
        rng = np.random.default_rng(0)
        return rng.standard_normal((1, h, w, 3)).astype(np.float32)
    try:
        # not validated, as the reference decodes it: characters outside
        # the alphabet (line breaks) are skipped
        data = base64.b64decode(str(b64))
    except (binascii.Error, ValueError) as e:
        raise imageio.ImageError(f"not base64 ({e})") from None
    img = imageio.resize_bicubic(imageio.decode_image(data), h, w)
    arr = img.astype(np.float32) / 255.0
    return ((arr - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32))[None]


class SseTextAssembler:
    """Incremental detokenization for SSE token streams.

    Three properties the naive decode-everything loop lacks:

    - **bounded re-decode**: only the held (unflushed) token window is
      re-decoded per token, compacting at whitespace boundaries — O(n·W),
      not O(n²), and lock hold time stays constant;
    - **stop sequences never leak**: text ending with a proper prefix of a
      stop string is held back until the next token disambiguates, so a stop
      spanning a token boundary is truncated exactly like the non-streaming
      path;
    - **partial-UTF-8 holdback with end flush**: trailing U+FFFD is held (it
      may be half a multi-byte sequence) but ``finish()`` flushes it, since
      a model can legitimately end on undecodable bytes.
    """

    # forced compaction bound: newline boundaries are the safe reset points
    # (a mid-sequence suffix re-decode can drop a sentencepiece leading
    # space), so only force a reset once the window grows well past any
    # reasonable line length
    COMPACT_AT = 128

    def __init__(self, decode_fn, stops=()):
        self.decode = decode_fn
        self.stops = [s for s in stops if s]
        self.held: list = []
        self.sent = 0          # chars of the held window already emitted
        self.stopped = False

    def _holdback(self, h: str) -> int:
        """Chars at the end of ``h`` that must not be emitted yet."""
        safe = len(h)
        while safe > 0 and h[safe - 1] == "�":
            safe -= 1
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, safe), 0, -1):
                if h[:safe].endswith(s[:k]):
                    hold = max(hold, k)
                    break
        return safe - hold

    def push(self, tok: int) -> str:
        """Feed one token; return the text delta now safe to emit."""
        if self.stopped:
            return ""
        self.held.append(int(tok))
        h = self.decode(self.held)
        for s in self.stops:
            cut = h.find(s)
            if cut >= 0:
                self.stopped = True
                delta = h[self.sent:cut] if cut > self.sent else ""
                self.sent = len(h)
                return delta
        safe = self._holdback(h)
        delta = h[self.sent:safe] if safe > self.sent else ""
        self.sent = safe
        if self.sent == len(h) and h:
            if h.endswith("\n"):
                self.held = []
                self.sent = 0
            elif len(self.held) >= self.COMPACT_AT:
                # forced mid-line compaction keeps ONE overlap token: the
                # next window then decodes with a preceding-token context,
                # so sentencepiece leading-space normalization cannot drop
                # a space at the seam. sent re-anchors to the
                # overlap token's solo decode — the new window's coordinate
                # system.
                self.held = self.held[-1:]
                self.sent = len(self.decode(self.held))
        return delta

    def finish(self) -> str:
        """End of stream: flush anything the holdbacks retained."""
        if self.stopped or not self.held:
            return ""
        h = self.decode(self.held)
        delta = h[self.sent:]
        self.sent = len(h)
        return delta
