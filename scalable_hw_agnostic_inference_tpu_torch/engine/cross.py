"""mllama cross-attention slot plumbing: vision states to the per-slot
cross-KV buffers and back out as prefill and continuation arguments.

Port of ``scalable_hw_agnostic_inference_tpu/engine/cross.py``
(``_set_slot_cross``, ``_cross_zeros``, ``_slot_cross_args``), with
:func:`text_cross_args`, the one text-only tail every caller uses. The
admission ladder stays in ``engine.py``; these functions take the engine
explicitly. The buffers are the engine's ``_cross_kv``: per cross layer
``{"k", "v"}`` ``[max_num_seqs, Lv, Hkv, Dh]``, allocated once and written
in place, since every captured decode and verify graph holds their
addresses.
"""

from __future__ import annotations

import torch

from .types import Request


def _set_slot_cross(eng, slot: int, req: Request):
    """Project the request's vision states into the slot's buffer rows, or
    gate the slot off for a text-only request. Returns the one-row prefill
    tail ``(cross_kv [1, Lv, ...] per layer, has_image [1], cross_len
    [1])``."""
    dev = eng.device
    if req.cross_states is None:
        eng._has_image[slot] = 0.0
        eng._cross_len[slot] = eng.cross_text_len
        return tuple(text_cross_args(eng, 1))
    states = torch.as_tensor(req.cross_states).to(dev)
    per_layer = eng._cross_embed(eng.model, states)
    eng._cross_write(eng._cross_kv, per_layer, slot)
    eng._has_image[slot] = 1.0
    n_valid = req.cross_len or eng.cross_text_len
    eng._cross_len[slot] = n_valid
    return ([{"k": buf["k"][slot][None], "v": buf["v"][slot][None]}
             for buf in eng._cross_kv],
            torch.ones((1,), dtype=torch.float32, device=dev),
            torch.full((1,), n_valid, dtype=torch.int32, device=dev))


def text_cross_args(eng, K: int) -> list:
    """The cross tail of ``K`` text-only prefill rows on an mllama engine:
    zero keys, gates off, ``cross_len`` the engine's ``cross_text_len``;
    nothing on a text engine."""
    if eng._cross_kv is None:
        return []
    dev = eng.device
    return [_cross_zeros(eng, K),
            torch.zeros((K,), dtype=torch.float32, device=dev),
            torch.full((K,), eng.cross_text_len, dtype=torch.int32,
                       device=dev)]


def _cross_zeros(eng, K: int):
    """Zero cross-KV prefill arguments for ``K`` text-only rows, made once
    per ``K``."""
    cache = eng._cross_zero_cache
    if K not in cache:
        tmpl = eng._cross_kv[0]["k"]
        shape = (K,) + tuple(tmpl.shape[1:])
        cache[K] = [{"k": torch.zeros(shape, dtype=tmpl.dtype,
                                      device=tmpl.device),
                     "v": torch.zeros(shape, dtype=tmpl.dtype,
                                      device=tmpl.device)}
                    for _ in eng._cross_kv]
    return cache[K]


def _slot_cross_args(eng, slot: int):
    """The one-row cross tail read back from the slot's buffers (the
    continuation chunks of an mllama engine)."""
    dev = eng.device
    return ([{"k": buf["k"][slot][None], "v": buf["v"][slot][None]}
             for buf in eng._cross_kv],
            torch.tensor([eng._has_image[slot]], dtype=torch.float32,
                         device=dev),
            torch.tensor([eng._cross_len[slot]], dtype=torch.int32,
                         device=dev))
