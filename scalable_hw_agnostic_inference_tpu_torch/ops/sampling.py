"""Token sampling on the device: temperature, top-k, top-p, greedy.

Port of ``scalable_hw_agnostic_inference_tpu/ops/sampling.py``
(``greedy``, ``masked_scaled_logits``, ``sampling_probs``,
``sample_logits``, ``sample_excluding``). Every knob may be a scalar or a
per-row tensor. A caller that draws several ways from one set of logits
(speculative verify: the target sample, the rejection resample and the
draft's acceptance probability) computes :func:`masked_scaled_logits` once
and passes it as ``masked``: the same tensor the function would compute,
so the results do not change.

Draws take an explicit ``torch.Generator`` on the logits' device (the
engine seeds one from ``EngineConfig.seed``), or the uniforms already
drawn from one: a captured decode graph reads its draws from a static
buffer the engine refills before every replay, as the reference's
executable takes its rng key as data. They do not reproduce JAX's
threefry bits: the port matches the reference on greedy tokens and on the
sampling distribution (:func:`sampling_probs`), not draw for draw.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30

Knob = Union[float, int, torch.Tensor]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab dim. logits ``[..., V]`` -> tokens ``[...]``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _mask_top_k(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Keep the top ``k`` logits per row; ``k`` ``[...]`` (0 = off)."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = k.clamp(1, V).to(torch.int64)
    thresh = torch.gather(sorted_desc, -1, (k_eff - 1)[..., None])
    masked = torch.where(logits >= thresh, logits,
                         torch.full_like(logits, NEG_INF))
    return torch.where((k > 0)[..., None], masked, logits)


def _mask_top_p(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Nucleus mask; ``p`` ``[...]`` in (0, 1] (1 = off). Keeps tokens while
    the cumulative probability before them is < p, so top-1 always stays."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p[..., None]
    kth = keep_sorted.sum(dim=-1, keepdim=True) - 1
    thresh = torch.gather(sorted_desc, -1, kth.clamp_min(0))
    masked = torch.where(logits >= thresh, logits,
                         torch.full_like(logits, NEG_INF))
    return torch.where((p >= 1.0)[..., None], logits, masked)


def _broadcast_knobs(logits, temperature: Knob, top_k: Knob, top_p: Knob):
    shape = logits.shape[:-1]
    dev = logits.device
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=dev).broadcast_to(shape)
    k = torch.as_tensor(top_k, dtype=torch.int32, device=dev).broadcast_to(
        shape)
    p = torch.as_tensor(top_p, dtype=torch.float32,
                        device=dev).broadcast_to(shape)
    return t, k, p


def masked_scaled_logits(logits: torch.Tensor, temperature: Knob = 1.0,
                         top_k: Knob = 0, top_p: Knob = 1.0) -> torch.Tensor:
    """The post-temperature/top-k/top-p logits :func:`sample_logits` draws
    from (a categorical over these is the sampling distribution)."""
    t, k, p = _broadcast_knobs(logits, temperature, top_k, top_p)
    scaled = logits.float() / t.clamp_min(1e-6)[..., None]
    return _mask_top_p(_mask_top_k(scaled, k), p)


def _masked(logits, temperature, top_k, top_p, masked):
    return (masked_scaled_logits(logits, temperature, top_k, top_p)
            if masked is None else masked)


def _gumbel_argmax(masked: torch.Tensor,
                   rng: Union[torch.Generator, torch.Tensor]) -> torch.Tensor:
    """A categorical draw over ``masked`` logits (Gumbel-max), with
    uniforms in [0, 1) from ``rng``: a generator on the logits' device, or
    a tensor of the logits' shape already drawn."""
    if isinstance(rng, torch.Tensor):
        u = rng
    else:
        u = torch.rand(masked.shape, generator=rng, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(masked + gumbel, dim=-1).to(torch.int32)


def sampling_probs(logits: torch.Tensor, temperature: Knob = 1.0,
                   top_k: Knob = 0, top_p: Knob = 1.0,
                   masked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sampling distribution ``[..., V]`` after temperature, top-k and
    top-p — a point mass on the argmax at ``temperature == 0``.
    Speculative acceptance needs exactly this: a draft outside the nucleus
    must always be rejected."""
    t, _, _ = _broadcast_knobs(logits, temperature, top_k, top_p)
    probs = torch.softmax(
        _masked(logits, temperature, top_k, top_p, masked), dim=-1)
    point = torch.nn.functional.one_hot(
        greedy(logits).long(), logits.shape[-1]).float()
    return torch.where((t <= 0.0)[..., None], point, probs)


def sample_logits(logits: torch.Tensor,
                  rng: Union[torch.Generator, torch.Tensor],
                  temperature: Knob = 1.0, top_k: Knob = 0,
                  top_p: Knob = 1.0,
                  masked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample tokens from ``[..., V]`` logits; ``temperature == 0`` rows
    take the argmax and do not depend on the draws. A Gumbel-max draw over
    :func:`masked_scaled_logits` with uniforms in [0, 1) from ``rng``: a
    generator on the logits' device, or a tensor of the logits' shape
    already drawn (``torch.rand`` of that shape from the same generator
    gives the same tokens)."""
    t, _, _ = _broadcast_knobs(logits, temperature, top_k, top_p)
    sampled = _gumbel_argmax(
        _masked(logits, temperature, top_k, top_p, masked), rng)
    return torch.where(t <= 0.0, greedy(logits), sampled)


def sample_excluding(logits: torch.Tensor,
                     rng: Union[torch.Generator, torch.Tensor],
                     exclude: torch.Tensor, temperature: Knob = 1.0,
                     top_k: Knob = 0, top_p: Knob = 1.0,
                     masked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample from the :func:`sample_logits` distribution with token
    ``exclude [...]`` removed: speculative decoding's rejection resample
    (the residual of a delta proposal is the target distribution with the
    rejected token zeroed, renormalized over the ORIGINAL support). The
    top-k and top-p masks are taken BEFORE the exclusion: taking them after
    would let a rank-(k+1) token in, one vanilla sampling never emits.
    ``rng`` as in :func:`sample_logits`. At temperature 0: the argmax of
    the raw logits with the hole removed."""
    t, _, _ = _broadcast_knobs(logits, temperature, top_k, top_p)
    hole = (exclude.long()[..., None]
            == torch.arange(logits.shape[-1], device=logits.device))
    sampled = _gumbel_argmax(
        _masked(logits, temperature, top_k, top_p, masked).masked_fill(
            hole, NEG_INF), rng)
    return torch.where(t <= 0.0, greedy(logits.masked_fill(hole, NEG_INF)),
                       sampled)
