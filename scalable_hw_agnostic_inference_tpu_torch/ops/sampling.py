"""Token sampling on the device: temperature, top-k, top-p, greedy.

Port of ``scalable_hw_agnostic_inference_tpu/ops/sampling.py``
(``greedy``, ``masked_scaled_logits``, ``sampling_probs``,
``sample_logits``). Every knob may be a scalar or a per-row tensor.

Draws take an explicit ``torch.Generator`` on the logits' device (the
engine seeds one from ``EngineConfig.seed``). They do not reproduce JAX's
threefry bits: the port matches the reference on greedy tokens and on the
sampling distribution (:func:`sampling_probs`), not draw for draw.
"""

from __future__ import annotations

from typing import Union

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


def sampling_probs(logits: torch.Tensor, temperature: Knob = 1.0,
                   top_k: Knob = 0, top_p: Knob = 1.0) -> torch.Tensor:
    """The sampling distribution ``[..., V]`` after temperature, top-k and
    top-p — a point mass on the argmax at ``temperature == 0``."""
    t, _, _ = _broadcast_knobs(logits, temperature, top_k, top_p)
    probs = torch.softmax(
        masked_scaled_logits(logits, temperature, top_k, top_p), dim=-1)
    point = torch.nn.functional.one_hot(
        greedy(logits).long(), logits.shape[-1]).float()
    return torch.where((t <= 0.0)[..., None], point, probs)


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: Knob = 1.0, top_k: Knob = 0,
                  top_p: Knob = 1.0) -> torch.Tensor:
    """Sample tokens from ``[..., V]`` logits; ``temperature == 0`` rows
    take the argmax. A Gumbel-max draw over :func:`masked_scaled_logits`
    with uniforms from ``generator`` (on the logits' device)."""
    t, _, _ = _broadcast_knobs(logits, temperature, top_k, top_p)
    masked = masked_scaled_logits(logits, temperature, top_k, top_p)
    u = torch.rand(masked.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    sampled = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return torch.where(t <= 0.0, greedy(logits), sampled)
