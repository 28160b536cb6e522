"""Tensor-parallel sharding rules over state-dict names.

Port of ``scalable_hw_agnostic_inference_tpu/parallel/sharding.py``
(``column_parallel``, ``row_parallel``, ``replicated``, ``ShardingRules``
with ``spec_for`` and ``tree_specs``, ``shard_pytree``). The reference
annotates a flax tree with ``PartitionSpec``s and lets XLA cut the arrays
and insert the collectives; here a rule names the one dim of a tensor that
the tp ranks split into contiguous slices, :func:`shard_state_dict` cuts
rank ``r``'s slices, and the rank-local modules call the collectives
themselves (``models/llama.py``).

The port's projections are ``nn.Linear`` weights ``[out, in]``, the
transpose of flax's ``[in, out]`` kernels: column-parallel splits dim 0
here where the reference's ``P(None, tp)`` splits dim 1, and row-parallel
dim 1 where ``P(tp, None)`` splits dim 0. An ``[out]`` scale or bias has
one dim in both layouts, and an embedding table ``[rows, features]`` is
not transposed.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """A tensor's placement over the tp ranks: ``dim`` is cut into tp
    contiguous slices, rank ``r`` holding slice ``r``; ``None`` means every
    rank holds the whole tensor."""

    dim: Optional[int] = None


def column_parallel() -> ShardSpec:
    """A weight ``[out, in]`` split on its output dim (and an ``[out]``
    scale with it): ``y = x @ W^T`` keeps the contraction local, and each
    rank holds its slice of the outputs."""
    return ShardSpec(0)


def row_parallel() -> ShardSpec:
    """A weight ``[out, in]`` split on its input dim: each rank's product is
    a partial sum, reduced across the ranks (the reference's psum)."""
    return ShardSpec(1)


def replicated() -> ShardSpec:
    return ShardSpec(None)


class ShardingRules:
    """Ordered (regex -> :class:`ShardSpec`) table over state-dict names.

    First match wins (``re.search``); unmatched names are replicated. A rule
    whose split dim the tensor does not have raises, so a typo'd rule fails
    loudly rather than silently replicating a 20 GB weight.
    """

    def __init__(self, rules: Sequence[Tuple[str, ShardSpec]]):
        self.rules: List[Tuple[re.Pattern, ShardSpec]] = [
            (re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, name: str, ndim: Optional[int] = None) -> ShardSpec:
        for pat, spec in self.rules:
            if pat.search(name):
                if (ndim is not None and spec.dim is not None
                        and spec.dim >= ndim):
                    raise ValueError(
                        f"rule {pat.pattern!r} splits dim {spec.dim} of "
                        f"{name} (ndim={ndim})")
                return spec
        return replicated()

    def state_specs(self, state: Mapping[str, torch.Tensor]
                    ) -> Dict[str, ShardSpec]:
        """A :class:`ShardSpec` per entry of ``state`` (the reference's
        ``tree_specs``)."""
        return {name: self.spec_for(name, t.dim())
                for name, t in state.items()}


def shard_shape(name: str, shape: Sequence[int], spec: ShardSpec,
                tp: int) -> Tuple[int, ...]:
    """One rank's shape of a tensor of ``shape`` under ``spec``; a split dim
    that ``tp`` does not divide raises (the reference's ``device_put``
    failure, and ``core.budget.params_bytes_per_chip``'s)."""
    shape = tuple(int(d) for d in shape)
    if spec.dim is None:
        return shape
    n = shape[spec.dim]
    if n % tp:
        raise ValueError(f"illegal sharding: {name} dim {n} not divisible "
                         f"by tp={tp}")
    return shape[:spec.dim] + (n // tp,) + shape[spec.dim + 1:]


def shard_state_dict(state: Mapping[str, torch.Tensor],
                     rules: ShardingRules, tp: int, rank: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s state of ``tp`` (the counterpart of
    ``shard_pytree``): each split tensor's contiguous slice ``rank``, copied
    so that the shard owns its storage (the full tensor can be freed);
    replicated tensors as they are. ``device`` moves every entry there
    (None: each stays where it is)."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        spec = rules.spec_for(name, t.dim())
        dev = t.device if device is None else torch.device(device)
        if spec.dim is None or tp == 1:
            shard_shape(name, t.shape, spec, tp)
            out[name] = t.to(dev)
            continue
        n = shard_shape(name, t.shape, spec, tp)[spec.dim]
        out[name] = t.narrow(spec.dim, rank * n, n).to(
            dev, copy=True).contiguous()
    return out
