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

What GSPMD gives the reference for free, a rank-local forward must get
from its split. A fused weight (Flux's ``qkv`` ``[3h, h]``, a single
block's ``linear1`` ``[3h + m, h]`` and ``linear2`` ``[h, h + m]``) is
cut **per section** (:func:`sectioned`): a contiguous cut of ``qkv`` at
tp=2 would give rank 0 all of q and half of k, where its heads need its
half of each. A column-parallel bias splits with its output; a
row-parallel bias stays whole, and the module adds it once, after the
all-reduce.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """A tensor's placement over the tp ranks: ``dim`` is cut into tp
    contiguous slices, rank ``r`` holding slice ``r``; ``None`` means every
    rank holds the whole tensor. With ``sections`` (relative sizes), ``dim``
    is first cut into consecutive sections of those proportions, each
    section is cut into tp contiguous slices, and rank ``r`` holds slice
    ``r`` of every section, concatenated in section order."""

    dim: Optional[int] = None
    sections: Optional[Tuple[int, ...]] = None

    def section_sizes(self, n: int) -> Tuple[int, ...]:
        """The sizes of the sections of a split dim of ``n`` (one section
        without ``sections``); proportions that do not divide ``n``
        raise."""
        if not self.sections:
            return (n,)
        total = sum(self.sections)
        if n % total:
            raise ValueError(f"dim {n} is not cut in the proportions "
                             f"{self.sections}")
        return tuple(n // total * w for w in self.sections)


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


def sectioned(dim: int, *sections: int) -> ShardSpec:
    """A fused weight's ``dim`` cut per section: ``sections`` are the
    sections' relative sizes (``1, 1, 1`` for q | k | v)."""
    return ShardSpec(dim, tuple(int(w) for w in sections))


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
    try:
        sizes = spec.section_sizes(n)
    except ValueError as e:
        raise ValueError(f"illegal sharding: {name}: {e}") from None
    if any(k % tp for k in sizes):
        what = (f"dim {n}" if len(sizes) == 1 else
                f"dim {n}'s sections {list(sizes)}")
        raise ValueError(f"illegal sharding: {name} {what} not divisible "
                         f"by tp={tp}")
    return shape[:spec.dim] + (n // tp,) + shape[spec.dim + 1:]


def shard_tensor(name: str, t: torch.Tensor, spec: ShardSpec, tp: int,
                 rank: int) -> torch.Tensor:
    """Rank ``rank``'s piece of ``t`` under ``spec`` (a view where it is
    one slice; the whole tensor where replicated)."""
    shard_shape(name, t.shape, spec, tp)
    if spec.dim is None or tp == 1:
        return t
    pieces, start = [], 0
    for k in spec.section_sizes(t.shape[spec.dim]):
        pieces.append(t.narrow(spec.dim, start + rank * (k // tp), k // tp))
        start += k
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, spec.dim)


def gather_shards(parts: Sequence[torch.Tensor],
                  spec: ShardSpec) -> torch.Tensor:
    """The whole tensor from every rank's piece (in rank order): the
    inverse of :func:`shard_tensor`, section by section."""
    tp = len(parts)
    if spec.dim is None or tp == 1:
        return parts[0]
    n = parts[0].shape[spec.dim] * tp
    whole, start = [], 0
    for k in spec.section_sizes(n):
        whole.extend(p.narrow(spec.dim, start // tp, k // tp) for p in parts)
        start += k
    return torch.cat(whole, spec.dim)


def shard_state_dict(state: Mapping[str, torch.Tensor],
                     rules: ShardingRules, tp: int, rank: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s state of ``tp`` (the counterpart of
    ``shard_pytree``): each split tensor's slice ``rank`` (of every section,
    for a sectioned split), copied so that the shard owns its storage (the
    full tensor can be freed); replicated tensors as they are. ``device``
    moves every entry there (None: each stays where it is)."""
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
        out[name] = shard_tensor(name, t, spec, tp, rank).to(
            dev, copy=True).contiguous()
    return out


def stream_shard(items: Iterable[Tuple[str, torch.Tensor]],
                 rules: ShardingRules, tp: int, rank: int,
                 device) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard on ``device`` of a state given as ``(name,
    tensor)`` entries, read one at a time (on the CPU, for a rank of
    several): only each entry's slice reaches ``device``, and the whole
    entry is let go before the next is read, so no process holds the
    whole model."""
    shard: Dict[str, torch.Tensor] = {}
    for name, t in items:
        shard.update({k: v.contiguous() for k, v in shard_state_dict(
            {name: t}, rules, tp, rank, device=device).items()})
        del t
    return shard
