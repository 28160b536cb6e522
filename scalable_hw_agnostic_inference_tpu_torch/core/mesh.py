"""Mesh specs, device slices and the tensor-parallel rank layout.

Port of ``scalable_hw_agnostic_inference_tpu/core/mesh.py``:
:class:`MeshSpec` (``parse``, ``resolve_sizes``, ``axis_names``),
:func:`submesh` and :func:`parse_submesh`, with the reference's errors and
messages. The reference's ``build_mesh`` lays the devices of every host
out as one ``jax.sharding.Mesh``, and XLA runs each device's part; the
port runs one process a rank (``parallel.distributed``), so in its place
:func:`rank_layout` turns a spec, the hosts of ``SHAI_COORDINATOR``
(``core.device.distributed_env``) and this host's devices into the tp
size and each local rank's device.

The port runs tensor parallelism only: an axis other than ``tp`` with a
size above 1 (``dp=2,tp=4``) is refused, where the reference lays it out.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import List, Optional, Sequence, Tuple

import torch

AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")  # tp innermost, as the reference


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parsed mesh spec, e.g. ``"dp=2,tp=4"``: axes in :data:`AXIS_ORDER`,
    a size of ``-1`` meaning "all remaining devices" (at most one axis)."""

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def parse(cls, spec: str) -> "MeshSpec":
        if not spec:
            return cls(axes=())
        axes = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            m = re.fullmatch(r"(\w+)\s*=\s*(-1|[1-9]\d*)", part)
            if not m:
                raise ValueError(
                    f"bad mesh spec component {part!r} in {spec!r} "
                    "(sizes must be positive or -1)"
                )
            name, size = m.group(1), int(m.group(2))
            if name not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {name!r}; expected one "
                                 f"of {AXIS_ORDER}")
            axes.append((name, size))
        names = [n for n, _ in axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis in {spec!r}")
        if sum(1 for _, s in axes if s == -1) > 1:
            raise ValueError("at most one axis may be -1")
        axes.sort(key=lambda kv: AXIS_ORDER.index(kv[0]))
        return cls(axes=tuple(axes))

    def resolve_sizes(self, n_devices: int) -> Tuple[Tuple[str, int], ...]:
        fixed = math.prod(s for _, s in self.axes if s != -1)
        out = []
        for name, s in self.axes:
            if s == -1:
                if n_devices % fixed:
                    raise ValueError(
                        f"{n_devices} devices not divisible by fixed axes "
                        f"product {fixed}"
                    )
                s = n_devices // fixed
            out.append((name, s))
        total = math.prod(s for _, s in out)
        if total > n_devices:
            raise ValueError(f"mesh spec needs {total} devices, have "
                             f"{n_devices}")
        return tuple(out)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)


def cards() -> List[torch.device]:
    """This host's CUDA devices in index order (none without CUDA)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def submesh(start: int, count: int,
            devices: Optional[Sequence] = None) -> List:
    """``devices[start:start+count]`` (default: this host's cards), for
    packing several models onto disjoint devices of one host."""
    devices = list(cards() if devices is None else devices)
    if start < 0 or start + count > len(devices):
        raise ValueError(
            f"submesh [{start}:{start + count}] out of range for "
            f"{len(devices)} devices"
        )
    return devices[start: start + count]


def parse_submesh(spec: str) -> Optional[Tuple[int, int]]:
    """Parse ``"a:b"`` (device slice) into ``(start, count)``; "" -> None."""
    if not spec:
        return None
    m = re.fullmatch(r"(\d+):(\d+)", spec.strip())
    if not m:
        raise ValueError(f"bad submesh spec {spec!r}; expected 'start:end'")
    a, b = int(m.group(1)), int(m.group(2))
    if b <= a:
        raise ValueError(f"empty submesh {spec!r}")
    return a, b - a


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """The ranks of one unit: ``tp`` in all, ``local`` on each of ``hosts``
    hosts (``tp // hosts``), one process each. This host is ``host``; its
    local rank ``i`` is global rank ``host * local + i`` and runs on
    ``devices[i]``. ``coordinator``: ``host:port`` of the group's store
    ("" on one host)."""

    tp: int
    hosts: int
    host: int
    local: int
    devices: Tuple[torch.device, ...]
    coordinator: str = ""

    def rank(self, local_rank: int) -> int:
        return self.host * self.local + local_rank

    @property
    def ranked(self) -> bool:
        """Several ranks, or a coordinator: the unit runs in a group."""
        return self.tp > 1 or bool(self.coordinator)


def rank_layout(spec: str, device: torch.device, backend: str,
                place=None, n_cards: Optional[int] = None,
                first: int = 0) -> RankLayout:
    """The :class:`RankLayout` of ``MESH_SPEC=spec`` on a host whose unit
    device is ``device``, its group over ``backend``: an NCCL rank takes a
    card of its own (local rank ``i`` on card ``i``), gloo ranks all run on
    ``device`` (the CPU, or ranks sharing one card). ``place``: this host's
    ``core.device.HostPlace`` (None: one host). ``n_cards``: this host's
    cards (default: ``torch.cuda.device_count()``). ``first``: the card of
    local rank 0 (``SUBMESH=a:b`` lays NCCL ranks out from card ``a``).

    Raises before anything is allocated or started: an axis other than
    ``tp`` other than 1; ``SHAI_NUM_PROCESSES`` not dividing tp; NCCL off
    the card; more NCCL ranks on a host than it has cards; a ``-1`` size
    over gloo, whose ranks take no card of their own to count."""
    ms = MeshSpec.parse(spec)
    other = {n: s for n, s in ms.axes if n != "tp" and s != 1}
    if other:
        raise ValueError(
            f"MESH_SPEC={spec!r}: this port runs tensor parallelism only, "
            f"one process a rank; axes {other} are refused (name tp alone)")
    hosts = place.num_processes if place is not None else 1
    host = place.process_id if place is not None else 0
    if not 0 <= host < hosts:
        raise ValueError(f"SHAI_PROCESS_ID={host} outside "
                         f"SHAI_NUM_PROCESSES={hosts}")
    if n_cards is None:
        n_cards = len(cards())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group runs on the card, not on {device}")
    if not any(s == -1 for _, s in ms.axes):
        sizes = dict(ms.axes)
    elif backend == "nccl":
        sizes = dict(ms.resolve_sizes(hosts * n_cards))
    else:
        raise ValueError(f"MESH_SPEC={spec!r}: a -1 size counts cards, and "
                         f"{backend} ranks take none of their own: name "
                         f"tp's size")
    tp = sizes.get("tp", 1)
    if tp % hosts:
        raise ValueError(
            f"SHAI_NUM_PROCESSES={hosts} does not divide tp={tp}: each host "
            f"runs tp / SHAI_NUM_PROCESSES ranks, one a card")
    local = tp // hosts
    if backend == "nccl":
        if first + local > n_cards:
            where = f"from card {first}, " if first else ""
            raise ValueError(
                f"MESH_SPEC={spec!r} puts {local} NCCL ranks on this host, "
                f"one a card {where}and it has {n_cards} card(s)")
        devices = tuple(torch.device("cuda", first + i)
                        for i in range(local))
    else:
        devices = (device,) * local
    return RankLayout(tp=tp, hosts=hosts, host=host, local=local,
                      devices=devices,
                      coordinator=place.coordinator if place else "")


__all__ = ["AXIS_ORDER", "MeshSpec", "RankLayout", "cards", "parse_submesh",
           "rank_layout", "submesh"]
