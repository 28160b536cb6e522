"""Device resolution for the port's entry points.

The JAX package picks its platform from the JAX backend
(``ops/attention.py`` ``effective_platform``, ``core/device.py``). The port
runs on the card unless the caller asks for the CPU, and never falls back
quietly: asking for CUDA on a machine without it raises.

:func:`distributed_env` reads the reference's multi-host env contract
(``core/device.py`` ``maybe_distributed_init``) and returns this host's
place in the unit; nothing joins a group here (``serve.multihost`` does,
after ``core.mesh.rank_layout`` has checked the layout).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Union

import torch

VALID_DEVICES = ("cuda", "cpu")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without
    CUDA); ``"cpu"`` -> the CPU; a ``torch.device`` passes through after
    the same check."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in VALID_DEVICES:
        raise ValueError(f"device {dev} not supported; expected one of "
                         f"{VALID_DEVICES}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the card unless "
                "it is asked for the CPU (device='cpu', DEVICE=cpu)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class HostPlace:
    """This host's place in a unit over several hosts: ``coordinator``
    (``host:port`` of process 0, where global rank 0 serves the group's
    store), ``num_processes`` hosts, this one ``process_id``."""

    coordinator: str
    num_processes: int
    process_id: int


def distributed_env(env: Optional[Mapping[str, str]] = None
                    ) -> Optional[HostPlace]:
    """The reference's env contract, set by the StatefulSet from the pod
    ordinal: ``SHAI_COORDINATOR`` (``host:port`` of process 0),
    ``SHAI_NUM_PROCESSES`` and ``SHAI_PROCESS_ID``. Unset (or empty)
    coordinator: one host, None. With a coordinator, a missing count or id
    raises ``KeyError`` and a malformed one ``ValueError``, as the
    reference's ``int(env[...])`` does."""
    env = os.environ if env is None else env
    coord = env.get("SHAI_COORDINATOR", "")
    if not coord:
        return None
    return HostPlace(coordinator=coord,
                     num_processes=int(env["SHAI_NUM_PROCESSES"]),
                     process_id=int(env["SHAI_PROCESS_ID"]))
