"""Device resolution for the port's entry points.

The JAX package picks its platform from the JAX backend
(``ops/attention.py`` ``effective_platform``, ``core/device.py``). The port
runs on the card unless the caller asks for the CPU, and never falls back
quietly: asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

from typing import Union

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
