"""Projections for the engine runner.

Port of ``scalable_hw_agnostic_inference_tpu/ops/quant.py:142``
``quant_matmul``, its plain (bf16) branch; int8 weight-only projections
come in a later slice. Weights are ``nn.Linear`` weights, ``[out, in]``.
"""

from __future__ import annotations

import torch


def quant_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ W^T`` in ``x``'s dtype (the weight is cast to it)."""
    return torch.nn.functional.linear(x, weight.to(x.dtype))
