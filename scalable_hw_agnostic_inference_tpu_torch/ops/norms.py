"""RMS normalization, computed in fp32 whatever the compute dtype.

Port of ``scalable_hw_agnostic_inference_tpu/ops/norms.py`` (``RMSNorm``)
and of the engine runner's ``_rmsnorm`` (``engine/runner.py:88``). The two
differ only in the type they return: the module casts to its configured
compute dtype, the runner's function back to the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """fp32 ``x * rsqrt(mean(x^2) + eps) * scale``."""
    x32 = x.float()
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return n * scale.float()


class RMSNorm(nn.Module):
    """Root-mean-square LayerNorm (no mean subtraction, no bias), the
    Llama convention. The output is cast to ``dtype``, as the reference
    module's is. The Gemma ``scale_offset`` comes with the model that uses
    it."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps).to(self.dtype)
