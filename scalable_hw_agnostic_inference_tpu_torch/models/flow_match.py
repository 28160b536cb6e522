"""The flow-matching Euler scheduler (Flux's sampler): numpy tables, an
fp32 step on tensors.

Port of ``scalable_hw_agnostic_inference_tpu/models/flow_match.py``
(``FlowMatchConfig``, ``time_shift``, ``mu_for_seq_len``,
``FlowMatchEuler`` with ``tables`` and ``step``). The sigma schedule is
computed once on the host in numpy, as the reference's; the pipeline
(``models/flux_pipeline.py``) copies the tables to the latents' device once
per (steps, image length) and indexes them a step at a time.

Flow matching: ``x_sigma = (1 - sigma) x0 + sigma noise``; the model
predicts the velocity ``v = noise - x0`` and the Euler step walks sigma
down to 0: ``x_{i+1} = x_i + (sigma_{i+1} - sigma_i) v``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchConfig:
    num_train_timesteps: int = 1000
    shift: float = 1.15          # the static shift (dev also shifts by length)
    use_dynamic_shifting: bool = True
    base_seq_len: int = 256      # mu's interpolation anchors (Flux's)
    max_seq_len: int = 4096
    base_shift: float = 0.5
    max_shift: float = 1.15

    @classmethod
    def from_scheduler_config(cls, sc: dict) -> "FlowMatchConfig":
        """From a diffusers ``scheduler_config.json`` (a dict), with the
        reference's defaults for the keys it omits."""
        return cls(
            num_train_timesteps=sc.get("num_train_timesteps", 1000),
            shift=sc.get("shift", 1.0),
            use_dynamic_shifting=sc.get("use_dynamic_shifting", False),
            base_seq_len=sc.get("base_image_seq_len", 256),
            max_seq_len=sc.get("max_image_seq_len", 4096),
            base_shift=sc.get("base_shift", 0.5),
            max_shift=sc.get("max_shift", 1.15))


def time_shift(mu: float, sigma: np.ndarray) -> np.ndarray:
    """Flux's exponential time shift: more steps near sigma = 1 for large
    images."""
    return np.exp(mu) / (np.exp(mu) + (1.0 / sigma - 1.0))


def mu_for_seq_len(cfg: FlowMatchConfig, seq_len: int) -> float:
    """The shift exponent, linear in the image's token count."""
    m = (cfg.max_shift - cfg.base_shift) / (cfg.max_seq_len - cfg.base_seq_len)
    b = cfg.base_shift - m * cfg.base_seq_len
    return seq_len * m + b


class FlowMatchEuler:
    def __init__(self, cfg: FlowMatchConfig = FlowMatchConfig()):
        self.cfg = cfg

    def tables(self, num_steps: int, image_seq_len: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(timesteps [N] in [0, 1000), sigma [N], sigma_next [N])``,
        float32."""
        sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps)
        if self.cfg.use_dynamic_shifting and image_seq_len:
            sigmas = time_shift(mu_for_seq_len(self.cfg, image_seq_len),
                                sigmas)
        else:
            s = self.cfg.shift
            sigmas = s * sigmas / (1 + (s - 1) * sigmas)
        ts = sigmas * self.cfg.num_train_timesteps
        sig_next = np.concatenate([sigmas[1:], [0.0]])
        return (ts.astype(np.float32), sigmas.astype(np.float32),
                sig_next.astype(np.float32))

    @staticmethod
    def step(sample: torch.Tensor, velocity: torch.Tensor, sigma,
             sigma_next) -> torch.Tensor:
        """One Euler step in fp32."""
        return sample.float() + (sigma_next - sigma) * velocity.float()
