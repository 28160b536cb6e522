"""Diffusion noise schedulers (DDIM, Euler): numpy tables, step math on
tensors.

Port of ``scalable_hw_agnostic_inference_tpu/models/schedulers.py``
(``ScheduleConfig``, ``betas_for``, ``alphas_cumprod_for``,
``inference_timesteps``, ``pred_x0_and_eps``, ``DDIM``, ``EulerDiscrete``,
``get_scheduler``). A scheduler is its coefficient tables, computed once
on the host in numpy, and a pure ``step`` over tensors: the denoise loop
(``models/sd.py``) ships the tables to the latents' device once and
indexes them a step at a time, so no step waits on the host.

Both SD2.1 parameterizations: ``epsilon`` (2-1-base, 512 px) and
``v_prediction`` (2-1, 768 px). The table values are float32, as the
reference's; every step computes in float32 in the reference's order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"   # or "linear"
    prediction_type: str = "epsilon"       # or "v_prediction"
    steps_offset: int = 1
    timestep_spacing: str = "leading"


def betas_for(cfg: ScheduleConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(
            cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, cfg.num_train_timesteps
        ) ** 2
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps)
    raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")


def alphas_cumprod_for(cfg: ScheduleConfig) -> np.ndarray:
    return np.cumprod(1.0 - betas_for(cfg))


def inference_timesteps(cfg: ScheduleConfig, num_steps: int) -> np.ndarray:
    """Descending training-timestep indices for an inference run."""
    if num_steps < 1 or num_steps > cfg.num_train_timesteps:
        raise ValueError(f"num_steps={num_steps} out of range")
    if cfg.timestep_spacing == "leading":
        ratio = cfg.num_train_timesteps // num_steps
        ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
        ts = ts + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ratio = cfg.num_train_timesteps / num_steps
        ts = np.arange(cfg.num_train_timesteps, 0, -ratio).round().astype(
            np.int64) - 1
    else:
        raise ValueError(f"unknown timestep spacing {cfg.timestep_spacing!r}")
    return np.clip(ts, 0, cfg.num_train_timesteps - 1)


def pred_x0_and_eps(sample: torch.Tensor, model_out: torch.Tensor,
                    acp_t: torch.Tensor, prediction_type: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover ``(x0, eps)`` from the model output under either
    parameterization. ``acp_t`` broadcasts against ``sample`` (a 0-d
    tensor or ``[B, 1, 1, 1]``)."""
    sqrt_acp = torch.sqrt(acp_t)
    sqrt_1m = torch.sqrt(1.0 - acp_t)
    if prediction_type == "epsilon":
        eps = model_out
        x0 = (sample - sqrt_1m * eps) / sqrt_acp
    elif prediction_type == "v_prediction":
        x0 = sqrt_acp * sample - sqrt_1m * model_out
        eps = sqrt_acp * model_out + sqrt_1m * sample
    else:
        raise ValueError(f"unknown prediction type {prediction_type!r}")
    return x0, eps


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A table value (numpy scalar, float or tensor) as a float32 tensor on
    ``like``'s device."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


class DDIM:
    """Deterministic DDIM (eta=0): :meth:`tables` on the host, a pure
    :meth:`step`."""

    def __init__(self, cfg: ScheduleConfig = ScheduleConfig()):
        self.cfg = cfg
        self.alphas_cumprod = alphas_cumprod_for(cfg)

    def tables(self, num_steps: int):
        """``(timesteps [N] int32, acp_t [N] f32, acp_prev [N] f32)``
        numpy arrays."""
        ts = inference_timesteps(self.cfg, num_steps)
        acp = self.alphas_cumprod
        ratio = self.cfg.num_train_timesteps // num_steps
        prev = ts - ratio
        acp_t = acp[ts].astype(np.float32)
        acp_prev = np.where(prev >= 0, acp[np.clip(prev, 0, None)],
                            1.0).astype(np.float32)
        return ts.astype(np.int32), acp_t, acp_prev

    def step(self, sample: torch.Tensor, model_out: torch.Tensor,
             acp_t, acp_prev) -> torch.Tensor:
        """One deterministic reverse step ``x_t -> x_{t-1}`` in fp32."""
        sample = sample.float()
        model_out = model_out.float()
        acp_t, acp_prev = _f32(acp_t, sample), _f32(acp_prev, sample)
        x0, eps = pred_x0_and_eps(sample, model_out, acp_t,
                                  self.cfg.prediction_type)
        return torch.sqrt(acp_prev) * x0 + torch.sqrt(1.0 - acp_prev) * eps

    @property
    def init_noise_sigma(self) -> float:
        return 1.0


class EulerDiscrete:
    """Euler (discrete) sampler over the sigma ladder: diffusers' default
    SD scheduler, one first-order step per sigma."""

    def __init__(self, cfg: ScheduleConfig = ScheduleConfig()):
        self.cfg = cfg
        acp = alphas_cumprod_for(cfg)
        self.sigmas_all = np.sqrt((1 - acp) / acp)

    def tables(self, num_steps: int):
        """``(timesteps [N] int32, sigma_t [N] f32, sigma_next [N] f32)``,
        ``sigma_next[-1] = 0``."""
        ts = inference_timesteps(self.cfg, num_steps)
        sig = self.sigmas_all[ts].astype(np.float32)
        sig_next = np.concatenate([sig[1:], [0.0]]).astype(np.float32)
        return ts.astype(np.int32), sig, sig_next

    @property
    def init_noise_sigma(self) -> float:
        """Training-grid upper bound; prefer :meth:`init_sigma_for`."""
        return float(np.sqrt(self.sigmas_all.max() ** 2 + 1))

    def init_sigma_for(self, num_steps: int) -> float:
        """Initial latent scale for a run: from the first inference sigma
        (the ladder the steps descend), not the training-grid maximum."""
        ts = inference_timesteps(self.cfg, num_steps)
        s0 = float(self.sigmas_all[ts[0]])
        return float(np.sqrt(s0 ** 2 + 1))

    def scale_model_input(self, sample: torch.Tensor, sigma) -> torch.Tensor:
        sigma = _f32(sigma, sample)
        return sample / torch.sqrt(sigma ** 2 + 1)

    def step(self, sample: torch.Tensor, model_out: torch.Tensor, sigma,
             sigma_next) -> torch.Tensor:
        """``x_{i+1} = x_i + (sigma_next - sigma) * d``, ``d = (x - x0) /
        sigma``."""
        sample = sample.float()
        model_out = model_out.float()
        sigma, sigma_next = _f32(sigma, sample), _f32(sigma_next, sample)
        acp_t = 1.0 / (sigma ** 2 + 1.0)
        # the model saw the scaled input: x0 in sigma space
        if self.cfg.prediction_type == "epsilon":
            x0 = sample - sigma * model_out
        elif self.cfg.prediction_type == "v_prediction":
            x0 = sample * acp_t - model_out * (sigma * torch.sqrt(acp_t))
        else:
            raise ValueError(self.cfg.prediction_type)
        d = (sample - x0) / sigma
        return sample + (sigma_next - sigma) * d


SCHEDULERS = {"ddim": DDIM, "euler": EulerDiscrete}


def get_scheduler(name: str, cfg: ScheduleConfig = ScheduleConfig()):
    try:
        return SCHEDULERS[name](cfg)
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; have {sorted(SCHEDULERS)}") from None
