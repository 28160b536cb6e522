"""Stable Diffusion 2.x text-to-image: text encoder, UNet denoise loop,
VAE decode.

Port of ``scalable_hw_agnostic_inference_tpu/models/sd.py`` (``SDVariant``,
``StableDiffusion`` with ``_make_step``, ``init_latents``, ``txt2img``,
``txt2img_batch``, ``txt2img_stepwise`` and ``warm``;
``variant_from_checkpoint``, ``load_torch_state``,
``resolve_checkpoint_dir``, ``to_png_base64``).

The reference runs the whole denoise loop as one jitted ``lax.scan``; here
the loop is eager on the latents' device: the scheduler's tables go to the
device once per steps value, every step is :meth:`StableDiffusion.
_make_step`'s single definition (the pair ``[uncond; cond]`` through the
UNet as one batch of ``2B``, the guidance mix, the scheduler update), and
nothing waits on the host until the uint8 image is read back. The VAE
decode, the clip to [0, 255] and the rounding run on the device too. The
reference splits a batch of 2 to 4 into single-image decodes on the TPU
only (an XLA:TPU memory pathology); that split does not carry over.

Seeds: the reference draws a request's initial latents from
``jax.random.PRNGKey(seed)`` (Threefry, not ported); the port draws them
from a CPU ``torch.Generator`` seeded with ``seed``, so a seed gives the
same latents on the CPU and on the card, and a different image from a JAX
pod's (ROADMAP C). The parity tests hand both pipelines the same latents
through :meth:`StableDiffusion.txt2img_batch`.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
from pathlib import Path
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from ..core.checkpoint import Checkpoint
from .imageio import encode_png
from .schedulers import EulerDiscrete, ScheduleConfig, get_scheduler
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass(frozen=True)
class SDVariant:
    """A model family's geometry and its schedule's parameterization."""

    name: str
    unet: UNetConfig
    vae: VAEConfig
    schedule: ScheduleConfig
    default_size: int = 512

    @classmethod
    def sd21_base(cls) -> "SDVariant":
        """stabilityai/stable-diffusion-2-1-base: 512 px, epsilon."""
        return cls("sd21-base", UNetConfig.sd21(), VAEConfig(),
                   ScheduleConfig(prediction_type="epsilon"), 512)

    @classmethod
    def sd21(cls) -> "SDVariant":
        """stabilityai/stable-diffusion-2-1: 768 px, v-prediction."""
        return cls("sd21", UNetConfig.sd21(), VAEConfig(),
                   ScheduleConfig(prediction_type="v_prediction"), 768)

    @classmethod
    def sd15(cls) -> "SDVariant":
        return cls("sd15", UNetConfig.sd15(), VAEConfig(),
                   ScheduleConfig(prediction_type="epsilon"), 512)

    @classmethod
    def tiny(cls) -> "SDVariant":
        return cls("tiny", UNetConfig.tiny(), VAEConfig.tiny(),
                   ScheduleConfig(prediction_type="epsilon"), 64)


Seed = Union[int, torch.Generator]


class StableDiffusion:
    """txt2img over a UNet, a VAE and ``text_encode(ids) -> [B, L, ctx]``
    (the CLIP encoder, or a test's stub), all on one device."""

    def __init__(self, variant: SDVariant, unet: UNet2DCondition,
                 vae: AutoencoderKL,
                 text_encode: Callable[[torch.Tensor], torch.Tensor],
                 scheduler: str = "ddim"):
        self.variant = variant
        self.unet, self.vae = unet, vae
        self.text_encode = text_encode
        self.device = unet.device
        self.scheduler = get_scheduler(scheduler, variant.schedule)
        # spatial down-factor of the VAE (8 for SD's 4 levels)
        self.vae_scale = 2 ** (len(variant.vae.block_out) - 1)
        self._tables: Dict[int, Tuple[torch.Tensor, ...]] = {}

    # -- the denoise step -------------------------------------------------

    def tables(self, steps: int) -> Tuple[torch.Tensor, ...]:
        """The scheduler's tables for ``steps`` on the device (copied
        once): ``(timesteps, a, a2)``."""
        if steps not in self._tables:
            self._tables[steps] = tuple(
                torch.from_numpy(np.ascontiguousarray(t)).to(self.device)
                for t in self.scheduler.tables(steps))
        return self._tables[steps]

    def _make_step(self, B: int) -> Callable:
        """The denoise step (the ``[uncond; cond]`` pair, the guidance
        mix, the scheduler update): the single definition the loop and
        the stepwise mode both call."""
        sch, unet = self.scheduler, self.unet
        is_euler = isinstance(sch, EulerDiscrete)

        def one(lat, t, a, a2, ctx2, guidance: float):
            model_in = sch.scale_model_input(lat, a) if is_euler else lat
            pair = torch.cat([model_in, model_in], dim=0)
            tt = torch.as_tensor(t, device=lat.device).to(
                torch.int32).reshape(1).expand(2 * B)
            out = unet(pair, tt, ctx2)
            out_u, out_c = out.chunk(2, dim=0)
            out = out_u + guidance * (out_c - out_u)
            return sch.step(lat, out, a, a2)

        return one

    def _init_scale(self, steps: int) -> float:
        sch = self.scheduler
        if isinstance(sch, EulerDiscrete):
            return sch.init_sigma_for(steps)
        return sch.init_noise_sigma

    def _denoise(self, lat: torch.Tensor, ctx2: torch.Tensor, steps: int,
                 guidance: float) -> torch.Tensor:
        one = self._make_step(lat.shape[0])
        ts, a_t, a_p = self.tables(steps)
        for i in range(steps):
            lat = one(lat, ts[i], a_t[i], a_p[i], ctx2, guidance)
        return lat

    def _decode_body(self, lat: torch.Tensor) -> torch.Tensor:
        """VAE decode, then [-1, 1] -> uint8 on the device."""
        return self.vae.decode_uint8(lat)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids)).to(self.device, torch.int64)

    def _context(self, prompt_ids, uncond_ids) -> torch.Tensor:
        # uncond first, cond second: the split order of the step
        return self.text_encode(torch.cat([self._ids(uncond_ids),
                                           self._ids(prompt_ids)], dim=0))

    def _latent_hw(self, height: int, width: int) -> Tuple[int, int]:
        f = self.vae_scale
        if height % f or width % f:
            raise ValueError(f"height/width must be multiples of {f}")
        return height // f, width // f

    def _draw(self, rng: Seed, B: int, h: int, w: int,
              steps: int) -> torch.Tensor:
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator().manual_seed(int(rng))
        lat = torch.randn((B, h, w, self.variant.unet.in_channels),
                          generator=gen, dtype=torch.float32)
        return (lat * self._init_scale(steps)).to(self.device)

    # -- public API -------------------------------------------------------

    def init_latents(self, seed: int, h: int, w: int,
                     steps: int) -> torch.Tensor:
        """One request's ``[1, h, w, C]`` initial latents on the device:
        ``torch.Generator().manual_seed(seed)``'s normals (drawn on the
        CPU) times the scheduler's initial scale."""
        return self._draw(seed, 1, h, w, steps)

    def txt2img_batch(self, prompt_ids, uncond_ids, latents: torch.Tensor,
                      *, height: int, width: int, steps: int = 25,
                      guidance_scale: float = 7.5) -> np.ndarray:
        """Batched txt2img over given latents (the coalescer's path):
        ``prompt_ids``/``uncond_ids [B, L]``, ``latents [B, h, w, C]``.
        Returns uint8 ``[B, H, W, 3]``."""
        self._latent_hw(height, width)    # H, W multiples of vae_scale
        with torch.inference_mode():
            ctx2 = self._context(prompt_ids, uncond_ids)
            lat = self._denoise(latents.to(self.device, torch.float32), ctx2,
                                steps, float(guidance_scale))
            return self._decode_body(lat).cpu().numpy()

    def txt2img(self, prompt_ids, uncond_ids, *, rng: Seed, height: int,
                width: int, steps: int = 25,
                guidance_scale: float = 7.5) -> np.ndarray:
        """uint8 images ``[B, H, W, 3]``, the initial latents drawn from
        ``rng`` (a seed or a CPU ``torch.Generator``); at ``B = 1`` the
        same image as :meth:`txt2img_batch` over ``init_latents(seed)``."""
        h, w = self._latent_hw(height, width)
        B = np.asarray(prompt_ids).shape[0]
        lat = self._draw(rng, B, h, w, steps)
        return self.txt2img_batch(prompt_ids, uncond_ids, lat, height=height,
                                  width=width, steps=steps,
                                  guidance_scale=guidance_scale)

    def txt2img_stepwise(self, prompt_ids, uncond_ids, *, rng: Seed,
                         height: int, width: int, steps: int = 25,
                         guidance_scale: float = 7.5) -> np.ndarray:
        """:meth:`txt2img` with each step's table values handed in from
        the host (the reference's per-step dispatch mode)."""
        h, w = self._latent_hw(height, width)
        B = np.asarray(prompt_ids).shape[0]
        lat = self._draw(rng, B, h, w, steps)
        one = self._make_step(B)
        ts, a_t, a_p = self.scheduler.tables(steps)
        with torch.inference_mode():
            ctx2 = self._context(prompt_ids, uncond_ids)
            for i in range(len(ts)):
                lat = one(lat, int(ts[i]), a_t[i], a_p[i], ctx2,
                          float(guidance_scale))
            return self._decode_body(lat).cpu().numpy()

    def warm(self, B: int, height: int, width: int, steps: int,
             seq_len: int) -> None:
        """Run one ``(B, H, W)`` shape before readiness (cuDNN's algorithm
        choice, the allocator): nothing is compiled here, so ``steps``
        only sets the run's length."""
        ids = np.zeros((B, seq_len), np.int64)
        self.txt2img(ids, ids, rng=0, height=height, width=width,
                     steps=steps, guidance_scale=7.5)


# -- checkpoints (a diffusers directory; no diffusers dependency) ---------------

def resolve_checkpoint_dir(
        model_id: str,
        components: str = "unet/, vae/, text_encoder/, tokenizer/, "
                          "scheduler/") -> str:
    """A local diffusers directory as it is. A hub id is refused: the port
    fetches nothing (download the checkpoint, holding ``components``, and
    name its directory)."""
    if os.path.isdir(model_id):
        return model_id
    raise ValueError(
        f"MODEL_ID={model_id!r} is not a local directory; this port does "
        f"not download from the hub: fetch the checkpoint ({components}) "
        f"and set MODEL_ID to its path")


def load_torch_state(component_dir: Union[str, Path]) -> Checkpoint:
    """One pipeline component's tensors, read through the port's
    safetensors reader (``diffusion_pytorch_model.safetensors``,
    ``model.safetensors`` or shards). A directory with only a ``.bin``
    pickle is refused with a message."""
    if not os.path.isdir(component_dir):
        raise FileNotFoundError(f"no weights found under {component_dir}")
    return Checkpoint(component_dir)


def variant_from_checkpoint(root: Union[str, Path]) -> SDVariant:
    """An :class:`SDVariant` from a checkpoint's component configs."""
    root = str(root)
    with open(os.path.join(root, "unet", "config.json")) as f:
        unet_cfg = json.load(f)
    with open(os.path.join(root, "vae", "config.json")) as f:
        vae_cfg = json.load(f)
    sched_path = os.path.join(root, "scheduler", "scheduler_config.json")
    sched: Dict = {}
    if os.path.exists(sched_path):
        with open(sched_path) as f:
            sched = json.load(f)
    schedule = ScheduleConfig(
        num_train_timesteps=sched.get("num_train_timesteps", 1000),
        beta_start=sched.get("beta_start", 0.00085),
        beta_end=sched.get("beta_end", 0.012),
        beta_schedule=sched.get("beta_schedule", "scaled_linear"),
        prediction_type=sched.get("prediction_type", "epsilon"),
        steps_offset=sched.get("steps_offset", 1),
    )
    return SDVariant(
        name=os.path.basename(root.rstrip("/")),
        unet=UNetConfig.from_hf(unet_cfg),
        vae=VAEConfig.from_hf(vae_cfg),
        schedule=schedule,
        default_size=unet_cfg.get("sample_size", 64) * 8,
    )


def to_png_base64(img: np.ndarray) -> str:
    """uint8 ``[H, W, 3]`` -> a base64 PNG (the reference's wire format)."""
    return base64.b64encode(encode_png(img)).decode()
