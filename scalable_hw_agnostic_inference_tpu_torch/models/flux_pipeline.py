"""Flux text-to-image: T5 and CLIP conditioning, the flow-match denoise
loop, the VAE decode.

Port of ``scalable_hw_agnostic_inference_tpu/models/flux_pipeline.py``
(``FluxPipeline`` with ``txt2img`` and ``warm``). Guidance is FLUX.1-dev's
distilled embedding, not classifier-free guidance: one transformer pass a
step, no batch doubling.

The reference runs the denoise as one jitted ``lax.scan`` and places the
transformer and the encoders on separate device slices (``mesh``,
``encoder_device``). Here the loop is eager: the scheduler's tables and
the RoPE ids go to the device once per shape, each step is one
transformer forward and an fp32 Euler update, and nothing waits on the
host until the uint8 image is read back; the VAE decode and its uint8
rounding run on the device (``vae.AutoencoderKL.decode_uint8``). T5,
CLIP and the VAE live on ``encoder_device`` (the reference's
``rest[0]``), the transformer on its own device.

Over a group (the transformer's tensor-parallel ranks, one process
each): only rank 0, the leader, holds T5, CLIP and the VAE. It encodes
the prompt and broadcasts the text hidden state ``[B, Lt, t5_dim]`` and
the pooled vector ``[B, clip_dim]`` over the compute group; every rank
draws the same latents from the request's seed (a CPU generator: no
broadcast), runs every step of its rank-local transformer, and only the
leader decodes (a follower's :meth:`FluxPipeline.txt2img` returns None).

Seeds: the reference draws the initial latents from
``jax.random.PRNGKey(seed)`` (Threefry, not ported); here they come from a
CPU ``torch.Generator`` seeded with the request's seed, so a seed gives
the same image on the CPU and on the card, and another image than a JAX
pod's (ROADMAP C, as for Stable Diffusion). :meth:`FluxPipeline.denoise`
takes given latents, so the parity tests hand both packages one draw.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .flow_match import FlowMatchConfig, FlowMatchEuler
from .flux import FluxTransformer, make_ids, patchify, unpatchify
from .vae import AutoencoderKL

Seed = Union[int, torch.Generator]


class FluxPipeline:
    """txt2img over a transformer, a VAE, ``t5_encode(ids) -> [B, L,
    t5_dim]`` and ``clip_pooled(ids) -> [B, clip_dim]``; the encoders and
    the VAE on ``encoder_device`` (default: the transformer's). ``group``:
    the transformer's ranks (module note); a follower passes no VAE or
    encoders, and ``vae_scale``, the VAE's downsampling, in their
    place."""

    def __init__(self, transformer: FluxTransformer,
                 vae: Optional[AutoencoderKL],
                 t5_encode: Optional[Callable[[torch.Tensor], torch.Tensor]],
                 clip_pooled: Optional[Callable[[torch.Tensor],
                                                torch.Tensor]],
                 schedule: FlowMatchConfig = FlowMatchConfig(),
                 group=None, encoder_device=None,
                 vae_scale: Optional[int] = None):
        self.cfg = transformer.cfg
        self.model, self.vae = transformer, vae
        self.t5_encode, self.clip_pooled = t5_encode, clip_pooled
        self.device = transformer.device
        self.group = group
        #: this rank encodes and decodes (no group, or rank 0)
        self.leader = group is None or group.rank == 0
        self.encoder_device = (self.device if encoder_device is None
                               else torch.device(encoder_device))
        self.scheduler = FlowMatchEuler(schedule)
        self.latent_ch = self.cfg.in_channels // 4
        self.vae_scale = (2 ** (len(vae.cfg.block_out) - 1)
                          if vae is not None else int(vae_scale))
        self._tables: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}
        self._ids: Dict[Tuple[int, int, int, int], torch.Tensor] = {}
        #: every (batch, latent h, latent w, text length) denoised so far
        self.shape_keys = set()

    def tables(self, steps: int, img_len: int) -> Tuple[torch.Tensor, ...]:
        """``(timesteps, sigma, sigma_next)`` for ``steps`` at an image of
        ``img_len`` tokens, on the device (copied once)."""
        key = (steps, img_len)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.from_numpy(t).to(self.device)
                for t in self.scheduler.tables(steps, image_seq_len=img_len))
        return self._tables[key]

    def ids(self, B: int, txt_len: int, h: int, w: int) -> torch.Tensor:
        key = (B, txt_len, h, w)
        if key not in self._ids:
            self._ids[key] = make_ids(B, txt_len, h, w, device=self.device)
        return self._ids[key]

    def latent_hw(self, height: int, width: int) -> Tuple[int, int]:
        f = self.vae_scale
        if height % (2 * f) or width % (2 * f):
            raise ValueError(f"height/width must be multiples of {2 * f}")
        return height // f, width // f

    def init_latents(self, rng: Seed, B: int, h: int, w: int
                     ) -> torch.Tensor:
        """``[B, h, w, C]`` standard normals from ``rng`` (a seed or a CPU
        ``torch.Generator``), drawn on the CPU, on the device."""
        gen = rng if isinstance(rng, torch.Generator) else \
            torch.Generator().manual_seed(int(rng))
        lat = torch.randn((B, h, w, self.latent_ch), generator=gen,
                          dtype=torch.float32)
        return lat.to(self.device)

    def step(self, tok, txt, pooled, t, sigma, sigma_next, guidance, ids):
        """One denoise step: the transformer's velocity at ``t`` (a
        timestep of [0, 1000)) and the Euler update, fp32."""
        B = tok.shape[0]
        tt = (t / 1000.0).reshape(1).expand(B)
        g = torch.full((B,), float(guidance), dtype=torch.float32,
                       device=tok.device)
        v = self.model(tok, txt, pooled, tt, g, ids)
        return self.scheduler.step(tok, v, sigma, sigma_next)

    def denoise(self, latents: torch.Tensor, txt: torch.Tensor,
                pooled: torch.Tensor, steps: int,
                guidance: float) -> torch.Tensor:
        """``latents [B, h, w, C]`` -> the denoised latents, given the
        conditioning ``txt [B, L, t5_dim]`` and ``pooled [B, clip_dim]``."""
        B, h, w, _ = latents.shape
        self.shape_keys.add((B, h, w, txt.shape[1]))
        ts, sig, sig_next = self.tables(steps, (h // 2) * (w // 2))
        ids = self.ids(B, txt.shape[1], h, w)
        with torch.inference_mode():
            tok = patchify(latents.to(self.device, torch.float32))
            for i in range(steps):
                tok = self.step(tok, txt, pooled, ts[i], sig[i], sig_next[i],
                                guidance, ids)
            return unpatchify(tok, h, w)

    def _ids_in(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids)).to(self.encoder_device,
                                                   torch.int64)

    def condition(self, t5_ids, clip_ids) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """``(txt, pooled)`` of the token ids, on the transformer's
        device; over a group the leader's, broadcast to every rank."""
        with torch.inference_mode():
            if self.leader:
                txt = self.t5_encode(self._ids_in(t5_ids)).to(self.device)
                pooled = self.clip_pooled(self._ids_in(clip_ids)).to(
                    self.device)
            if self.group is None:
                return txt, pooled
            if self.leader:
                txt, pooled = txt.float(), pooled.float()
            else:
                B, L = np.asarray(t5_ids).shape
                txt = torch.empty((B, L, self.cfg.t5_dim),
                                  dtype=torch.float32, device=self.device)
                pooled = torch.empty((B, self.cfg.clip_dim),
                                     dtype=torch.float32, device=self.device)
            return (self.group.broadcast_tensor(txt),
                    self.group.broadcast_tensor(pooled))

    def decode(self, lat: torch.Tensor) -> Optional[np.ndarray]:
        """uint8 ``[B, H, W, 3]`` of the latents (the leader's; None on a
        follower)."""
        if not self.leader:
            return None
        with torch.inference_mode():
            return self.vae.decode_uint8(
                lat.to(self.encoder_device)).cpu().numpy()

    def txt2img(self, t5_ids, clip_ids, *, rng: Seed = 0, height: int,
                width: int, steps: int = 28, guidance: float = 3.5,
                latents: torch.Tensor = None) -> Optional[np.ndarray]:
        """uint8 images ``[B, H, W, 3]`` from ``t5_ids [B, L]`` and
        ``clip_ids [B, 77]``; the initial latents drawn from ``rng``, or
        ``latents`` as given. A follower rank returns None."""
        h, w = self.latent_hw(height, width)
        if latents is None:
            latents = self.init_latents(rng, np.asarray(t5_ids).shape[0], h,
                                        w)
        txt, pooled = self.condition(t5_ids, clip_ids)
        return self.decode(self.denoise(latents, txt, pooled, steps,
                                        guidance))

    def warm(self, B: int, height: int, width: int, steps: int,
             t5_len: int, clip_len: int) -> None:
        """Run one ``(B, H, W)`` shape before readiness (cuDNN's algorithm
        choice, the allocator, the tables and ids): nothing is compiled
        here, so ``steps`` only sets the run's length."""
        self.txt2img(np.zeros((B, t5_len), np.int64),
                     np.zeros((B, clip_len), np.int64), rng=0,
                     height=height, width=width, steps=steps)
