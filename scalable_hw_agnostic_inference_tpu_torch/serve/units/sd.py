"""The Stable Diffusion txt2img unit (``sd`` and ``sd2``): ``POST
/genimage``.

Port of ``scalable_hw_agnostic_inference_tpu/serve/units/sd.py``
(``SDService``: ``load``, ``warmup``, ``infer``, the request coalescer,
``extra_stats``, ``_run_batch``). A request's prompt and negative prompt
are tokenized to the text encoder's length, the pipeline
(``models/sd.py``) denoises and decodes on the card, and the response is
the reference's: a base64 PNG with the steps and size.

- ``MODEL_ID=tiny`` (or empty): the tiny variant with seeded random
  weights drawn by torch (not flax's initializers, as the LLaVA tower's
  tiny tier); a CPU tier, since its heads are outside B1's sizes.
- ``MODEL_ID=<directory>``: a local diffusers directory (``unet/``,
  ``vae/``, ``text_encoder/``, ``tokenizer/``, ``scheduler/``; safetensors
  only). The UNet's weights go to the card in bf16; the VAE's stay fp32
  and compute in bf16; the text encoder is fp32. A hub id is refused
  (there is no download), and so is a UNet or text encoder whose heads
  B1 does not take on the card (SD1.x's 40, 80 and 160): the load fails
  naming the head size.
- Steps are a closed set (``NUM_INFERENCE_STEPS`` plus ``STEPS_BUCKETS``,
  the reference's contract); another value is a 400. Warmup runs each
  pow2 batch bucket once, ``WARM_STEPS`` steps long.
- ``SD_BATCH_MAX > 1`` coalesces concurrent requests of one (steps,
  guidance) into one batched denoise, in pow2 buckets; a
  request's image comes from its own seed's latents
  (``pipe.init_latents``), whatever batch it lands in.

The reference boots its executables from ``<artifact_root>/aot`` and
exports them (``export_artifacts``); the port has no artifact format yet
(ROADMAP A12): it does not read that directory, and logs so when it is
there.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from ...models import clip, sd, unet as unet_mod, vae as vae_mod
from ...models.encoder import seeded_init_
from ...models.tokenizer import ClipTokenizer
from ...ops.cuda.flash_attention import HEAD_DIMS
from ...utils.env import ServeConfig
from ..app import ModelService
from ..asgi import HTTPError
from .common import HashTokenizer, tokenize_to_length, unit_device

log = logging.getLogger(__name__)

#: the denoise steps of a warmup run
WARM_STEPS = 2


def check_head_dims(variant: sd.SDVariant, text: clip.ClipTextConfig,
                    device: torch.device) -> None:
    """On the card every attention runs on B1: refuse a model whose head
    size B1 does not take, naming it."""
    if device.type != "cuda":
        return
    sizes = set(variant.unet.head_dims()) | {text.dim // text.heads}
    bad = sorted(sizes - set(HEAD_DIMS))
    if bad:
        raise ValueError(
            f"attention heads of size {bad} in {variant.name!r}: on the "
            f"card attention runs only through the B1 kernel, which takes "
            f"head sizes {list(HEAD_DIMS)} (SD1.x's 40/80/160 wait for "
            f"B1 at those sizes; DEVICE=cpu runs the plain path)")


def load_checkpoint(root: str, device: torch.device):
    """``(variant, text encoder config, text encoder, UNet, VAE)`` from a
    local diffusers directory: the UNet in bf16, the VAE's weights fp32
    computing in bf16, the text encoder fp32."""
    variant = sd.variant_from_checkpoint(root)
    tcfg = json.loads((Path(root) / "text_encoder" / "config.json").read_text())
    ccfg = clip.ClipTextConfig.from_hf(tcfg)
    check_head_dims(variant, ccfg, device)

    def state(component, convert, cfg, dtype):
        ck = sd.load_torch_state(os.path.join(root, component))
        return convert(lambda n: ck.tensor(n, device).to(dtype), ck.keys(),
                       cfg)

    text = clip.build(ccfg, state("text_encoder", clip.state_from_hf, ccfg,
                                  torch.float32))
    unet = unet_mod.build(variant.unet, state(
        "unet", unet_mod.state_from_diffusers, variant.unet, torch.bfloat16))
    vae = vae_mod.build(variant.vae, state(
        "vae", vae_mod.state_from_diffusers, variant.vae, torch.float32))
    return variant, ccfg, text, unet, vae


class SDService(ModelService):
    """Text-to-image: the reference's ``run-sd.py``/``run-sd2.py`` (SD2.1
    at 512 x 512, DDIM, a base64 PNG response) on the port's pipeline."""

    task = "text-to-image"
    infer_route = "/genimage"

    def __init__(self, cfg: ServeConfig):
        super().__init__(cfg)
        # clamp to a power of two: warmup runs exactly the pow2 bucket
        # ladder and _run_batch rounds up, so a non-pow2 cap would let a
        # request land in a bucket warmup never ran
        raw = max(1, int(cfg.sd_batch_max))
        self._batch_max = 1 << (raw.bit_length() - 1)
        if self._batch_max != raw:
            log.warning("SD_BATCH_MAX=%d clamped to %d (pow2 buckets)",
                        raw, self._batch_max)
        self.concurrency = self._batch_max
        self._pend_lock = threading.Lock()
        self._pending: list = []   # (key, item, Future)
        self._tok_lock = threading.Lock()
        self._coalesce_window_s = 0.02     # ~2% of a 1 s denoise
        self._n_batches = 0
        self._n_coalesced = 0
        # recent batch sizes: the current utilization (a lifetime mean
        # converges and stops responding to overload)
        self._recent_batches: deque = deque(maxlen=32)

    def load(self) -> None:
        cfg = self.cfg
        device = unit_device(cfg)
        if cfg.model_id in ("", "tiny"):
            variant = sd.SDVariant.tiny()
            ccfg = clip.ClipTextConfig.tiny()
            check_head_dims(variant, ccfg, device)
            text = seeded_init_(clip.ClipTextEncoder(ccfg, device=device),
                                cfg.seed)
            unet = seeded_init_(unet_mod.UNet2DCondition(
                variant.unet, device=device), cfg.seed + 1)
            vae = seeded_init_(vae_mod.AutoencoderKL(
                variant.vae, device=device, encoder=False), cfg.seed + 2)
            self.tokenizer = HashTokenizer(ccfg.vocab_size, ccfg.max_position)
            self.height = self.width = variant.default_size
        else:
            root = sd.resolve_checkpoint_dir(cfg.model_id)
            variant, ccfg, text, unet, vae = load_checkpoint(root, device)
            self.tokenizer = ClipTokenizer.from_dir(
                os.path.join(root, "tokenizer"))
            self.height, self.width = cfg.height, cfg.width
        self.seq_len = ccfg.max_position
        self.text_model = text
        self.pipe = sd.StableDiffusion(variant, unet, vae,
                                       clip.encode_fn(text),
                                       scheduler=cfg.scheduler)
        self.variant = variant
        # steps is a closed set, as the reference's (where each value is
        # an executable compiled before readiness)
        self.steps_allowed = {cfg.num_inference_steps}
        if cfg.steps_buckets:
            self.steps_allowed |= {
                int(s) for s in cfg.steps_buckets.split(",") if s.strip()}
        aot_dir = os.path.join(cfg.artifact_root, "aot")
        if os.path.isdir(aot_dir):
            log.info("sd: %s holds AOT artifacts; the port has no artifact "
                     "format yet and does not read them", aot_dir)

    def _bucket_sizes(self) -> List[int]:
        b, out = 1, []
        while b <= self._batch_max:
            out.append(b)
            b *= 2
        return out

    def warmup(self) -> None:
        # nothing is compiled here and steps changes no shape: one short
        # run per pow2 bucket (batch 1 too, which a solo request takes)
        # settles cuDNN's algorithm choice and the allocator; the tables
        # of every allowed steps value go to the device
        for steps in self.steps_allowed:
            self.pipe.tables(steps)
        for b in self._bucket_sizes():
            self.pipe.warm(b, self.height, self.width, WARM_STEPS,
                           self.seq_len)

    def _tokenize(self, text: str) -> np.ndarray:
        with self._tok_lock:
            return tokenize_to_length(self.tokenizer, text, self.seq_len)

    def example_payload(self) -> Dict[str, Any]:
        return {"prompt": "a photo of an astronaut riding a horse",
                "steps": None}

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.cfg
        prompt = str(payload.get("prompt", payload.get("text", "")))
        steps_raw = payload.get("steps")
        steps = cfg.num_inference_steps if steps_raw is None \
            else int(steps_raw)
        if steps not in self.steps_allowed:
            raise HTTPError(
                400,
                f"steps={steps} not in this deployment's compiled set "
                f"{sorted(self.steps_allowed)} (extend via STEPS_BUCKETS)")
        guidance = float(payload.get("guidance_scale", cfg.guidance_scale))
        seed = int(payload.get("seed", 0))
        ids = self._tokenize(prompt)
        uncond = self._tokenize(str(payload.get("negative_prompt", "")))
        item = {"ids": ids, "uncond": uncond, "seed": seed}
        if self._batch_max > 1:
            img = self._coalesced(item, steps, guidance)
        else:
            img = self.pipe.txt2img(
                ids, uncond, rng=seed, height=self.height, width=self.width,
                steps=steps, guidance_scale=guidance)[0]
        return {"image_b64": sd.to_png_base64(img), "steps": steps,
                "height": self.height, "width": self.width}

    # -- request coalescing (SD_BATCH_MAX > 1) ----------------------------

    def _coalesced(self, item: Dict[str, Any], steps: int,
                   guidance: float) -> np.ndarray:
        """Wait one window for arrivals of the same (steps, guidance);
        the first thread to wake leads: it takes every matching pending
        entry (up to the cap) and runs them as one batched denoise, and
        the followers it took wait on their futures."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        key = (steps, guidance)
        entry = (key, item, fut)
        with self._pend_lock:
            self._pending.append(entry)
        time.sleep(self._coalesce_window_s)
        with self._pend_lock:
            # identity checks only: entries hold numpy arrays, whose
            # __eq__ is elementwise (`entry in list` would raise)
            if any(e is entry for e in self._pending):  # not taken: lead
                # the leader always takes its own entry: a batch cut by
                # arrival order alone could leave it out, stranding its
                # future with no thread to run it
                others = [e for e in self._pending
                          if e[0] == key and e is not entry]
                batch = [entry] + others[: self._batch_max - 1]
                taken = {id(e) for e in batch}
                self._pending = [e for e in self._pending
                                 if id(e) not in taken]
            else:
                batch = []
        if batch:
            try:
                imgs = self._run_batch([e[1] for e in batch], steps,
                                       guidance)
                for e, img in zip(batch, imgs):
                    e[2].set_result(img)
            except BaseException as exc:
                for e in batch:
                    if not e[2].done():
                        e[2].set_exception(exc)
        return fut.result(timeout=1800)

    def extra_stats(self) -> Dict[str, float]:
        if self._batch_max == 1:
            return {}
        with self._pend_lock:
            waiting = len(self._pending)
            n_b, n_r = self._n_batches, self._n_coalesced
            recent = list(self._recent_batches)
        return {
            "coalesce_batch_max": float(self._batch_max),
            "coalesce_waiting": float(waiting),
            "coalesced_batches": float(n_b),
            "coalesced_requests": float(n_r),
            "coalesce_occupancy_lifetime": round(n_r / n_b, 3) if n_b
            else 0.0,
            "coalesce_occupancy": (round(sum(recent) / len(recent), 3)
                                   if recent else 0.0),
        }

    def _run_batch(self, items, steps: int, guidance: float) -> np.ndarray:
        f = self.pipe.vae_scale
        h, w = self.height // f, self.width // f
        n = len(items)
        b = 1
        while b < n:
            b *= 2
        padded = items + [items[-1]] * (b - n)   # pad rows are discarded
        ids = np.stack([np.asarray(i["ids"][0]) for i in padded])
        unc = np.stack([np.asarray(i["uncond"][0]) for i in padded])
        lat = torch.cat([self.pipe.init_latents(i["seed"], h, w, steps)
                         for i in padded])
        imgs = self.pipe.txt2img_batch(
            ids, unc, lat, height=self.height, width=self.width,
            steps=steps, guidance_scale=guidance)
        with self._pend_lock:
            self._n_batches += 1
            self._n_coalesced += n
            self._recent_batches.append(n)
        if n > 1:
            log.info("sd coalesced %d requests into one batch-%d denoise",
                     n, b)
        return imgs[:n]
