"""The Flux text-to-image unit (``flux``): ``POST /genimage``.

Port of ``scalable_hw_agnostic_inference_tpu/serve/units/flux.py``
(``FluxService``: ``load``, ``warmup``, ``infer``). A request's prompt is
tokenized for T5 and for CLIP, the pipeline (``models/flux_pipeline.py``)
denoises and decodes on the card, and the response is the reference's: a
base64 PNG with the steps and size.

- ``MODEL_ID=tiny`` (or empty): the tiny Flux, T5, CLIP and VAE with
  seeded random weights drawn by torch (not flax's initializers), hashed
  tokens, 32 x 32 px; a CPU tier: its heads of 16 are outside B1's sizes,
  so ``load()`` refuses it on the card, naming the head size.
- ``MODEL_ID=<directory>``: a local FLUX.1 snapshot (safetensors only):
  the transformer from the BFL single file ``flux1-*.safetensors`` at the
  root, or else diffusers' ``transformer/`` shards; its widths and depth
  read off the tensors, schnell told apart by the absence of the guidance
  embedder; ``text_encoder_2/`` (T5), ``text_encoder/`` (CLIP-L, pooled
  after its final LayerNorm), ``vae/``, ``scheduler/scheduler_config.json``
  (else the reference's defaults: schnell a static shift of 1, dev the
  dynamic shift), ``tokenizer_2/`` (a Unigram ``tokenizer.json``) and
  ``tokenizer/`` (CLIP's). The transformer and T5 go to the card in bf16,
  CLIP in fp32, the VAE's weights fp32 computing in bf16. T5 reads 512
  tokens for dev and 256 for schnell. A hub id is refused (there is no
  download).
- ``SUBMESH`` or ``MESH_SPEC`` naming one device places the unit on it;
  naming more is tensor parallelism (ROADMAP A7.3b): ``load()`` refuses it.
- Steps are a closed set (``NUM_INFERENCE_STEPS`` plus ``STEPS_BUCKETS``,
  the reference's contract); another value is a 400. Warmup runs the one
  image shape once, ``WARM_STEPS`` steps long, and puts every allowed
  steps value's tables on the device: nothing is compiled, and steps
  changes no shape.
"""

from __future__ import annotations

import glob
import json
import os
from pathlib import Path
from typing import Any, Dict

import torch

from ...core.checkpoint import Checkpoint
from ...models import clip, flux, sd, t5, vae as vae_mod
from ...models.encoder import seeded_init_
from ...models.flow_match import FlowMatchConfig
from ...models.flux_pipeline import FluxPipeline
from ...models.tokenizer import ClipTokenizer, UnigramTokenizer
from ...ops.cuda.flash_attention import HEAD_DIMS
from ..app import ModelService
from ..asgi import HTTPError
from .common import HashTokenizer, tokenize_to_length, unit_device

#: the denoise steps of the warmup run
WARM_STEPS = 1
#: the tiny tier's image side (VAE scale 2 x patch 2 x 8 latent tokens)
TINY_SIZE = 32
#: T5 tokens a prompt takes: FLUX.1-dev's max_sequence_length, schnell's
T5_LEN_DEV, T5_LEN_SCHNELL = 512, 256


def check_head_dims(fcfg: flux.FluxConfig, ccfg: clip.ClipTextConfig,
                    device: torch.device) -> None:
    """On the card every transformer and CLIP attention runs on B1:
    refuse a model whose head size B1 does not take, naming it."""
    if device.type != "cuda":
        return
    bad = sorted({fcfg.head_dim, ccfg.dim // ccfg.heads} - set(HEAD_DIMS))
    if bad:
        raise ValueError(
            f"attention heads of size {bad}: on the card attention runs "
            f"only through the B1 kernel, which takes head sizes "
            f"{list(HEAD_DIMS)} (the tiny tier is a CPU tier: DEVICE=cpu)")


def transformer_checkpoint(root: str) -> Checkpoint:
    """The BFL single file at the root, or else the diffusers
    ``transformer/`` directory."""
    single = sorted(glob.glob(os.path.join(root, "flux1-*.safetensors")))
    if single:
        return Checkpoint(single[0])
    tdir = os.path.join(root, "transformer")
    if not os.path.isdir(tdir):
        raise FileNotFoundError(f"no flux1-*.safetensors and no "
                                f"transformer/ weights under {root}")
    return Checkpoint(tdir)


def config_from_checkpoint(ck: Checkpoint) -> flux.FluxConfig:
    """The transformer's geometry read off its tensors: widths from the
    embedders' shapes, the depth from the blocks present, the guidance
    embedder's presence (schnell has none)."""
    keys = set(ck.keys())
    if flux.is_diffusers_layout(keys):
        img_in, txt_in, vec_in = ("x_embedder", "context_embedder",
                                  "time_text_embed.text_embedder.linear_1")
        qk = "transformer_blocks.0.attn.norm_q.weight"
        double = "transformer_blocks.{}.norm1.linear.weight"
        single = "single_transformer_blocks.{}.norm.linear.weight"
    else:
        img_in, txt_in, vec_in = "img_in", "txt_in", "vector_in.in_layer"
        qk = "double_blocks.0.img_attn.norm.query_norm.scale"
        double = "double_blocks.{}.img_mod.lin.weight"
        single = "single_blocks.{}.modulation.lin.weight"

    def count(pattern):
        n = 0
        while pattern.format(n) in keys:
            n += 1
        return n

    hidden, in_ch = ck.shape(img_in + ".weight")
    head_dim = ck.shape(qk)[0]
    axes = {flux.FluxConfig().head_dim: flux.FluxConfig().axes_dim,
            flux.FluxConfig.tiny().head_dim: flux.FluxConfig.tiny().axes_dim}
    if head_dim not in axes:
        raise ValueError(f"Flux checkpoint: heads of {head_dim}: no RoPE "
                         f"axis split known for it")
    return flux.config_for_keys(keys, flux.FluxConfig(
        in_channels=in_ch, hidden=hidden, heads=hidden // head_dim,
        n_double=count(double), n_single=count(single),
        t5_dim=ck.shape(txt_in + ".weight")[1],
        clip_dim=ck.shape(vec_in + ".weight")[1], axes_dim=axes[head_dim]))


def schedule_for(root: str, fcfg: flux.FluxConfig) -> FlowMatchConfig:
    """The checkpoint's scheduler config when it has one; otherwise schnell
    a static shift of 1, dev the reference's dynamic-shift defaults."""
    path = os.path.join(root, "scheduler", "scheduler_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return FlowMatchConfig.from_scheduler_config(json.load(f))
    if fcfg.guidance_embed:
        return FlowMatchConfig()
    return FlowMatchConfig(use_dynamic_shifting=False, shift=1.0)


def _config(root: str, component: str) -> Dict[str, Any]:
    return json.loads(Path(root, component, "config.json").read_text())


def load_checkpoint(root: str, device: torch.device):
    """``(transformer, T5, CLIP, VAE, schedule)`` from a local FLUX.1
    directory."""

    def read(ck, dtype):
        return lambda n: ck.tensor(n, device).to(dtype)

    tck = transformer_checkpoint(root)
    fcfg = config_from_checkpoint(tck)
    ccfg = clip.ClipTextConfig.from_hf(_config(root, "text_encoder"))
    check_head_dims(fcfg, ccfg, device)
    model = flux.build(fcfg, flux.state_from_bfl(
        read(tck, torch.bfloat16), fcfg, tck.keys()), dtype=torch.bfloat16)
    t5dir = os.path.join(root, "text_encoder_2")
    tcfg = t5.T5Config.from_hf(_config(root, "text_encoder_2"))
    ck = sd.load_torch_state(t5dir)
    t5m = t5.build(tcfg, t5.state_from_hf(read(ck, torch.bfloat16),
                                          ck.keys(), tcfg),
                   dtype=torch.bfloat16)
    ck = sd.load_torch_state(os.path.join(root, "text_encoder"))
    clipm = clip.build(ccfg, clip.state_from_hf(read(ck, torch.float32),
                                                ck.keys(), ccfg))
    vcfg = vae_mod.VAEConfig.from_hf(_config(root, "vae"))
    ck = sd.load_torch_state(os.path.join(root, "vae"))
    vae = vae_mod.build(vcfg, vae_mod.state_from_diffusers(
        read(ck, torch.float32), ck.keys(), vcfg))
    return model, t5m, clipm, vae, schedule_for(root, fcfg)


class FluxService(ModelService):
    """Text-to-image: the reference's ``flux_model_api.py`` (FLUX.1 at
    the configured size, a base64 PNG response) on the port's pipeline."""

    task = "text-to-image"
    infer_route = "/genimage"

    def load(self) -> None:
        cfg = self.cfg
        device = unit_device(cfg)
        if cfg.model_id in ("", "tiny"):
            fcfg = flux.FluxConfig.tiny()
            tcfg, ccfg = t5.T5Config.tiny(), clip.ClipTextConfig.tiny()
            check_head_dims(fcfg, ccfg, device)
            t5m = seeded_init_(t5.T5Encoder(tcfg, device=device), cfg.seed)
            clipm = seeded_init_(clip.ClipTextEncoder(ccfg, device=device),
                                 cfg.seed + 1)
            model = flux.seeded(fcfg, cfg.seed + 2, dtype=torch.float32,
                                device=device)
            vae = seeded_init_(vae_mod.AutoencoderKL(
                vae_mod.VAEConfig.tiny(), device=device, encoder=False),
                cfg.seed + 3)
            schedule = FlowMatchConfig()
            self.t5_tok = HashTokenizer(tcfg.vocab_size, 16)
            self.clip_tok = HashTokenizer(ccfg.vocab_size, ccfg.max_position)
            self.t5_len = 16
            self.height = self.width = TINY_SIZE
        else:
            root = sd.resolve_checkpoint_dir(
                cfg.model_id, "flux1-*.safetensors or transformer/, "
                "text_encoder/, text_encoder_2/, vae/, tokenizer/, "
                "tokenizer_2/")
            model, t5m, clipm, vae, schedule = load_checkpoint(root, device)
            fcfg, ccfg = model.cfg, clipm.cfg
            self.t5_tok = UnigramTokenizer.from_dir(
                os.path.join(root, "tokenizer_2"))
            self.clip_tok = ClipTokenizer.from_dir(
                os.path.join(root, "tokenizer"))
            self.t5_len = T5_LEN_DEV if fcfg.guidance_embed \
                else T5_LEN_SCHNELL
            self.height, self.width = cfg.height, cfg.width
        self.clip_len = ccfg.max_position
        self.pipe = FluxPipeline(model, vae, t5.encode_fn(t5m),
                                 clip.pooled_fn(clipm), schedule=schedule)
        self.steps_allowed = {cfg.num_inference_steps}
        if cfg.steps_buckets:
            self.steps_allowed |= {
                int(s) for s in cfg.steps_buckets.split(",") if s.strip()}
        self.pipe.latent_hw(self.height, self.width)
        #: the shapes warmup ran (``pipe.shape_keys`` after it)
        self.warmed_keys = frozenset()

    def warmup(self) -> None:
        h, w = self.pipe.latent_hw(self.height, self.width)
        for steps in self.steps_allowed:
            self.pipe.tables(steps, (h // 2) * (w // 2))
        self.pipe.warm(1, self.height, self.width, WARM_STEPS, self.t5_len,
                       self.clip_len)
        self.warmed_keys = frozenset(self.pipe.shape_keys)

    def example_payload(self) -> Dict[str, Any]:
        return {"prompt": "a watercolor fox", "steps": None}

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        prompt = str(payload.get("prompt", ""))
        steps_raw = payload.get("steps")
        steps = (self.cfg.num_inference_steps if steps_raw is None
                 else int(steps_raw))
        if steps not in self.steps_allowed:
            raise HTTPError(
                400,
                f"steps={steps} not in this deployment's compiled set "
                f"{sorted(self.steps_allowed)} (extend via STEPS_BUCKETS)")
        guidance = float(payload.get("guidance_scale",
                                     payload.get("guidance",
                                                 self.cfg.guidance_scale)))
        seed = int(payload.get("seed", 0))
        img = self.pipe.txt2img(
            tokenize_to_length(self.t5_tok, prompt, self.t5_len),
            tokenize_to_length(self.clip_tok, prompt, self.clip_len),
            rng=seed, height=self.height, width=self.width, steps=steps,
            guidance=guidance)[0]
        return {"image_b64": sd.to_png_base64(img), "steps": steps,
                "height": self.height, "width": self.width}

    def recompiles(self) -> int:
        """Shapes first run after warmup: the eager pipeline's counterpart
        of the reference's executables compiled at request time."""
        return len(self.pipe.shape_keys - self.warmed_keys)
