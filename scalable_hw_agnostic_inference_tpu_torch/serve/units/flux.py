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
- ``SUBMESH=a:b`` packs the unit as the reference does: the transformer
  over cards ``a`` to ``b - 1`` (the repo's manifest sets ``2:8``), one
  tensor-parallel rank a card, each a process of its own
  (``serve.multihost``), and T5, CLIP and the VAE on the leader alone, on
  the first card outside the slice (the reference's ``rest[0]``; the
  first card when the slice takes every one). Unset, the transformer
  spans every local card, as the reference's does: one card is one
  device and no group, as before. ``SUBMESH`` naming one device places
  the transformer on it. Over two gloo ranks sharing one card (the
  card's tests) both ranks and the encoders share it. The leader
  encodes the prompt and broadcasts the conditioning; every rank runs
  every step; the leader decodes and answers (``models/flux_pipeline``).
  Every call that reaches the device (``infer``, ``warmup``) is
  mirrored; a bad knob or a ``steps`` value outside the set is a 400 on
  every rank before any device work. ``SHAI_COORDINATOR`` with
  ``SHAI_NUM_PROCESSES=1`` is a group of one through the env path;
  several hosts are refused, as the reference refuses a unit without
  ``supports_multihost``. At ``load()`` each rank refuses a tp that does
  not divide the heads (24 for FLUX.1) or the MLP width, prices its load
  (``core.budget.rank_budget``: its shard of the transformer, and on the
  leader the encoders and VAE where they share its card, with the
  activations of the unit's image) on the card (or under
  ``SHAI_ENFORCE_HBM=1``) before any weight is read, then reads the
  transformer on the CPU one entry at a time (a diffusers snapshot's
  fused entries made from their parts) and places only its slice
  (``parallel.sharding.stream_shard``). ``MESH_SPEC`` over several
  devices is refused: the reference's ``flux`` reads ``SUBMESH``.
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
from typing import Any, Dict, Optional

import torch

from ...core.budget import (
    HbmBudget,
    detect_hbm_gib,
    module_shapes,
    rank_budget,
)
from ...core.checkpoint import Checkpoint
from ...models import clip, flux, sd, t5, vae as vae_mod
from ...models.encoder import seeded_init_
from ...models.flow_match import FlowMatchConfig
from ...models.flux_pipeline import FluxPipeline
from ...models.tokenizer import ClipTokenizer, UnigramTokenizer
from ...ops.cuda.flash_attention import HEAD_DIMS
from ...parallel.sharding import stream_shard
from ...utils.env import env_bool
from ..app import ModelService
from ..asgi import HTTPError
from .common import (
    HashTokenizer,
    rest_device,
    tokenize_to_length,
    unit_layout,
    unit_ranks,
)

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


def _params_bytes(module: torch.nn.Module, dtype: torch.dtype) -> float:
    return float(sum(p.numel() for p in module.parameters())
                 * dtype.itemsize)


def flux_act_bytes(fcfg: flux.FluxConfig, tokens: int, tp: int,
                   dtype_bytes: float) -> float:
    """An estimate of one rank's peak activations in one step over
    ``tokens`` joint tokens: the replicated streams, their norms and
    modulated copies (6 widths), the rank's q, k, v, attention output
    and MLP slice, 1.5x for temporaries (B1 keeps the scores out of
    memory)."""
    h, m = fcfg.hidden, fcfg.mlp_ratio * fcfg.hidden
    return 1.5 * tokens * (6 * h + (4 * h + m) // tp) * dtype_bytes


def vae_act_bytes(vcfg: vae_mod.VAEConfig, height: int, width: int) -> float:
    """``core.budget.diffusion_budget``'s estimate of the VAE decode's
    upsampled feature maps (bf16 compute), 1.5x margin."""
    f = 2 ** (len(vcfg.block_out) - 1)
    elems = 0
    for i, ch in enumerate(reversed(vcfg.block_out)):
        s = f >> i if f >> i else 1
        elems += (height // s) * (width // s) * ch
    return 1.5 * elems * 6 * 2.0


def load_encoders(root: str, device: torch.device):
    """``(T5, CLIP, VAE)`` of a local FLUX.1 directory on ``device``: T5
    in bf16, CLIP in fp32, the VAE's weights in fp32."""

    def read(ck, dtype):
        return lambda n: ck.tensor(n, device).to(dtype)

    tcfg = t5.T5Config.from_hf(_config(root, "text_encoder_2"))
    ck = sd.load_torch_state(os.path.join(root, "text_encoder_2"))
    t5m = t5.build(tcfg, t5.state_from_hf(read(ck, torch.bfloat16),
                                          ck.keys(), tcfg),
                   dtype=torch.bfloat16)
    ccfg = clip.ClipTextConfig.from_hf(_config(root, "text_encoder"))
    ck = sd.load_torch_state(os.path.join(root, "text_encoder"))
    clipm = clip.build(ccfg, clip.state_from_hf(read(ck, torch.float32),
                                                ck.keys(), ccfg))
    vcfg = vae_mod.VAEConfig.from_hf(_config(root, "vae"))
    ck = sd.load_torch_state(os.path.join(root, "vae"))
    vae = vae_mod.build(vcfg, vae_mod.state_from_diffusers(
        read(ck, torch.float32), ck.keys(), vcfg))
    return t5m, clipm, vae


class FluxService(ModelService):
    """Text-to-image: the reference's ``flux_model_api.py`` (FLUX.1 at
    the configured size, a base64 PNG response) on the port's pipeline,
    its transformer over the ``SUBMESH`` ranks (module note)."""

    task = "text-to-image"
    infer_route = "/genimage"
    #: the transformer's tp ranks of one host, laid out by ``SUBMESH``
    ranks_over = "SUBMESH"
    #: every entry that reaches the device
    mirror_methods = ("infer", "warmup")

    def __init__(self, cfg):
        super().__init__(cfg)
        #: the rank's priced load, where the gate ran (on the card, or
        #: under ``SHAI_ENFORCE_HBM=1``)
        self.hbm_budget: Optional[HbmBudget] = None

    def check_layout(self, tp: int) -> None:
        """Refuse a tp the transformer cannot split (``serve.multihost``
        asks before it starts a rank): its config is the tiny tier's, or
        read off the checkpoint's tensor headers."""
        if self.cfg.model_id in ("", "tiny"):
            fcfg = flux.FluxConfig.tiny()
        else:
            fcfg = config_from_checkpoint(transformer_checkpoint(
                sd.resolve_checkpoint_dir(self.cfg.model_id,
                                          "flux1-*.safetensors or "
                                          "transformer/")))
        flux.check_tp(fcfg, tp)

    def _price(self, fcfg, tcfg, ccfg, vcfg, tp: int, dtype: torch.dtype,
               device: torch.device, shares: bool) -> None:
        """The rank's load priced before any weight is read: its shard of
        the transformer, and, on a leader whose encoders share its card,
        T5, CLIP and the VAE whole, beside the activations of one image
        (and of its decode, where the VAE shares the card)."""
        if not (device.type == "cuda"
                or env_bool("SHAI_ENFORCE_HBM", False)):
            return
        tokens = self.t5_len + (self.height // 16) * (self.width // 16)
        act = flux_act_bytes(fcfg, tokens, tp, dtype.itemsize)
        extra = 0.0
        if shares:
            extra = (_params_bytes(t5.T5Encoder(tcfg, device="meta"),
                                   dtype)
                     + _params_bytes(clip.ClipTextEncoder(ccfg,
                                                          device="meta"),
                                     torch.float32)
                     + _params_bytes(vae_mod.AutoencoderKL(
                         vcfg, device="meta", encoder=False), torch.float32))
            act = max(act, vae_act_bytes(vcfg, self.height, self.width))
        self.hbm_budget = rank_budget(
            module_shapes(flux.FluxTransformer(fcfg, dtype=dtype,
                                               device="meta")),
            flux.tp_rules(fcfg), tp, what=repr(self.cfg.model_id or "tiny"),
            dtype=str(dtype).split(".")[-1], act_bytes=act,
            hbm_gib_per_chip=detect_hbm_gib(device),
            extra_params_bytes=extra).check()

    def load(self) -> None:
        cfg = self.cfg
        device, group = unit_ranks(cfg, group=self.group,
                                   ranks_over=self.ranks_over)
        tp, rank = (group.size, group.rank) if group else (1, 0)
        leader = rank == 0
        devices = (unit_layout(cfg, backend=group.backend,
                               ranks_over=self.ranks_over)[1].devices
                   if group else (device,))
        enc_dev = rest_device(devices)
        # a rank of several reads the whole transformer on the CPU, one
        # entry at a time, and places only its slice on its device
        source = device if tp == 1 else torch.device("cpu")
        tiny = cfg.model_id in ("", "tiny")
        if tiny:
            fcfg = flux.FluxConfig.tiny()
            tcfg, ccfg = t5.T5Config.tiny(), clip.ClipTextConfig.tiny()
            vcfg, dtype = vae_mod.VAEConfig.tiny(), torch.float32
            self.t5_tok = HashTokenizer(tcfg.vocab_size, 16)
            self.clip_tok = HashTokenizer(ccfg.vocab_size, ccfg.max_position)
            self.t5_len = 16
            self.height = self.width = TINY_SIZE
        else:
            root = sd.resolve_checkpoint_dir(
                cfg.model_id, "flux1-*.safetensors or transformer/, "
                "text_encoder/, text_encoder_2/, vae/, tokenizer/, "
                "tokenizer_2/")
            tck = transformer_checkpoint(root)
            fcfg = config_from_checkpoint(tck)
            tcfg = t5.T5Config.from_hf(_config(root, "text_encoder_2"))
            ccfg = clip.ClipTextConfig.from_hf(_config(root, "text_encoder"))
            vcfg, dtype = (vae_mod.VAEConfig.from_hf(_config(root, "vae")),
                           torch.bfloat16)
            self.t5_tok = UnigramTokenizer.from_dir(
                os.path.join(root, "tokenizer_2"))
            self.clip_tok = ClipTokenizer.from_dir(
                os.path.join(root, "tokenizer"))
            self.t5_len = T5_LEN_DEV if fcfg.guidance_embed \
                else T5_LEN_SCHNELL
            self.height, self.width = cfg.height, cfg.width
        check_head_dims(fcfg, ccfg, device)
        flux.check_tp(fcfg, tp)
        self._price(fcfg, tcfg, ccfg, vcfg, tp, dtype, device,
                    leader and enc_dev == device)
        if tiny:
            items = flux.seeded(fcfg, cfg.seed + 2, dtype=dtype,
                                device=source).state_dict().items()
            schedule = FlowMatchConfig()
        else:
            items = flux.state_items(
                lambda n: tck.tensor(n, source).to(dtype), fcfg, tck.keys())
            schedule = schedule_for(root, fcfg)
        model = flux.build(fcfg, stream_shard(items, flux.tp_rules(fcfg), tp,
                                              rank, device),
                           dtype=dtype, group=group)
        t5_fn = clip_fn = vae = None
        if leader and tiny:
            t5m = seeded_init_(t5.T5Encoder(tcfg, device=enc_dev), cfg.seed)
            clipm = seeded_init_(clip.ClipTextEncoder(ccfg, device=enc_dev),
                                 cfg.seed + 1)
            vae = seeded_init_(vae_mod.AutoencoderKL(
                vcfg, device=enc_dev, encoder=False), cfg.seed + 3)
        elif leader:
            t5m, clipm, vae = load_encoders(root, enc_dev)
        if leader:
            t5_fn, clip_fn = t5.encode_fn(t5m), clip.pooled_fn(clipm)
        self.clip_len = ccfg.max_position
        self.pipe = FluxPipeline(model, vae, t5_fn, clip_fn,
                                 schedule=schedule, group=group,
                                 encoder_device=enc_dev,
                                 vae_scale=2 ** (len(vcfg.block_out) - 1))
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
        """One image; every knob is checked first, so a bad one is the
        same 400 on every rank before any device work. A follower rank
        returns ``{}`` (the leader answers)."""
        prompt = str(payload.get("prompt", ""))
        steps_raw = payload.get("steps")
        try:
            steps = (self.cfg.num_inference_steps if steps_raw is None
                     else int(steps_raw))
            guidance = float(payload.get("guidance_scale", payload.get(
                "guidance", self.cfg.guidance_scale)))
            seed = int(payload.get("seed", 0))
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad knob: {e}") from None
        if steps not in self.steps_allowed:
            raise HTTPError(
                400,
                f"steps={steps} not in this deployment's compiled set "
                f"{sorted(self.steps_allowed)} (extend via STEPS_BUCKETS)")
        images = self.pipe.txt2img(
            tokenize_to_length(self.t5_tok, prompt, self.t5_len),
            tokenize_to_length(self.clip_tok, prompt, self.clip_len),
            rng=seed, height=self.height, width=self.width, steps=steps,
            guidance=guidance)
        if images is None:
            return {}
        return {"image_b64": sd.to_png_base64(images[0]), "steps": steps,
                "height": self.height, "width": self.width}

    def recompiles(self) -> int:
        """Shapes first run after warmup: the eager pipeline's counterpart
        of the reference's executables compiled at request time."""
        return len(self.pipe.shape_keys - self.warmed_keys)
