"""Engine-backed text generation unit: paged continuous batching behind
``POST /generate`` and the OpenAI routes.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/serve/units/vllm.py``
(``VllmService``: ``_resolve_ecfg``, ``load`` with the closed set warmed
before the loop starts, ``infer``, ``_collect``, ``_deadline_at``,
``_qos_kw``, ``_result_timeout``, ``extra_stats`` (with the engine's
``SpecStats`` under speculative decoding), ``spec_counters``, and the
OpenAI surface
``:986-1351``: ``/v1/completions``, ``/v1/chat/completions`` and
``/v1/models``, ``stream: true`` as server-sent events, ``n`` parallel
samples, ``logprobs`` through ``_format_logprobs``). ``load`` serves the
``tiny`` tier (seeded random weights, the small engine shapes of the
reference's ``:177-196``; CPU only, its head_dim of 16 is not one the CUDA
kernels take), the ``*-geometry`` tiers (full-size architecture, zero
weights, real engine shapes) and a local Llama checkpoint directory
(``MODEL_ID=<dir>`` holding ``config.json``, ``*.safetensors`` and
``tokenizer.json``: the reference's ``from_pretrained`` of a local path,
``causal_lm.py:252-290``, read by ``models.convert`` and tokenized by
``models.tokenizer.BpeTokenizer``); a ``weights`` callable given to the
constructor replaces the tier's weights (the tests hand the port the JAX
service's). ``QUANTIZATION=int8`` (or the ConfigMap's ``quantization``)
quantizes the weights at boot, after the bf16 cast, as the reference does
(``:199-204``); a geometry tier is born int8. The tiers tokenize with the
byte-level ``ByteTokenizer``. A chat prompt is the reference's plain
``role: content`` layout; a checkpoint whose ``tokenizer_config.json``
carries a ``chat_template`` answers the chat route with 501 (templates are
not ported: formatting another prompt than the reference's would be a
quiet change). ``n > 1`` is
one fan-out group (``EngineLoop.submit_group``: one tokenization, one
queue item; one prefill with copy-on-write forks under ``SHAI_KV_COW``),
and not streamed. The operating layer's unit half (``:22,307-345``): the
step watchdog behind ``liveness_error`` (built after ``EngineLoop.start``,
so load, warmup and graph capture never trip it; it reads the engine's
last RETIRED step), ``drain`` through ``EngineLoop.drain``, the request
trace (``tokenize`` and ``detokenize`` spans, the engine's queue, prefill
and decode phases grafted under ``model_infer``, ``engine_req_id`` on the
root) and the idempotency key and ``traceparent`` passed to the engine.

Disaggregated serving (the reference's ``:68-83,282-305,486-657,840-854``,
``_require_decode_role`` at ``:1273``): the role is ``SHAI_ROLE`` over the
ConfigMap's ``role``. A ``prefill`` pod's ``/generate`` runs the prompt
(one discarded greedy token), lets the engine bank the prompt's full-block
run in its host tier, and returns the handoff ``{kv_ready, digest,
hashes_len, peer_url, n_prompt, role}`` (``_prefill_handoff``); its
OpenAI routes answer 400. A request carrying ``kv_peer`` (with
``kv_hashes_len`` and ``kv_digest``) first pulls that run from the peer's
``GET /kv/blocks`` into the local tier (``_pull_handoff``: skipped when
the digest is not this prompt's, bounded by the request's deadline; every
failure degrades to recompute), then admits as usual, restoring the run.
With the prefix cache on, every served ``/generate`` prompt's affinity
digest is advertised on ``/stats``. The drain closes the tier's copy-out
worker and holds ``/kv/blocks`` open while a prefill pod's tier banks
runs.

The fleet KV fabric and live migration (the reference's ``:289-305,
350-410,474-477,544-556,659-854``): one ``MigrateClient`` (the fetch
side's transport plus the ship) serves the pulls and the drain's ships,
and a bounded ``MigrationInbox`` banks accepted manifests. On a
fabric-armed engine, ``affinity_heads`` maps each served prompt's
affinity digest to its chain head (``/stats`` -> ``kvtier.aff_heads``),
``fabric_pull`` backs ``POST /kv/pull``, and ``/generate`` passes the
request's ``kv_holders`` (at most 4) to the engine's probe. The drain's
migrate phase (``wants_migration``, ``migrate_inflight``) has the loop
finish every live request as ``migrated``; each waiter then ships its
manifest and banked run (``_migrated_handoff``, after the tier's copy-out
drained) and answers ``{"migrated": true, "peer", "resume", ...}``, a 503
with ``x-shai-migrate-peer`` on the OpenAI routes, or an in-band
``migrated`` record on a stream. A peer's ``POST /kv/migrate`` lands in
``accept_migration`` (429 while ``migrate_busy``), and ``{"resume":
<handle>}`` on ``/generate`` (``_resume_migrated``) re-admits the
manifest once and returns the whole output. The drain also holds
``/kv/blocks`` open while a shipped run is still to be pulled
(``_pending_pull``). Chat templates come in a later slice.

mllama (the reference's ``:234,266-271,505-524``): a checkpoint directory
whose ``config.json`` names ``model_type: "mllama"`` boots the text tower
with its cross layers, the tiled vision encoder and the projector
(``models.convert.load_mllama_checkpoint``, ``models.mllama``) and an
engine with ``cross_seq_len = max_num_tiles x (patches + 1)``; the vision
front-end encodes one image before readiness, beside the engine's warmup.
A ``/generate`` carrying ``image_b64`` (base64 PNG or JPEG bytes, or
``"random"``: the reference's seeded 560 x 560 image) is decoded without
PIL (``models.imageio``, ``models.jpeg``), tiled, encoded into
``(cross_states, n_tiles x (patches + 1))`` and submitted with the prompt.
A text-only request through an mllama pod is served with its cross layers
gated off.

The soft-prefix VLM (the reference's ``:150-165,242-279,525-542``): a
checkpoint directory whose ``config.json`` names ``model_type: "llava"``
boots the language model, the CLIP tower and the projector
(``models.convert.load_llava_checkpoint``, ``models.vlm``; bf16 on the
device) and the engine; the ``tiny`` tier always carries a seeded tiny
tower (fp32, on the CPU; a ``weights`` callable hands it the caller's
under ``vision.`` names), as the reference's does. The tower runs once on
zeros before readiness, and the warmed set holds the soft-prefix prefill
(``warm_executables([0, n_patches])``). A ``/generate`` with
``image_b64`` is decoded, resized bicubic and normalized
(``common.decode_image``), run through the tower into a ``[n_patches,
dim]`` prefix, its text head-kept to the largest bucket less the prefix,
and submitted with ``prefix=``. An image this decoder does not read
(arithmetic-coded, lossless or 12-bit JPEG, CMYK, GIF, WebP, bytes that
are no image or no base64) answers 400 naming what was sent, as does an
image sent to a model without a tower.
"""

from __future__ import annotations

import base64
import binascii
import itertools
import json
import logging
import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...core.device import resolve_device
from ...engine.config import EngineConfig
from ...engine.types import K_LOGPROBS
from ...engine.cache import PagedKVCache
from ...kvnet import migrate as migmod
from ...kvnet import resolve_role
from ...kvtier.affinity import AffinityTracker, prompt_affinity
from ...models.generate import ByteTokenizer
from ...models import mllama as mllama_mod
from ...models import vlm as vlm_mod
from ...models.convert import (
    is_llava_dir,
    is_mllama_dir,
    load_hf_checkpoint,
    load_llava_checkpoint,
    load_mllama_checkpoint,
)
from ...models.imageio import ImageError, decode_image
from ...models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    geometry_params,
    random_params,
)
from ...models.tokenizer import BpeTokenizer
from ...obs import trace as obs_trace
from ...ops.cuda.flash_attention import HEAD_DIMS
from ...ops.quant import quantize_state_dict
from ...resilience import deadline as rz_deadline
from ...resilience import qos as rz_qos
from ...resilience.drain import StepWatchdog
from ...utils.env import ServeConfig, env_float, env_str
from ..app import ModelService
from ..asgi import HTTPError, StreamingResponse
from .common import SseTextAssembler, decode_image as decode_pixels

log = logging.getLogger(__name__)

#: zero-weight full-size tiers: boot with no checkpoint and no network, so
#: the serving stack runs at real shapes (outputs are meaningless)
GEOMETRY_MODELS = {
    "llama-1b-geometry": LlamaConfig.llama32_1b,
    "llama-3b-geometry": LlamaConfig.llama32_3b,
    "llama-8b-geometry": LlamaConfig.llama3_8b,
    "mistral-7b-geometry": LlamaConfig.mistral_7b,
}


class VllmService(ModelService):
    """Continuous batching across concurrent HTTP requests through the
    engine loop; ``concurrency`` widens the model lane to the slot count so
    requests reach the loop together and share decode steps."""

    task = "text-generation"
    infer_route = "/generate"

    def __init__(self, cfg: ServeConfig,
                 weights: Optional[Callable[[LlamaConfig, torch.device],
                                            Dict[str, torch.Tensor]]] = None):
        """``weights(model_config, device)``, when given, returns the state
        dict ``load`` serves instead of the tier's own weights."""
        super().__init__(cfg)
        self._weights = weights
        self._openai_ids = itertools.count()
        # a bad ConfigMap must not crash construction: the error surfaces
        # from load() as a readiness failure instead of a crash loop
        self._ecfg_error: Optional[Exception] = None
        self._engine = None
        self.loop = None
        self._watchdog: Optional[StepWatchdog] = None
        self.warm_seconds = 0.0
        #: seconds the checkpoint directory took to load (0 for the tiers)
        self.load_seconds = 0.0
        try:
            self.ecfg = self._resolve_ecfg(cfg)
            self.concurrency = self.ecfg.max_num_seqs
        except Exception as e:
            self.ecfg = None
            self._ecfg_error = e
            self.concurrency = 1
        # warm-prefix advertisement: each served prompt's leading-text
        # digest, exposed on /stats
        self._affinity = AffinityTracker()
        # the pod's role, advertised on /stats before the engine exists;
        # the transport attaches in load() once the tier does
        self.role = resolve_role(self.ecfg.role if self.ecfg else "both")
        self._kvnet: Optional[migmod.MigrateClient] = None
        self._kvnet_stats = None
        # live migration: accepted, unreplayed manifests (exactly-once),
        # and the latch of a ship whose peer may still pull blocks
        self._migrate_inbox: Optional[migmod.MigrationInbox] = None
        self._pending_pull = False
        # KV fabric: affinity digest -> chain head of the served prompts
        self._aff_lock = threading.Lock()
        self._aff_heads: "OrderedDict[str, int]" = OrderedDict()
        # mllama: (vision config, encode(img) -> (states, n_valid), Lv),
        # None for a text model; one image encodes at a time
        self._mllama = None
        # the soft-prefix VLM: (tower config, VisionProjector), None for a
        # model without a tower
        self._vision = None
        self._vision_lock = threading.Lock()
        #: seconds the vision front-end took to encode its warm image
        self.vision_warm_seconds = 0.0

    @staticmethod
    def _resolve_ecfg(cfg: ServeConfig) -> EngineConfig:
        if os.path.exists(cfg.vllm_config):
            ecfg = EngineConfig.from_yaml(cfg.vllm_config)
            if ecfg.ignored_keys:
                log.info("vllm_config: ignoring keys %s", ecfg.ignored_keys)
            return ecfg
        # the largest bucket must reach MAX_SEQ_LEN (block-aligned up) or
        # long prompts truncate below the advertised limit
        top = -(-cfg.max_seq_len // 16) * 16
        buckets = sorted({b for b in (128, 512, 2048) if b < top} | {top})
        return EngineConfig(
            model=cfg.model_id,
            max_model_len=-(-(cfg.max_seq_len + cfg.max_new_tokens) // 16) * 16,
            max_num_seqs=max(cfg.batch_size, 4),
            block_size=16,
            context_encoding_buckets=tuple(buckets),
            max_new_tokens=cfg.max_new_tokens,
            quantization=cfg.quantization or None,
        )

    def load(self) -> None:
        from ...engine.engine import LLMEngine, SamplingParams
        from ...engine.loop import EngineLoop

        if self._ecfg_error is not None:
            raise self._ecfg_error
        cfg, ecfg = self.cfg, self.ecfg
        device = resolve_device(cfg.device)
        model_id = ecfg.model or cfg.model_id
        quant = ecfg.quantization == "int8"
        state = vstate = None
        self.tokenizer = ByteTokenizer()
        self.eos_id = ByteTokenizer.eos_id
        if model_id in ("", "tiny"):
            mcfg = LlamaConfig.tiny()
            # tiny engine shapes: small blocks and buckets so CI exercises
            # paging (geometry tiers keep their real engine shapes)
            ecfg = EngineConfig(
                model="tiny", max_model_len=256,
                max_num_seqs=ecfg.max_num_seqs, block_size=16,
                context_encoding_buckets=(32, 64, 128),
                token_generation_buckets=ecfg.token_generation_buckets,
                tensor_parallel_size=ecfg.tensor_parallel_size,
                quantization=ecfg.quantization,
                enable_prefix_caching=ecfg.enable_prefix_caching,
                max_new_tokens=min(ecfg.max_new_tokens, 64),
                # the speculative knobs ride through: the tiny tier is how
                # the CPU tests reach the verify steps
                speculative_model=ecfg.speculative_model,
                num_speculative_tokens=ecfg.num_speculative_tokens,
                ngram_prompt_lookup_max=ecfg.ngram_prompt_lookup_max,
                ngram_prompt_lookup_min=ecfg.ngram_prompt_lookup_min,
                role=ecfg.role)
        elif model_id in GEOMETRY_MODELS:
            mcfg = GEOMETRY_MODELS[model_id]()
        elif os.path.isdir(model_id):
            # a local checkpoint: bf16 (then int8) weights one tensor at a
            # time onto the device, the tokenizer from its tokenizer.json
            t0 = time.monotonic()
            if is_mllama_dir(model_id):
                mcfg, state, vcfg, vstate, meta = load_mllama_checkpoint(
                    model_id, device, quantize=quant)
                self._mllama = self._vision_front_end(vcfg, mcfg.dim,
                                                      vstate, meta)
            elif is_llava_dir(model_id):
                # the tower and projector in bf16 on the device, as the
                # reference's VisionProjector(dtype=bfloat16)
                mcfg, state, vcfg, vstate = load_llava_checkpoint(
                    model_id, device, quantize=quant)
                self._vision = (vcfg, vlm_mod.build(vcfg, vstate,
                                                    dtype=torch.bfloat16))
            else:
                mcfg, state = load_hf_checkpoint(model_id, device,
                                                 quantize=quant)
            self.load_seconds = time.monotonic() - t0
            self.tokenizer = BpeTokenizer.from_dir(model_id)
            if self.tokenizer.eos_token_id is None:
                raise ValueError(f"tokenizer for {model_id} has no "
                                 f"eos_token_id")
            self.eos_id = self.tokenizer.eos_token_id
        else:
            raise ValueError(
                f"model {model_id!r} is not a directory: this port serves "
                f"the 'tiny' and geometry tiers ({', '.join(GEOMETRY_MODELS)})"
                f" and local checkpoint directories (config.json, "
                f"*.safetensors, tokenizer.json); it fetches nothing from a "
                f"hub")
        if device.type == "cuda" and mcfg.head_dim not in HEAD_DIMS:
            raise ValueError(
                f"model {model_id or 'tiny'!r} has head_dim {mcfg.head_dim}; "
                f"the CUDA attention kernels take head_dim in {HEAD_DIMS}. "
                f"Serve a geometry tier ({', '.join(GEOMETRY_MODELS)}) on "
                f"cuda, or this model with DEVICE=cpu")
        if state is None:   # a checkpoint's came quantized as it loaded
            if self._weights is not None:
                state = self._weights(mcfg, device)
                # the tiny tier's tower rides along under "vision."
                vstate = {k[len("vision."):]: state.pop(k)
                          for k in list(state) if k.startswith("vision.")}
            elif model_id in GEOMETRY_MODELS:
                # born int8 under quantization: an 8B tier never exists in
                # bf16 (quantize_state_dict then finds nothing to convert)
                state = geometry_params(mcfg, dtype=torch.bfloat16,
                                        device=device, quant=quant)
            else:
                state = random_params(mcfg, cfg.seed, dtype=torch.float32,
                                      device=device)
            if quant:
                state = quantize_state_dict(state)
        if model_id in ("", "tiny"):
            # the tiny tier always carries a tower (the reference's
            # :254-261): seeded f32 on the CPU, or the caller's weights
            vcfg = vlm_mod.VisionTowerConfig.tiny(lm_dim=mcfg.dim)
            if not vstate:
                vstate = vlm_mod.random_params(vcfg, cfg.seed + 9,
                                               dtype=torch.float32,
                                               device=device)
            self._vision = (vcfg, vlm_mod.build(vcfg, vstate,
                                                dtype=torch.float32))
        self.ecfg = ecfg
        model = LlamaForCausalLM.from_state_dict(mcfg, state)
        engine = LLMEngine(
            mcfg, model, ecfg, device=device,
            cross_seq_len=self._mllama[2] if self._mllama else 0)
        if self._mllama is not None:
            # the vision front-end is in the closed set too: one image
            # encoded before readiness (the reference's gray image)
            t0 = time.monotonic()
            vcfg = self._mllama[0]
            self._mllama[1](np.full((vcfg.image_size, vcfg.image_size, 3),
                                    127, np.uint8))
            if device.type == "cuda":   # the encode's work, not its launch
                torch.cuda.synchronize(device)
            self.vision_warm_seconds = time.monotonic() - t0
        prefix_lens = [0]
        if self._vision is not None:
            # so is the tower: one run on zeros before readiness
            t0 = time.monotonic()
            vcfg, tower = self._vision
            with torch.inference_mode():
                tower(torch.zeros((1, vcfg.image_size, vcfg.image_size, 3),
                                  device=device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.vision_warm_seconds = time.monotonic() - t0
            prefix_lens.append(vcfg.n_patches)
        # build the CLOSED executable set (every prefill bucket and batch
        # size, the continuation keys, every decode key captured as a CUDA
        # graph) BEFORE the engine loop starts serving, so no request
        # after readiness builds one
        t0 = time.monotonic()
        n = engine.warm_executables(prefix_lens)
        self.warm_seconds = time.monotonic() - t0
        log.info("engine: warmed %d executables in %.1f s (buckets=%s, "
                 "prefixes=%s)", n, self.warm_seconds,
                 list(engine.buckets.buckets), prefix_lens)
        self._engine = engine
        self._SamplingParams = SamplingParams
        # the network KV plane: with a host tier, /kv/blocks serves it and
        # a kv_peer request pulls into it; ONE stats object (the engine's,
        # on its telemetry seam) counts both directions. ONE client pulls
        # and ships, built tier-less too: a pod without a tier still ships
        # manifest-only migrations and resumes them by recompute
        self.role = engine.role   # env-resolved: engine and unit agree
        self._kvnet_stats = engine.obs.kvnet
        self._kvnet = migmod.MigrateClient(engine.cache.tier,
                                           self._kvnet_stats,
                                           mstats=engine.obs.migrate)
        self._migrate_inbox = migmod.MigrationInbox()
        self.loop = EngineLoop(engine).start()
        # step watchdog (liveness): work pending but no step retiring for
        # max(SHAI_WATCHDOG_MIN_S, SHAI_WATCHDOG_MULT x p99 step) fails
        # /health. Built after the loop starts: load, warmup and every
        # graph capture are behind us
        self._watchdog = StepWatchdog(
            lambda: engine.obs, lambda: engine.has_work,
            multiplier=env_float("SHAI_WATCHDOG_MULT", 30.0),
            min_stall_s=env_float("SHAI_WATCHDOG_MIN_S", 10.0))

    def _vision_front_end(self, vcfg, text_dim: int, vstate, meta):
        """``(vision config, encode, Lv)`` of an mllama checkpoint:
        ``encode(img [H, W, 3] uint8) -> (cross_states [Lv, dim] f32 on
        the device, n_valid)`` through the tiled vision model and the
        projector in bf16 (the reference's ``causal_lm.py:170-195``)."""
        vision, projector = mllama_mod.build_vision(vcfg, text_dim, vstate,
                                                    dtype=torch.bfloat16)
        supported = meta["supported_aspect_ratios"]
        mean, std = meta["image_mean"], meta["image_std"]

        def encode(img):
            with self._vision_lock:
                return mllama_mod.encode_image(vision, projector, img,
                                               supported, mean, std)

        return vcfg, encode, vcfg.cross_seq_len

    def _image_prefix(self, payload) -> torch.Tensor:
        """A request's ``image_b64`` -> the soft prefix ``[n_patches,
        dim]`` f32 on the device: decoded, resized to the tower's size
        (bicubic) and normalized (``decode_image``, the reference's
        ``common.py:180-200``), then the tower and the projector; 400 for
        an image this decoder does not take."""
        vcfg, tower = self._vision
        try:
            px = decode_pixels(payload, vcfg.image_size)
        except ImageError as e:
            raise HTTPError(400, f"bad image_b64: {e}")
        with obs_trace.span("vision_encode"), self._vision_lock, \
                torch.inference_mode():
            return tower(torch.from_numpy(px).to(tower.device))[0]

    def _image_states(self, b64):
        """An mllama request's ``image_b64`` -> ``(cross_states,
        cross_len)``; 400 for an image this decoder does not take."""
        vcfg, encode, _ = self._mllama
        if b64 == "random":   # the benchmark and warm contract
            img = mllama_mod.random_image(vcfg)
        else:
            try:
                data = base64.b64decode(str(b64), validate=True)
            except (binascii.Error, ValueError) as e:
                raise HTTPError(400, f"bad image_b64: not base64 ({e})")
            try:
                img = decode_image(data)
            except ImageError as e:
                raise HTTPError(400, f"bad image_b64: {e}")
        with obs_trace.span("vision_encode"):
            return encode(img)

    def close(self) -> None:
        if self.loop is not None:
            self.loop.stop()

    def ready_error(self) -> Optional[str]:
        if self.loop is not None and not self.loop.alive:
            return "engine loop is not running"
        return None

    def liveness_error(self) -> Optional[str]:
        return None if self._watchdog is None else self._watchdog.check()

    def drain(self, budget_s: float) -> None:
        """SIGTERM: let queued and running requests finish within the
        budget, then stop the loop with no replay left in flight
        (outstanding futures fail on the way out)."""
        t0 = time.monotonic()
        if self.loop is not None:
            self.loop.drain(budget_s)
        # a bounded join of the tier's copy-out worker: an in-flight
        # demotion copy publishes (or is abandoned, logged) in the budget
        tier = self.kv_tier()
        if tier is not None:
            tier.close(max(0.5, budget_s - (time.monotonic() - t0)))
        if self._kvnet is not None:
            self._kvnet.close()
        fab = self._fabric()
        if fab is not None:
            fab.close()   # the fabric probe's own transport

    def engine_telemetry(self):
        return None if self._engine is None else self._engine.obs

    def kv_tier(self):
        return None if self._engine is None else self._engine.cache.tier

    def kvnet_stats(self):
        return self._kvnet_stats

    def affinity_digests(self):
        if self._engine is None or not self._engine.cache.prefix_caching:
            return None  # no warm prefixes to advertise
        return self._affinity.snapshot()

    def pending_handoff(self) -> bool:
        """The drain holds ``/kv/blocks`` open while the tier banks KV a
        peer may pull: a prefill-role pod's runs, or a shipped migration
        whose peer restored less than the run (``_pending_pull``). Gated
        on banked state, so a pod that drained clean exits promptly."""
        tier = self.kv_tier()
        if tier is None or tier.n_entries == 0:
            return False
        return self.role == "prefill" or self._pending_pull

    # -- KV fabric (kvnet.directory) -----------------------------------------

    def _fabric(self):
        return None if self._engine is None else self._engine._kvfabric

    def affinity_heads(self) -> Optional[Dict[str, int]]:
        # affinity digest -> chain head: lets a router that sees prompts
        # but no token ids resolve its digest to the directory's key
        if self._fabric() is None:
            return None
        with self._aff_lock:
            return dict(self._aff_heads)

    def fabric_pull(self, source: str, head: int) -> Optional[int]:
        """Background replication: ask ``source`` for the run headed by
        ``head`` and warm it into the local tier. Returns the blocks
        fetched, or None when this pod has no fabric."""
        fab = self._fabric()
        if fab is None or self._kvnet is None:
            return None
        listing = self._kvnet.fetch_digests(str(source), head=int(head))
        if not isinstance(listing, dict):
            return 0
        try:
            hashes = [int(h) for h in listing.get("hashes") or []]
        except (TypeError, ValueError):
            return 0
        if not hashes:
            return 0
        n = self._kvnet.fetch_run(str(source), hashes)
        if n > 0:
            fab.stats.count("replications")
        return n

    def _note_affinity(self, prompt: str, ids) -> None:
        """Advertise a served prompt's warmth: its affinity digest, and on
        a fabric-armed pod the digest's chain head (the first full
        block's hash; none for a prompt shorter than a block)."""
        aff = prompt_affinity(prompt)
        self._affinity.note(aff)
        if self._fabric() is None:
            return
        bs = self._engine.ecfg.block_size
        if len(ids) < bs:
            return
        head = PagedKVCache._chain_hashes(list(ids)[:bs], bs)[0]
        with self._aff_lock:
            self._aff_heads[aff] = int(head)
            self._aff_heads.move_to_end(aff)
            while len(self._aff_heads) > 256:
                self._aff_heads.popitem(last=False)

    def _encode(self, text: str) -> List[int]:
        """Ids with BOS, cut to the engine's chunked-prefill cap (not the
        largest bucket: longer prompts chunk); the BPE tokenizer keeps its
        BOS when it cuts, as the reference's truncation does."""
        cap = self._engine.max_prompt_len
        with obs_trace.span("tokenize"):
            if isinstance(self.tokenizer, BpeTokenizer):
                return self.tokenizer.encode(text, max_length=cap)
            ids, n = self.tokenizer.encode(text, cap)
            return [int(i) for i in ids[:n]]

    def _decode(self, ids) -> str:
        if isinstance(self.tokenizer, BpeTokenizer):
            return self.tokenizer.decode(ids, skip_special_tokens=True)
        return self.tokenizer.decode(ids)

    def example_payload(self) -> Dict[str, Any]:
        return {"prompt": "the quick brown fox", "temperature": 0.0,
                "max_new_tokens": 8}

    def _sampling_from(self, payload: Dict[str, Any]):
        """Validated SamplingParams from a request payload (400 on bad
        values; an over-cap max_new_tokens is a client error, not a silent
        clamp)."""
        mnt = payload.get("max_new_tokens")
        try:
            mnt = self.ecfg.max_new_tokens if mnt is None else int(mnt)
            params = self._SamplingParams(
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                max_new_tokens=mnt,
                eos_id=self.eos_id,
                logprobs=int(payload.get("logprobs") or 0),
            )
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad sampling parameter: {e}")
        if not 0 <= params.logprobs <= K_LOGPROBS:
            raise HTTPError(400, f"logprobs must be in [0, {K_LOGPROBS}]")
        if mnt < 1:
            raise HTTPError(400, "max_new_tokens must be >= 1")
        if mnt > self.ecfg.max_new_tokens:
            raise HTTPError(
                400,
                f"max_new_tokens={mnt} exceeds this deployment's engine cap "
                f"MAX_NEW_TOKENS={self.ecfg.max_new_tokens}")
        return params

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if payload.get("resume"):
            # the replay of a migrated handoff: the manifest carries the
            # prompt, so no 'prompt' field is needed
            return self._resume_migrated(str(payload["resume"]))
        if "prompt" not in payload and "text" not in payload:
            raise HTTPError(400, "missing 'prompt'")
        prompt = str(payload.get("prompt", payload.get("text", "")))
        ids = self._encode(prompt)
        params = self._sampling_from(payload)
        if self.role == "prefill":
            # a prefill pod hands the warm KV back instead of decoding
            # (params stay validated above: a bad request 400s on every
            # role); the decode pod re-derives token 1 from the logits its
            # warm continuation produces
            return self._prefill_handoff(prompt, ids)
        if payload.get("kv_peer") and self._kvnet is not None:
            # the decode side of the handoff: pull the prompt's run into
            # the local tier before admission, which restores it
            self._pull_handoff(str(payload["kv_peer"]),
                               payload.get("kv_hashes_len"), ids,
                               prompt=prompt,
                               digest=str(payload.get("kv_digest") or ""))
        image = {}
        if payload.get("image_b64"):
            if self._mllama is not None:
                states, n_valid = self._image_states(payload["image_b64"])
                image = {"cross_states": states, "cross_len": n_valid}
            elif self._vision is not None:
                prefix = self._image_prefix(payload)
                # a soft-prefix request is bucket-bound (one prefill):
                # head-keep the text here, the tokenizer's truncation side,
                # so that the engine does not cut its tail
                max_text = self._engine.buckets.max - int(prefix.shape[0])
                if max_text < 1:
                    raise HTTPError(400, "image prefix leaves no prompt room")
                ids = ids[:max_text]
                image = {"prefix": prefix}
            else:
                raise HTTPError(400, "this deployment's model has no vision "
                                     "tower; multimodal requests need a VLM "
                                     "unit")
        # the KV fabric: a holder slice riding the payload is a hint the
        # engine's probe tries under its budget; bounded and stringified
        # here, each URL checked by the transport's allowlist
        kv_holders = payload.get("kv_holders")
        kv_holders = ([str(u) for u in kv_holders[:4]]
                      if isinstance(kv_holders, (list, tuple)) else None)
        out = self._collect(self.loop.submit(
            ids, params, deadline_at=self._deadline_at(),
            traceparent=obs_trace.current_traceparent() or "",
            idem_key=str(payload.get("idem_key") or ""),
            kv_holders=kv_holders, **image, **self._qos_kw()))
        if self._engine.cache.prefix_caching:
            # advertise warmth only for /generate, after it served
            self._note_affinity(prompt, ids)
        return out

    def _prefill_handoff(self, prompt: str, ids) -> Dict[str, Any]:
        """Prefill-role ``/generate``: run the prompt through the engine
        (one greedy token, discarded), whose finish banks the full-block
        run in the host tier, and return the handoff reference.
        ``kv_ready: false`` (no tier, or no full block) tells the router to
        serve the request monolithically."""
        eng = self._engine
        tier = eng.cache.tier
        hashes_len = (len(ids) // eng.ecfg.block_size
                      if eng.cache.prefix_caching else 0)
        kv_ready = tier is not None and hashes_len > 0
        sp = self._SamplingParams(temperature=0.0, max_new_tokens=1,
                                  eos_id=self.eos_id)
        out = self._collect(self.loop.submit(
            list(ids), sp, deadline_at=self._deadline_at(),
            traceparent=obs_trace.current_traceparent() or "",
            **self._qos_kw()))
        if kv_ready:
            try:
                # the async copy-outs publish before the peer's pull
                # lands; a failure only shortens the run the peer sees
                tier.drain()
            except Exception:
                log.warning("kvnet: tier drain after prefill failed",
                            exc_info=True)
        if eng.cache.prefix_caching:
            self._note_affinity(prompt, ids)
        return {
            "kv_ready": bool(kv_ready),
            "digest": prompt_affinity(prompt),
            "hashes_len": hashes_len,
            # the pull address peers should use; empty = the router
            # substitutes the URL it routes this pod by
            "peer_url": env_str("SHAI_KVNET_PEER_URL", "") or "",
            "n_prompt": out.get("n_prompt", len(ids)),
            "role": "prefill",
        }

    def _pull_handoff(self, peer: str, hashes_len, ids, prompt: str = "",
                      digest: str = "") -> int:
        """Decode-side handoff pull: make the local tier hold the prompt's
        leading full-block run, fetching what it lacks from ``peer``.
        Never raises. A ``kv_digest`` that is not this prompt's affinity
        digest marks a mis-routed handoff: the pull is skipped."""
        if digest and prompt and digest != prompt_affinity(prompt):
            log.warning("kvnet: handoff digest %s does not match the "
                        "request's prompt — skipping the pull "
                        "(recompute)", digest)
            return 0
        try:
            hl = int(hashes_len or 0)
        except (TypeError, ValueError):
            hl = 0
        hashes = self._engine.cache.prefix_hashes(list(ids))
        if hl > 0:
            hashes = hashes[:hl]
        if not hashes:
            return 0
        # the pull's wall budget is bounded by the request's deadline
        dl = rz_deadline.current_deadline()
        budget = None if dl is None else max(0.0, dl.remaining_s)
        with obs_trace.span("kvnet_fetch", annotation=False) as sp:
            n = self._kvnet.fetch_run(peer, hashes, budget_s=budget)
            sp.set(blocks=int(n), blocks_wanted=len(hashes))
            return n

    # -- live migration (kvnet.migrate) --------------------------------------

    def wants_migration(self) -> bool:
        return self.loop is not None and migmod.migration_enabled()

    def migrate_inflight(self) -> int:
        """The drain's migrate phase: the engine loop finishes every live
        request as ``migrated`` (manifest attached); the threads waiting
        on those futures ship the manifests and answer with the handoff
        records, outside every engine structure."""
        if self.loop is None:
            return 0
        return self.loop.migrate_all(timeout=10.0)

    def _migrated_handoff(self, fin) -> Dict[str, Any]:
        """Ship one migrated request to a peer and shape the handoff record
        the caller returns or streams. Every failure degrades down the
        ladder (a record without a ``resume`` handle tells the client to
        replay cold) and is counted; never raises."""
        eng = self._engine
        mstats = eng.obs.migrate
        man = dict(fin.migration or {})
        own = (env_str("SHAI_KVNET_PEER_URL", "") or "").strip()
        peer = ""
        ack = None
        try:
            # several candidates: a busy survivor means the next one
            peers = migmod.resolve_migrate_peers(own)
            if man and peers:
                if own:
                    # the warm-pull rung: this pod keeps /kv/blocks open
                    # through the drain
                    man.setdefault("source_url", own)
                entries = []
                tier = eng.cache.tier
                if tier is not None and man.get("hashes"):
                    # the snapshot's demotion copies out asynchronously:
                    # the run must have landed on the host before it is
                    # read (a failed drain only shortens the run shipped)
                    try:
                        tier.drain()
                    except Exception:
                        log.warning("migrate: tier drain before the ship "
                                    "failed", exc_info=True)
                    entries = tier.get_run([int(h) for h in man["hashes"]])
                with obs_trace.span("migrate_ship", annotation=False):
                    landed = self._kvnet.ship_any(peers, man, entries)
                if landed is not None:
                    peer, ack = landed
        except Exception:
            log.exception("migrate ship failed — degrading to client "
                          "replay")
            ack = None
        if ack is None:
            # cold rung: no peer took the manifest, the client replays
            mstats.count_fallback()
        elif (own and man.get("hashes")
                and int(ack.get("restored") or 0) < len(man["hashes"])):
            # the peer took the manifest but not the whole run and knows
            # our /kv/blocks: hold the drain's server open for its pull
            self._pending_pull = True
        return {
            "migrated": True,
            "peer": peer or "",
            "resume": (ack or {}).get("resume"),
            "restored": int((ack or {}).get("restored") or 0),
            "n_sent": len(fin.token_ids),
            "generated_text": self._decode(fin.token_ids),
            "n_prompt": fin.n_prompt,
            "stop_reason": "migrated",
        }

    def _resume_migrated(self, rid: str) -> Dict[str, Any]:
        """``{"resume": <handle>}`` on ``/generate``: pop the banked
        manifest (exactly once: a retried handoff reads 404 and the caller
        replays cold), re-admit it with the preemption-resume semantics,
        and return the COMPLETE output, the tokens before the migration
        included."""
        man = (self._migrate_inbox.pop(rid)
               if self._migrate_inbox is not None else None)
        if man is None:
            raise HTTPError(404, "unknown or already-resumed migration "
                                 "handle; replay the original prompt")
        pr = man.get("params") or {}
        try:
            params = self._SamplingParams(
                temperature=float(pr.get("temperature", 0.0)),
                top_k=int(pr.get("top_k", 0)),
                top_p=float(pr.get("top_p", 1.0)),
                max_new_tokens=max(1, int(pr.get("max_new_tokens", 1))),
                eos_id=int(pr.get("eos_id", self.eos_id)),
                logprobs=int(pr.get("logprobs", 0)))
            ids = [int(t) for t in man.get("prompt_ids") or []]
            already = [int(t) for t in man.get("generated") or []]
            priority = int(man.get("priority", 1))
            n_prompt = int(man.get("n_prompt", -1))
            dl_ms = float(man.get("deadline_ms") or 0.0)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad migration manifest: {e}")
        if not ids:
            raise HTTPError(400, "migration manifest has no prompt")
        deadline_at = (time.monotonic() + dl_ms / 1000.0
                       if dl_ms > 0 else self._deadline_at())
        with obs_trace.span("migrate_resume", annotation=False):
            out = self._collect(self.loop.submit(
                ids, params, deadline_at=deadline_at, priority=priority,
                tenant=str(man.get("tenant") or ""),
                already_generated=already, already_lp=man.get("lps"),
                orig_n_prompt=n_prompt,
                traceparent=obs_trace.current_traceparent() or "",
                idem_key=str(man.get("idem_key") or "")))
        if out.get("migrated"):
            # this pod's own drain migrated the replay again: not a resume
            return out
        self._engine.obs.migrate.count("resumed")
        out["resumed"] = True
        return out

    def accept_migration(self, manifest, entries):
        """``POST /kv/migrate``: restore the shipped run into the local tier
        (or pull it from the manifest's ``source_url``) and bank the
        manifest for its replay. The restore is best effort: a refused one
        still accepts the manifest, and the resume recomputes."""
        if self._engine is None or self._migrate_inbox is None \
                or self.loop is None:
            return None
        if not isinstance(manifest, dict) or not manifest.get("prompt_ids"):
            raise migmod.MigrateError("manifest has no prompt_ids")
        # the storm guard: at the inbound cap (or a full inbox) answer 429
        if not self._migrate_inbox.begin_accept(
                migmod.migrate_max_inbound()):
            raise migmod.MigrateBusy()
        eng = self._engine
        try:
            restored = migmod.restore_entries(
                eng.cache.tier, manifest, entries, eng.obs.migrate,
                kvnet=self._kvnet)
            rid = self._migrate_inbox.put(manifest)
            eng.obs.migrate.count("received")
            return {"accepted": True, "resume": rid,
                    "restored": int(restored)}
        finally:
            self._migrate_inbox.end_accept()

    def migrate_busy(self) -> Optional[float]:
        if self._migrate_inbox is None:
            return None
        return 1.0 if self._migrate_inbox.saturated(
            migmod.migrate_max_inbound()) else None

    @staticmethod
    def _deadline_at() -> float:
        """The request's deadline as an absolute monotonic instant for the
        engine (0 = none), set by the serving layer on the context the
        model lane runs under."""
        dl = rz_deadline.current_deadline()
        return 0.0 if dl is None else dl.at

    @staticmethod
    def _qos_kw() -> Dict[str, Any]:
        """The request's tenant/priority tag for ``EngineLoop.submit``,
        carried the contextvars way as the deadline."""
        tag = rz_qos.current_qos()
        if tag is None:
            return {}
        return {"priority": tag.priority, "tenant": tag.tenant}

    @staticmethod
    def _result_timeout() -> float:
        """How long to block on an engine future: past the deadline (plus
        step slack for the engine's own expiry to land), or 600 s for a
        request without one."""
        dl = rz_deadline.current_deadline()
        if dl is None:
            return 600.0
        return max(0.1, dl.remaining_s) + 30.0

    def _collect(self, fut) -> Dict[str, Any]:
        """Await one engine future and shape the result: THE translation
        from Finished to the serving dict (rejected -> 503, timeout ->
        504), shared by infer and the OpenAI ``n > 1`` samples."""
        fin = fut.result(timeout=self._result_timeout())
        # graft the engine's phase timeline onto the request trace, under
        # the live span (model_infer): queue, prefill and decode ran on the
        # loop thread; the root carries the engine request id, the join
        # key with the step records' finished_ids (first id wins for n>1)
        tr = obs_trace.current_trace()
        if tr is not None and fin.timing:
            tr.add_phase_spans(fin.timing, parent=obs_trace.current_span())
            tr.root.attrs.setdefault("engine_req_id", fin.req_id)
        if fin.stop_reason == "migrated":
            # the drain's migrate phase: ship the snapshot and hand the
            # caller the record to replay on the peer
            return self._migrated_handoff(fin)
        if fin.stop_reason == "rejected":
            raise HTTPError(503, "request rejected: prompt cannot fit the KV "
                                 "pool")
        if fin.stop_reason == "timeout":
            raise HTTPError(
                504, f"deadline exceeded: request timed out in the engine "
                     f"after {len(fin.token_ids)} tokens")
        with obs_trace.span("detokenize"):
            text = self._decode(fin.token_ids)
        out = {
            "generated_text": text,
            "n_tokens": len(fin.token_ids),
            "n_prompt": fin.n_prompt,
            "stop_reason": fin.stop_reason,
        }
        if fin.logprobs is not None:
            out["logprobs"] = fin.logprobs
        return out

    def extra_stats(self) -> Dict[str, float]:
        eng = self._engine
        out = {
            "queue_waiting": eng.n_waiting,
            "seqs_running": eng.n_running,
            "seqs_chunking": eng.n_chunking,
            "blocks_free": eng.cache.allocator.n_free,
            "blocks_total": self.ecfg.total_blocks,
            "executables": eng.n_executables,
        }
        if eng.ttft.count:
            rep = eng.ttft.report()
            out["ttft_p50_ms"] = round(rep["p50"] * 1e3, 2)
            out["ttft_p99_ms"] = round(rep["p99"] * 1e3, 2)
        if eng.tpot.count:
            out["tpot_p50_ms"] = round(eng.tpot.report()["p50"] * 1e3, 2)
        # async decode pipeline health: flushes (serialization events, one
        # flat key per reason) and the realized inter-step gap, near zero
        # when the lookahead hides the host work (SHAI_ASYNC_DECODE)
        out["pipeline_flushes"] = eng.obs.pipeline_flushes
        for reason, n in eng.obs.flush_reasons().items():
            out[f"pipeline_flush_{reason}"] = n
        gap = eng.obs.step_gap.snapshot()
        if gap["count"]:
            out["step_gap_mean_ms"] = round(
                gap["sum"] / gap["count"] * 1e3, 4)
        if eng.spec is not None:
            # acceptance and tokens per verify become shai_service_*
            # gauges beside the shai_spec_*_total counters
            out.update(eng.spec.as_dict())
        return out

    def spec_counters(self) -> Optional[Dict[str, int]]:
        eng = self._engine
        if eng is None or eng.spec is None:
            return None
        return {"drafted": eng.spec.drafted, "accepted": eng.spec.accepted,
                "committed": eng.spec.committed}

    # -- OpenAI-compatible surface ------------------------------------------

    def _default_max_tokens(self, kind: str) -> int:
        # 16 is the legacy /v1/completions default; chat has none, so a
        # chat client omitting max_tokens gets the engine cap
        return (self.ecfg.max_new_tokens if kind == "chat"
                else min(16, self.ecfg.max_new_tokens))

    def _openai_generate(self, prompt: str, body: Dict[str, Any],
                         kind: str) -> Dict[str, Any]:
        n = self._openai_n(body)
        # logprobs: completions takes an int (capped at K_LOGPROBS, over
        # the cap is a 400); chat takes a bool plus top_logprobs, of which
        # up to K_LOGPROBS are served and exactly the requested count is
        # formatted (0 = the sampled token's logprob only)
        if kind == "chat":
            want_lp = top_n = 0
            if body.get("logprobs"):
                top_n = min(int(body.get("top_logprobs") or 0), K_LOGPROBS)
                want_lp = max(1, top_n)
        else:
            want_lp = top_n = int(body.get("logprobs") or 0)
        payload = {
            "prompt": prompt,
            "temperature": body.get("temperature", 1.0),
            "top_p": body.get("top_p", 1.0),
            "max_new_tokens": body.get("max_tokens",
                                       self._default_max_tokens(kind)),
            "logprobs": want_lp,
        }
        if n == 1:
            outs = [self.infer(payload)]
        else:
            # n samples of one tokenization: one fan-out group, one queue
            # item, one parent id (cancel and deadline act on the group;
            # under SHAI_KV_COW the group prefills once and forks its KV)
            params = self._sampling_from(payload)
            ids = self._encode(prompt)
            futs = self.loop.submit_group(
                ids, [params] * n, deadline_at=self._deadline_at(),
                traceparent=obs_trace.current_traceparent() or "",
                **self._qos_kw())
            outs = []
            try:
                for fut in futs:
                    outs.append(self._collect(fut))
            except BaseException:
                # one sample failed (rejected, timeout): the others must
                # not keep decoding for nobody (cancelling one cancels the
                # group)
                for fut in futs:
                    if not fut.done():
                        self.loop.cancel(fut)
                raise
        for out in outs:
            if out.get("migrated"):
                # the OpenAI shape has no handoff: a retryable 503 naming
                # the peer, not a silently cut completion
                raise HTTPError(
                    503, "request migrated to a peer mid-drain; retry "
                         "against it",
                    headers={"retry-after": "1",
                             "x-shai-migrate-peer": out.get("peer") or ""})
        stop = body.get("stop")
        # falsy stops are dropped: '' would cut everything at position 0
        stops = [s for s in
                 ([stop] if isinstance(stop, str) else list(stop or [])) if s]
        choices = []
        total_completion = 0
        for i, out in enumerate(outs):
            text = out["generated_text"]
            finish = "stop" if out["stop_reason"] == "eos" else "length"
            for s in stops:
                cut = text.find(s)
                if cut >= 0:
                    text = text[:cut]
                    finish = "stop"
            total_completion += out["n_tokens"]
            lp_field = None
            if out.get("logprobs") is not None:
                entries = out["logprobs"]
                if finish == "stop" and stops:
                    # the entries cover exactly the returned text: keep the
                    # shortest token prefix whose decode reaches it
                    keep = 0
                    while (keep < len(entries)
                           and len(self._decode(
                               [e["token"] for e in entries[:keep]]))
                           < len(text)):
                        keep += 1
                    entries = entries[:keep]
                lp_field = self._format_logprobs(entries, kind, top_n)
            if kind == "chat":
                choices.append({"index": i, "finish_reason": finish,
                                "logprobs": lp_field,
                                "message": {"role": "assistant",
                                            "content": text}})
            else:
                choices.append({"index": i, "finish_reason": finish,
                                "logprobs": lp_field, "text": text})
        usage = {"prompt_tokens": outs[0]["n_prompt"],
                 "completion_tokens": total_completion,
                 "total_tokens": outs[0]["n_prompt"] + total_completion}
        return {"id": f"shai-{next(self._openai_ids)}",
                "created": int(time.time()),
                "model": self.cfg.model_id or "tiny", "usage": usage,
                "object": ("chat.completion" if kind == "chat"
                           else "text_completion"),
                "choices": choices}

    def _format_logprobs(self, entries, kind: str, top_n: int):
        """Engine logprob entries -> the OpenAI response shape of ``kind``,
        with exactly ``top_n`` alternatives per token."""
        def tok_str(tid: int) -> str:
            return self._decode([tid])

        if kind == "chat":
            return {"content": [
                {"token": tok_str(e["token"]), "logprob": e["logprob"],
                 "top_logprobs": [
                     {"token": tok_str(t), "logprob": lp}
                     for t, lp in zip(e["top_ids"][:top_n],
                                      e["top_logprobs"][:top_n])]}
                for e in entries]}
        return {
            "tokens": [tok_str(e["token"]) for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [
                {tok_str(t): lp
                 for t, lp in zip(e["top_ids"][:top_n],
                                  e["top_logprobs"][:top_n])}
                for e in entries],
        }

    def _openai_stream(self, prompt: str, body: Dict[str, Any], kind: str):
        """SSE token stream (OpenAI ``stream: true``): the engine's
        ``on_token`` puts each token onto a queue (nothing more, on the
        engine-loop thread), and the request's future puts an end marker
        behind the last one when it resolves; the response generator
        decodes incrementally on a stream thread, holding back partial
        UTF-8 sequences and stop prefixes, and ends with ``data:
        [DONE]``. Closing the generator (a client disconnect) cancels the
        request in the engine."""
        if self._openai_n(body) != 1:
            raise HTTPError(400, "n > 1 is not supported with stream: true")
        if body.get("logprobs"):
            raise HTTPError(400, "logprobs are not supported with "
                                 "stream: true")
        ids = self._encode(prompt)
        params = self._sampling_from({
            "temperature": body.get("temperature", 1.0),
            "top_p": body.get("top_p", 1.0),
            "max_new_tokens": body.get("max_tokens",
                                       self._default_max_tokens(kind))})
        stop = body.get("stop") or []
        stops = [stop] if isinstance(stop, str) else list(stop)
        tokq: "queue.Queue[Any]" = queue.Queue()
        end = object()
        fut = self.loop.submit(
            ids, params, on_token=tokq.put, deadline_at=self._deadline_at(),
            traceparent=obs_trace.current_traceparent() or "",
            **self._qos_kw())
        # the stream drains on a stream thread, outside the request's
        # context: keep its trace and span to graft the phases onto
        req_trace = obs_trace.current_trace()
        req_span = obs_trace.current_span()
        # the loop resolves the future after the last on_token call, so
        # the marker lands behind every token (the reference polls the
        # future every 0.2 s instead)
        fut.add_done_callback(lambda f: tokq.put(end))
        # read HERE, in the handler's context: the generator runs on a
        # stream thread, where the request's contextvars are absent
        result_timeout = self._result_timeout()
        rid = f"shai-{next(self._openai_ids)}"
        created = int(time.time())
        model = self.cfg.model_id or "tiny"

        def event(delta: str, finish, first: bool) -> str:
            if kind == "chat":
                d: Dict[str, Any] = {}
                if first:
                    d["role"] = "assistant"
                if delta:
                    d["content"] = delta
                choice = {"index": 0, "delta": d, "finish_reason": finish}
                obj = "chat.completion.chunk"
            else:
                choice = {"index": 0, "text": delta, "finish_reason": finish}
                obj = "text_completion"
            return "data: " + json.dumps(
                {"id": rid, "object": obj, "created": created,
                 "model": model, "choices": [choice]}) + "\n\n"

        def error(message: str, kind_: str) -> str:
            # the headers went out as 200: errors are signalled in-band
            return ("data: " + json.dumps({"error": {
                "message": message, "type": kind_}}) + "\n\n")

        asm = SseTextAssembler(self._decode, stops)

        def chunks():
            first = True
            finish = None
            try:
                if kind == "chat":
                    yield event("", None, True)  # the role preamble
                    first = False
                while True:
                    tok = tokq.get()
                    if tok is end:
                        break
                    delta = asm.push(tok)
                    if delta:
                        yield event(delta, None, first)
                        first = False
                    if asm.stopped:
                        # a stop string: abort and reclaim the slot
                        finish = "stop"
                        self.loop.cancel(fut)
                        break
                fin = fut.result(timeout=result_timeout)
                if req_trace is not None and fin.timing:
                    req_trace.add_phase_spans(fin.timing, parent=req_span)
                    req_trace.root.attrs.setdefault("engine_req_id",
                                                    fin.req_id)
                if fin.stop_reason == "migrated":
                    # the drain's migrate phase mid-stream: the tokens sent
                    # stand, and the in-band record names the peer and the
                    # handle the client replays, whose output continues
                    # the stream token for token
                    handoff = self._migrated_handoff(fin)
                    yield ("data: " + json.dumps({"migrated": {
                        "peer": handoff["peer"],
                        "resume": handoff["resume"],
                        "n_sent": handoff["n_sent"]}}) + "\n\n")
                    yield "data: [DONE]\n\n"
                    return
                if fin.stop_reason == "rejected":
                    yield error("request rejected: prompt cannot fit the "
                                "KV pool", "server_error")
                    yield "data: [DONE]\n\n"
                    return
                if fin.stop_reason == "timeout":
                    # the tokens already sent stand
                    yield error("deadline exceeded: generation timed out "
                                "in the engine", "timeout_error")
                    yield "data: [DONE]\n\n"
                    return
                if finish is None:
                    finish = "stop" if fin.stop_reason == "eos" else "length"
                    tail = asm.finish()  # the partial-UTF-8 holdback
                    if tail:
                        yield event(tail, None, first)
                        first = False
                yield event("", finish, False)
                yield "data: [DONE]\n\n"
            finally:
                # a client disconnect closes the generator mid-stream: the
                # engine must not keep decoding into an orphan queue
                if not fut.done():
                    self.loop.cancel(fut)

        return StreamingResponse(chunks())

    def _chat_prompt(self, messages) -> str:
        """Messages -> prompt text: ``role: content`` lines and an
        ``assistant:`` cue (the reference's layout without a chat
        template). A tokenizer with a chat template answers 501: the
        reference would render the template, which is not ported."""
        if getattr(self.tokenizer, "chat_template", None):
            raise HTTPError(
                501, "chat templates are not ported yet: this checkpoint's "
                     "tokenizer_config.json carries a chat_template; use "
                     "/v1/completions or /generate with a formatted prompt")
        if not isinstance(messages, list) or not messages:
            raise HTTPError(400, "messages must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m or "content" not in m:
                raise HTTPError(400, "each message needs role and content")
        lines = [f"{m['role']}: {m['content']}" for m in messages]
        return "\n".join(lines) + "\nassistant:"

    def _openai_n(self, body: Dict[str, Any]) -> int:
        """Validated OpenAI ``n`` (parallel samples)."""
        n = body.get("n")
        if n is None:
            n = 1
        if not isinstance(n, int) or isinstance(n, bool):
            raise HTTPError(400, "n must be an integer")
        if not 1 <= n <= self.ecfg.max_num_seqs:
            raise HTTPError(
                400, f"n must be in [1, {self.ecfg.max_num_seqs}] "
                     f"(the engine's slot batch)")
        return n

    def _require_decode_role(self) -> None:
        """The OpenAI routes return text: on a prefill-role pod (whose
        ``/generate`` returns KV handoffs) a routed client is a deploy
        error, answered as a client error."""
        if self.role == "prefill":
            raise HTTPError(
                400, "this pod serves prefill handoffs only (role="
                     "prefill); route completion requests to a decode pod")

    def extra_routes(self):
        def completions(request):
            self._require_decode_role()
            body = request.json()
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                if len(prompt) != 1:
                    raise HTTPError(400, "exactly one prompt per request")
                prompt = prompt[0]
            if not isinstance(prompt, str):
                raise HTTPError(400, "missing 'prompt'")
            if body.get("stream"):
                return self._openai_stream(prompt, body, "completion")
            return self._openai_generate(prompt, body, "completion")

        def chat(request):
            self._require_decode_role()
            body = request.json()
            prompt = self._chat_prompt(body.get("messages"))
            if body.get("stream"):
                return self._openai_stream(prompt, body, "chat")
            return self._openai_generate(prompt, body, "chat")

        def models(request):
            return {"object": "list",
                    "data": [{"id": self.cfg.model_id or "tiny",
                              "object": "model", "owned_by": "shai-cuda"}]}

        return [("/v1/completions", ("POST",), completions),
                ("/v1/chat/completions", ("POST",), chat),
                ("/v1/models", ("GET",), models)]
