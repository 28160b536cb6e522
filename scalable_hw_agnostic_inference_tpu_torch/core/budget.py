"""HBM budget validation: prove a declared geometry fits before it boots.

Port of ``scalable_hw_agnostic_inference_tpu/core/budget.py``
(``HbmBudget``, ``HbmBudgetError``, ``detect_hbm_gib``,
``params_bytes_per_chip``, ``diffusion_budget``, ``causal_lm_budget``).
The numbers are the reference's: the same parameter bytes per chip
through the TP rules table, the same KV pool and the same activation
estimate (a 1.5x margin), against the same 8% reserve.

  params    exact bytes from the state dict's shapes
            (``models.llama._weight_shapes``; the UNet and VAE built on the
            meta device), divided per chip by the TP rules table (a weight
            split on tp costs 1/tp per chip; a replicated one its full size)
  KV pool   num_blocks x block_size x layers x 2 x kv_heads x head_dim,
            split over kv heads when tp divides them
  acts      an estimate of the peak prefill residency, plus the sampling
            logits row

Where the port departs: the reference's table of TPU memory sizes (and
its v5e default) is not carried over, so ``causal_lm_budget`` and
``diffusion_budget`` take ``hbm_gib_per_chip`` as a required keyword, and
:func:`detect_hbm_gib` reads ``SHAI_HBM_GIB``, then a CUDA device's total
memory, then (for the CPU) the host's physical memory.

Used by the engine's boot gate (``engine.engine.LLMEngine``) and, with
:func:`dense_lm_budget` (no reference counterpart: the reference's dense
units place their weights without a gate), by the dense-cache units'
(``serve.units.causal_lm``), which price one rank's load before it reads
a weight; :func:`rank_budget` prices one rank of the ``t5`` and ``flux``
units the same way.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..utils.env import env_float, env_str

GIB = float(1 << 30)

#: fraction of HBM reserved for scratch/fragmentation/runtime buffers
DEFAULT_RESERVE_FRAC = 0.08

Shapes = Dict[str, Tuple[int, ...]]
BytesPerElem = Union[float, Callable[[str, Tuple[int, ...]], float]]


class HbmBudgetError(RuntimeError):
    """Raised when a declared geometry cannot fit its chips' HBM."""


def detect_hbm_gib(device) -> float:
    """Per-chip memory of ``device`` in GiB: ``SHAI_HBM_GIB`` (an explicit
    operator declaration) wins, then a CUDA device's
    ``total_memory``, then, for the CPU, the host's physical memory."""
    declared = env_float("SHAI_HBM_GIB", 0.0)
    if declared > 0:
        return declared
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory / GIB
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / GIB


@dataclasses.dataclass(frozen=True)
class HbmBudget:
    what: str
    chips: int
    hbm_gib_per_chip: float
    params_gib: float          # per chip
    kv_gib: float              # per chip
    act_gib: float             # per chip (peak, estimated)
    reserve_frac: float = DEFAULT_RESERVE_FRAC

    @property
    def total_gib(self) -> float:
        return self.params_gib + self.kv_gib + self.act_gib

    @property
    def usable_gib(self) -> float:
        return self.hbm_gib_per_chip * (1.0 - self.reserve_frac)

    @property
    def fits(self) -> bool:
        return self.total_gib <= self.usable_gib

    @property
    def headroom_gib(self) -> float:
        return self.usable_gib - self.total_gib

    def describe(self) -> str:
        return (f"{self.what}: params {self.params_gib:.2f} + "
                f"kv {self.kv_gib:.2f} + acts {self.act_gib:.2f} = "
                f"{self.total_gib:.2f} GiB/chip vs usable "
                f"{self.usable_gib:.2f} GiB/chip "
                f"({self.chips} x {self.hbm_gib_per_chip:.0f} GiB, "
                f"{self.reserve_frac:.0%} reserved) -> "
                f"{'fits, headroom' if self.fits else 'OVER BUDGET by'} "
                f"{abs(self.headroom_gib):.2f} GiB")

    def check(self) -> "HbmBudget":
        if not self.fits:
            raise HbmBudgetError(self.describe())
        return self


def _dtype_bytes(dtype: str) -> float:
    return getattr(torch, dtype).itemsize


def _leaf_bytes_fn(dtype: str, quantization: Optional[str]
                   ) -> Callable[[str, Tuple[int, ...]], float]:
    """Bytes per element of each weight: under int8 quantization exactly
    the weights ``ops.quant.quantize_state_dict`` converts (the shared
    predicate ``_is_quant_node``: attention, MLP and an untied
    ``lm_head``) cost 1.02 (an int8 weight plus its f32 scale per output
    channel, ~0.1-2% of it); the embedding, the norms and the gates stay
    at the serving dtype."""
    full = _dtype_bytes(dtype)
    if quantization != "int8":
        return lambda name, shape: full
    from ..ops.quant import _is_quant_node

    return lambda name, shape: (
        1.02 if _is_quant_node(name, torch.empty(shape, device="meta"))
        else full)


def params_bytes_per_chip(shapes: Shapes, rules, tp: int,
                          bytes_per_elem: BytesPerElem) -> float:
    """Per-chip parameter bytes of ``{name: shape}`` under ``rules``
    (``parallel.sharding.ShardingRules``) at ``tp``.

    ``bytes_per_elem`` is a float, or a callable ``(name, shape) -> float``
    for mixed-precision states (int8 weights beside full-precision
    embeddings and norms).

    Also the sharding LEGALITY check: a rule that splits a dim ``tp`` does
    not divide raises here.
    """
    from ..parallel.sharding import shard_shape

    per_leaf = (bytes_per_elem if callable(bytes_per_elem)
                else lambda name, shape: bytes_per_elem)
    total = 0.0
    for name, shape in shapes.items():
        spec = rules.spec_for(name, ndim=len(shape))
        div = 1
        if spec.dim is not None:
            try:
                # a sectioned split: every section divisible by tp
                shard_shape(name, shape, spec, tp)
            except ValueError:
                raise HbmBudgetError(
                    f"illegal sharding: {name} dim {shape[spec.dim]} not "
                    f"divisible by mesh axis 'tp'={tp}") from None
            div = tp
        n_elems = 1
        for d in shape:
            n_elems *= d
        total += n_elems * per_leaf(name, tuple(shape)) / div
    return total


def _n_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def diffusion_budget(variant, *, batch: int, height: int, width: int,
                     hbm_gib_per_chip: float,
                     reserve_frac: float = DEFAULT_RESERVE_FRAC
                     ) -> HbmBudget:
    """Budget for an SD txt2img unit at a given coalescing batch.

    Params counted exactly (the UNet and the VAE's decoding half built on
    the meta device; UNet served bf16, VAE params fp32). Activations are
    the reference's estimate: per UNet resolution level, feature-map
    elements x a live-tensor multiplier (CFG doubles the UNet batch); the
    VAE decode's upsampled feature maps (bf16 compute) dominate at high
    resolutions. 1.5x margin on both.
    """
    from ..models.unet import UNet2DCondition
    from ..models.vae import AutoencoderKL

    f = 2 ** (len(variant.vae.block_out) - 1)
    lh, lw = height // f, width // f

    unet = UNet2DCondition(variant.unet, device="meta")
    # the reference initializes the VAE through decode: the decoder and
    # post_quant, not the encoder
    vae = AutoencoderKL(variant.vae, device="meta", encoder=False)
    p_bytes = _n_params(unet) * 2.0 + _n_params(vae) * 4.0

    LIVE = 12      # simultaneously-resident tensors per UNet level (resnets
    #                + skip stash); calibrated generous, then 1.5x margin
    unet_elems = 0
    for i, ch in enumerate(variant.unet.block_out):
        unet_elems += (lh >> i) * (lw >> i) * ch
    act_unet = 2 * batch * unet_elems * LIVE * 2.0       # CFG pair, bf16
    vae_elems = 0
    for i, ch in enumerate(reversed(variant.vae.block_out)):
        s = f >> i if f >> i else 1
        vae_elems += (height // s) * (width // s) * ch
    act_vae = batch * vae_elems * 6 * 2.0                # decode path, bf16
    act = 1.5 * max(act_unet, act_vae)    # phases don't overlap

    return HbmBudget(
        what=f"sd-{variant.name} {height}x{width} batch={batch}",
        chips=1, hbm_gib_per_chip=hbm_gib_per_chip,
        params_gib=p_bytes / GIB, kv_gib=0.0, act_gib=act / GIB,
        reserve_frac=reserve_frac,
    )


def causal_lm_budget(cfg, ecfg, *, hbm_gib_per_chip: float,
                     cross_seq_len: int = 0,
                     reserve_frac: float = DEFAULT_RESERVE_FRAC
                     ) -> HbmBudget:
    """Budget for a paged-engine causal LM (LlamaConfig + EngineConfig)."""
    from ..models.llama import _weight_shapes, tp_rules

    tp = max(int(ecfg.tensor_parallel_size), 1)

    # mllama: count bytes through a plain clone, as the reference does: a
    # gated cross layer's projections have a self layer's shapes (q/k/v/o
    # + mlp; the per-layer gates and head norms are noise), so the byte
    # total matches
    plain = dataclasses.replace(cfg, cross_attention_layers=())
    bpe = _leaf_bytes_fn(ecfg.dtype, ecfg.quantization)
    p_bytes = params_bytes_per_chip(_weight_shapes(plain), tp_rules(), tp,
                                    bpe)

    # paged KV pool: self-attention layers only — cross layers hold the
    # per-slot vision KV counted separately below
    n_self = cfg.n_layers - len(cfg.cross_attention_layers)
    num_blocks = ecfg.num_blocks or (
        ecfg.max_model_len * ecfg.max_num_seqs // ecfg.block_size)
    kv_heads_chip = (cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0
                     else cfg.n_kv_heads)
    # block pool dtype: bf16, or int8 + per-(block, head) f32 scales when
    # SHAI_KV_QUANT=int8 is live — the gate prices the pool the engine will
    # actually allocate
    kv_quant = env_str("SHAI_KV_QUANT", "").strip().lower() == "int8"
    kv_dtype = 1.0 if kv_quant else 2.0
    kv_bytes = (num_blocks * ecfg.block_size * n_self * 2
                * kv_heads_chip * cfg.head_dim * kv_dtype)
    if kv_quant:
        kv_bytes += num_blocks * n_self * 2 * kv_heads_chip * 4.0
    if cfg.cross_attention_layers:
        # cross-KV buffers stay bf16 (per-slot vision states, not pooled)
        kv_bytes += (ecfg.max_num_seqs * cross_seq_len
                     * len(cfg.cross_attention_layers) * 2
                     * kv_heads_chip * cfg.head_dim * 2.0)

    # peak activation residency: the widest prefill call. Per token the
    # live set is ~(residual + q/k/v + attn out + both MLP halves); flash
    # attention keeps scores out of HBM. 1.5x margin for temporaries.
    B = max(int(getattr(ecfg, "max_prefill_batch", 1)), 1)
    T = max(ecfg.context_encoding_buckets)
    width_chip = (2 * cfg.dim + 2 * cfg.mlp_dim // tp
                  + 4 * cfg.n_heads * cfg.head_dim // tp)
    act_bytes = 1.5 * B * T * width_chip * 2.0
    act_bytes += B * cfg.vocab_size * 4.0     # sampling logits row (fp32)

    return HbmBudget(
        what=(f"{ecfg.model or 'causal-lm'} tp={tp} "
              f"window={ecfg.max_model_len}"),
        chips=tp, hbm_gib_per_chip=hbm_gib_per_chip,
        params_gib=p_bytes / GIB, kv_gib=kv_bytes / GIB,
        act_gib=act_bytes / GIB, reserve_frac=reserve_frac,
    )


def dense_lm_budget(cfg, *, tp: int, quantization: Optional[str],
                    prompt_buckets: Sequence[int], max_new_tokens: int,
                    hbm_gib_per_chip: float, what: str,
                    dtype: str = "bfloat16", cache_bytes: float = 2.0,
                    reserve_frac: float = DEFAULT_RESERVE_FRAC
                    ) -> HbmBudget:
    """Budget for one rank of a dense-cache unit (``models.generate``) at
    ``tp``: its shard of the weights, kv heads widened to tp where tp
    exceeds them as the unit loads them (``models.llama.
    replicate_kv_heads``); one batch-1 cache a prompt bucket
    (``make_generate`` keeps one each, ``prompt + max_new_tokens`` slots
    rounded up to ``DENSE_BLOCK``, ``cache_bytes`` an element; weights
    in ``dtype``, int8 ones under ``quantization``); the widest
    prefill's activations, as :func:`causal_lm_budget` estimates them,
    beside its ``[T, vocab]`` fp32 logits."""
    from ..models.llama import (
        DENSE_BLOCK,
        _weight_shapes,
        replicate_kv_heads,
        tp_rules,
    )

    wide = replicate_kv_heads({}, cfg, tp)[1]
    p_bytes = params_bytes_per_chip(_weight_shapes(wide), tp_rules(), tp,
                                    _leaf_bytes_fn(dtype, quantization))
    slots = sum(-(-(b + max_new_tokens) // DENSE_BLOCK) * DENSE_BLOCK
                for b in prompt_buckets)
    kv_bytes = (slots * cfg.n_layers * 2 * (wide.n_kv_heads // tp)
                * cfg.head_dim * cache_bytes)
    T = max(prompt_buckets)
    width_chip = (2 * cfg.dim + 2 * cfg.mlp_dim // tp
                  + 4 * cfg.n_heads * cfg.head_dim // tp)
    act_bytes = 1.5 * T * width_chip * 2.0 + T * cfg.vocab_size * 4.0
    return HbmBudget(what=f"{what} tp={tp}", chips=tp,
                     hbm_gib_per_chip=hbm_gib_per_chip,
                     params_gib=p_bytes / GIB, kv_gib=kv_bytes / GIB,
                     act_gib=act_bytes / GIB, reserve_frac=reserve_frac)


def rank_budget(shapes: Shapes, rules, tp: int, *, what: str, dtype: str,
                act_bytes: float, hbm_gib_per_chip: float,
                extra_params_bytes: float = 0.0,
                reserve_frac: float = DEFAULT_RESERVE_FRAC) -> HbmBudget:
    """One rank's load of a model whose whole-model ``{name: shape}`` is
    ``shapes``: its shard under ``rules`` at ``tp`` in ``dtype`` (the
    legality of each split checked on the way), beside
    ``extra_params_bytes`` (whole models the rank also holds on its card:
    the ``flux`` leader's T5, CLIP and VAE where they share it) and the
    caller's estimate of the peak activations, ``act_bytes``. No
    reference counterpart: the reference's ``t5`` and ``flux`` units place
    their weights without a gate."""
    p_bytes = params_bytes_per_chip(shapes, rules, tp, _dtype_bytes(dtype))
    return HbmBudget(what=f"{what} tp={tp}", chips=tp,
                     hbm_gib_per_chip=hbm_gib_per_chip,
                     params_gib=(p_bytes + extra_params_bytes) / GIB,
                     kv_gib=0.0, act_gib=act_bytes / GIB,
                     reserve_frac=reserve_frac)


def module_shapes(module: torch.nn.Module) -> Shapes:
    """``{name: shape}`` of a module's state (build it on the meta
    device: nothing is allocated)."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
