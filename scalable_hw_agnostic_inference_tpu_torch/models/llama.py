"""Llama-family causal LM (Llama-3 / Mistral / DeepSeek-distill / TinyLlama).

Port of ``scalable_hw_agnostic_inference_tpu/models/llama.py``:
``LlamaConfig`` with every preset and ``from_hf`` (``:44-150``), the
``cache=None`` full-sequence forward of ``LlamaForCausalLM`` (``:260-311``,
the scoring path; causal attention goes through the B1 kernel on CUDA),
int8 weight-only projections (``quant=True``, ``:167-176,:271``, as
:class:`QuantLinear`) and ``geometry_params`` (``:434``, born int8 with
``quant``). The contiguous-cache decode path and tensor parallelism come
in later slices.

mllama (Llama-3.2-Vision) text towers: the layers named by
``cross_attention_layers`` are :class:`LlamaCrossBlock` layers, the gated
cross-attention layers of the reference's tree (``:388-420``,
``layer_{i}/cross_attn/{q,k,v,o,q_norm,k_norm}``, ``gate_attn``,
``gate_mlp``). They attend per-request vision states, not the sequence,
and own no KV pool entry. The reference's module refuses mllama configs
and leaves them to the engine; here the scoring forward takes the cross
keys as well (``cross=``), so that an engine run can be scored.

Module names mirror the flax tree, so ``layer_{i}/attn/q`` becomes
``layers.{i}.attn.q``. Projections are ``nn.Linear`` weights ``[out, in]``
(or, quantized, ``weight_q`` int8 ``[out, in]`` and ``scale`` f32
``[out]``); :func:`params_from_jax` transposes the flax ``[in, out]``
kernels, quantized ones included.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..ops.attention import dot_product_attention
from ..ops.norms import RMSNorm, rms_norm
from ..ops.quant import _is_quant_node, quant_matmul
from ..ops.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    # HF rope_type="llama3" tuple (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = plain rope
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # mllama gated cross-attention layer indices (empty = plain llama):
    # those layers attend precomputed vision states, not the sequence
    cross_attention_layers: Tuple[int, ...] = ()

    def __post_init__(self):
        if not isinstance(self.cross_attention_layers, tuple):
            object.__setattr__(self, "cross_attention_layers",
                               tuple(self.cross_attention_layers))
        if (self.rope_scaling is not None
                and not isinstance(self.rope_scaling, tuple)):
            object.__setattr__(self, "rope_scaling",
                               tuple(self.rope_scaling))

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """Deterministic CI-tier config (byte-level vocab)."""
        return cls(
            vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_dim=128, max_seq_len=256, rope_theta=10000.0,
            tie_embeddings=True,
        )

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()  # defaults are Llama-3-8B

    @classmethod
    def llama32_1b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=2048, n_layers=16, n_heads=32,
                   n_kv_heads=8, mlp_dim=8192, max_seq_len=4096,
                   rope_theta=500000.0, tie_embeddings=True)

    @classmethod
    def llama32_3b(cls) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=3072, n_layers=28, n_heads=24,
                   n_kv_heads=8, mlp_dim=8192, max_seq_len=4096,
                   rope_theta=500000.0, tie_embeddings=True)

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32768, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, mlp_dim=14336, max_seq_len=32768,
                   rope_theta=1000000.0)

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                   mlp_dim=28672)

    @classmethod
    def mllama_11b_text(cls) -> "LlamaConfig":
        return cls(dim=4096, n_layers=40, n_heads=32, n_kv_heads=8,
                   mlp_dim=14336, max_seq_len=131072,
                   cross_attention_layers=(3, 8, 13, 18, 23, 28, 33, 38))

    @classmethod
    def llava15_7b_text(cls) -> "LlamaConfig":
        """LLaVA-1.5-7B's language model (Vicuna-7B-v1.5, Llama-2-7B's
        shape): 32 heads over 32 (MHA), the 32,064-row vocabulary of
        llava-1.5-7b-hf."""
        return cls(vocab_size=32064, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=32, mlp_dim=11008, max_seq_len=4096,
                   rope_theta=10000.0, rms_eps=1e-5)

    @classmethod
    def from_hf(cls, hf) -> "LlamaConfig":
        return cls(
            vocab_size=hf.vocab_size,
            dim=hf.hidden_size,
            n_layers=hf.num_hidden_layers,
            n_heads=hf.num_attention_heads,
            n_kv_heads=getattr(hf, "num_key_value_heads",
                               hf.num_attention_heads),
            mlp_dim=hf.intermediate_size,
            max_seq_len=getattr(hf, "max_position_embeddings", 8192),
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            rope_scaling=rope_scaling_from_hf(
                getattr(hf, "rope_scaling", None)),
            rms_eps=getattr(hf, "rms_norm_eps", 1e-5),
            tie_embeddings=getattr(hf, "tie_word_embeddings", False),
            cross_attention_layers=tuple(
                getattr(hf, "cross_attention_layers", None) or ()),
        )


def rope_scaling_from_hf(rs) -> Optional[Tuple[float, float, float, int]]:
    """HF ``config.rope_scaling`` dict -> the llama3 scaling tuple."""
    if not rs:
        return None
    rope_type = rs.get("rope_type", rs.get("type", "default"))
    if rope_type == "default":
        return None
    if rope_type != "llama3":
        raise ValueError(f"unsupported rope_scaling type {rope_type!r}")
    return (float(rs["factor"]), float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            int(rs["original_max_position_embeddings"]))


class QuantLinear(nn.Module):
    """An int8 projection (the reference's ``ops.quant.QuantDense``), read
    by ``ops.quant.quant_matmul``: ``weight_q`` int8 ``[out, in]`` and
    ``scale`` f32 ``[out]``, parameters without gradients (so that
    ``model.parameters()``, which the HBM ledger sums, holds them), made by
    ``ops.quant.quantize_state_dict``; the zeros and ones here only give
    the module its structure."""

    def __init__(self, n_in: int, n_out: int, device=None):
        super().__init__()
        self.weight_q = nn.Parameter(torch.zeros(
            (n_out, n_in), dtype=torch.int8, device=device),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(
            (n_out,), dtype=torch.float32, device=device),
            requires_grad=False)


def _linear(n_in: int, n_out: int, dtype, device,
            quantized: bool = False) -> nn.Module:
    if quantized:
        return QuantLinear(n_in, n_out, device=device)
    return nn.Linear(n_in, n_out, bias=False, dtype=dtype, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 quantized: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        hd = cfg.head_dim
        args = (param_dtype, device, quantized)
        self.q = _linear(cfg.dim, cfg.n_heads * hd, *args)
        self.k = _linear(cfg.dim, cfg.n_kv_heads * hd, *args)
        self.v = _linear(cfg.dim, cfg.n_kv_heads * hd, *args)
        self.o = _linear(cfg.n_heads * hd, cfg.dim, *args)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        x = x.to(self.dtype)
        q = quant_matmul(x, self.q).reshape(B, T, cfg.n_heads, hd)
        k = quant_matmul(x, self.k).reshape(B, T, cfg.n_kv_heads, hd)
        v = quant_matmul(x, self.v).reshape(B, T, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        # full-sequence scoring: causal within the sequence
        o = dot_product_attention(q, k, v, causal=True)
        return quant_matmul(o.reshape(B, T, cfg.n_heads * hd), self.o)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 quantized: bool = False):
        super().__init__()
        self.dtype = dtype
        args = (param_dtype, device, quantized)
        self.gate = _linear(cfg.dim, cfg.mlp_dim, *args)
        self.up = _linear(cfg.dim, cfg.mlp_dim, *args)
        self.down = _linear(cfg.mlp_dim, cfg.dim, *args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        gate = quant_matmul(x, self.gate)
        up = quant_matmul(x, self.up)
        return quant_matmul(nn.functional.silu(gate) * up, self.down)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 quantized: bool = False):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.attn = LlamaAttention(cfg, dtype, param_dtype, device, quantized)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.mlp = LlamaMLP(cfg, dtype, param_dtype, device, quantized)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class LlamaCrossAttention(nn.Module):
    """The projections and head norms of an mllama cross-attention layer
    (HF ``MllamaTextCrossAttention``): q from the text stream, k and v
    from the vision states, RMS norms over the head dim on q and k."""

    def __init__(self, cfg: LlamaConfig, param_dtype=torch.float32,
                 device=None, quantized: bool = False):
        super().__init__()
        hd = cfg.head_dim
        args = (param_dtype, device, quantized)
        self.q = _linear(cfg.dim, cfg.n_heads * hd, *args)
        self.k = _linear(cfg.dim, cfg.n_kv_heads * hd, *args)
        self.v = _linear(cfg.dim, cfg.n_kv_heads * hd, *args)
        self.o = _linear(cfg.n_heads * hd, cfg.dim, *args)
        self.q_norm = RMSNorm(hd, cfg.rms_eps, device=device)
        self.k_norm = RMSNorm(hd, cfg.rms_eps, device=device)


class LlamaCrossBlock(nn.Module):
    """One mllama gated cross-attention layer (HF
    ``MllamaCrossAttentionDecoderLayer``, the reference runner's
    ``_cross_layer`` at ``engine/runner.py:223``): ``x + tanh(gate_attn) *
    o(attend(q, vision k/v)) * has_image``, then ``+ tanh(gate_mlp) *
    mlp(...) * has_image``. No rope, no KV pool: its keys are the request's
    vision states, projected once (:meth:`project_kv`)."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None,
                 quantized: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.attn_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.cross_attn = LlamaCrossAttention(cfg, param_dtype, device,
                                              quantized)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.mlp = LlamaMLP(cfg, dtype, param_dtype, device, quantized)
        self.gate_attn = nn.Parameter(torch.zeros(1, dtype=param_dtype,
                                                  device=device))
        self.gate_mlp = nn.Parameter(torch.zeros(1, dtype=param_dtype,
                                                 device=device))

    def project_kv(self, states: torch.Tensor):
        """Vision states ``[B, Lv, dim]`` -> ``(k, v)`` ``[B, Lv, Hkv, Dh]``
        in bf16, k RMS-normed over the head dim (the reference's
        ``make_cross_kv``)."""
        cfg, ca = self.cfg, self.cross_attn
        B, Lv, _ = states.shape
        x = states.to(torch.bfloat16)
        k = quant_matmul(x, ca.k).reshape(B, Lv, cfg.n_kv_heads, cfg.head_dim)
        v = quant_matmul(x, ca.v).reshape(B, Lv, cfg.n_kv_heads, cfg.head_dim)
        k = rms_norm(k, ca.k_norm.scale, cfg.rms_eps).to(k.dtype)
        return k, v

    def forward(self, x: torch.Tensor, cross_k: torch.Tensor,
                cross_v: torch.Tensor, has_image: torch.Tensor,
                cross_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` ``[B, T, dim]``; ``cross_k``/``cross_v`` ``[B, Lv, Hkv,
        Dh]`` (k already normed); ``has_image`` ``[B]`` gates a row's whole
        contribution off (a text-only request through an mllama model);
        ``cross_len`` ``[B]`` marks each row's valid vision states (the rest
        of the static ``Lv`` buffer is masked). Non-causal attention through
        ``dot_product_attention`` with ``kv_lengths``: B1 on CUDA. The gates
        are cast to ``x``'s dtype, so the residual stream stays bf16."""
        cfg, ca = self.cfg, self.cross_attn
        B, T, _ = x.shape
        h = rms_norm(x, self.attn_norm.scale, cfg.rms_eps).to(x.dtype)
        q = quant_matmul(h, ca.q).reshape(B, T, cfg.n_heads, cfg.head_dim)
        q = rms_norm(q, ca.q_norm.scale, cfg.rms_eps).to(q.dtype)
        o = dot_product_attention(q, cross_k.to(q.dtype).contiguous(),
                                  cross_v.to(q.dtype).contiguous(),
                                  kv_lengths=cross_len)
        gate = has_image.to(x.dtype)[:, None, None]
        g_attn = torch.tanh(self.gate_attn.float()).to(x.dtype)
        g_mlp = torch.tanh(self.gate_mlp.float()).to(x.dtype)
        x = x + g_attn * quant_matmul(o.reshape(B, T, -1), ca.o) * gate
        h = rms_norm(x, self.mlp_norm.scale, cfg.rms_eps).to(x.dtype)
        m = self.mlp(h).to(x.dtype)
        return x + g_mlp * m * gate


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM; ``forward(ids [B, T]) -> logits [B, T, V]`` fp32.

    ``dtype`` is the compute dtype (the reference module's ``dtype``),
    ``param_dtype`` the storage dtype of freshly built weights (flax's
    default is fp32). ``quantized`` builds every projection the
    quantization predicate names as a :class:`QuantLinear` (the
    reference's ``quant=True``); the embedding, the norms and a tied
    ``lm_head`` stay as they are. The paged engine (``engine.runner``)
    reads these same weights.
    """

    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device: DeviceLike = None,
                 quantized: bool = False, embed_rows: Optional[int] = None):
        super().__init__()
        # the card unless the caller asks for the CPU; "meta" builds no
        # storage (from_state_dict)
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype, self.quantized = cfg, dtype, quantized
        # embed_rows: an HF mllama embedding's rows (vocab + 8 image
        # tokens); the logits stay vocab_size wide (an untied lm_head)
        self.embed = nn.Embedding(embed_rows or cfg.vocab_size, cfg.dim,
                                  dtype=param_dtype, device=device)
        cross = set(cfg.cross_attention_layers)
        self.layers = nn.ModuleList(
            (LlamaCrossBlock if i in cross else LlamaBlock)(
                cfg, dtype, param_dtype, device, quantized)
            for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _linear(cfg.dim, cfg.vocab_size, param_dtype, device,
                                quantized))

    @classmethod
    def from_state_dict(cls, cfg: LlamaConfig, state: Dict[str, torch.Tensor],
                        dtype=torch.bfloat16) -> "LlamaForCausalLM":
        """Wrap existing weights without allocating (or initialising) a
        second copy: the module is built on the meta device and the
        tensors are assigned in place. A state dict with ``*.weight_q``
        entries (``ops.quant.quantize_state_dict``) builds the int8
        model."""
        quantized = any(k.endswith(".weight_q") for k in state)
        model = cls(cfg, dtype=dtype, device="meta", quantized=quantized,
                    embed_rows=state["embed.weight"].shape[0])
        model.load_state_dict(state, assign=True, strict=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def project_cross(self, states: torch.Tensor
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Vision states ``[B, Lv, dim]`` -> each cross layer's ``(k, v)``
        ``[B, Lv, Hkv, Dh]``, in layer order."""
        return [self.layers[i].project_kv(states)
                for i in self.cfg.cross_attention_layers]

    def forward(self, ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cross: Optional[Tuple] = None,
                prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``cross``: an mllama model's ``(cross_kv, has_image [B],
        cross_len [B])``, ``cross_kv`` from :meth:`project_cross`; None
        gates every cross layer off (a text-only request). ``prefix``
        ``[B, P, dim]``: soft embeddings ahead of the ids' (the soft-prefix
        VLM's image tokens); the logits then cover ``P + T`` positions."""
        x = self.embed.weight.to(self.dtype)[ids]
        if prefix is not None:
            x = torch.cat([prefix.to(x.device, self.dtype), x], dim=1)
        B, T = x.shape[:2]
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=ids.device).expand(B, T)
        ci = 0
        for layer in self.layers:
            if isinstance(layer, LlamaCrossBlock):
                if cross is not None:   # None: has_image 0, adds nothing
                    (ck, cv), has_image, cross_len = (cross[0][ci],
                                                      cross[1], cross[2])
                    x = layer(x, ck, cv, has_image, cross_len)
                ci += 1
                continue
            x = layer(x, positions)
        x = self.final_norm(x)
        if self.lm_head is None:
            # flax Embed.attend promotes both operands to the compute dtype
            logits = quant_matmul(x, self.embed)
        else:
            logits = quant_matmul(x, self.lm_head)
        return logits.float()


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _to_torch(arr) -> torch.Tensor:
    """A numpy (or array-protocol) leaf -> a CPU tensor of the same dtype;
    bfloat16 leaves travel as their 16-bit patterns."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Dict[str, Any], cfg: LlamaConfig
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` llama tree (leaves as numpy
    arrays) -> this module's state dict. Flax ``Dense`` kernels are
    ``[in, out]``; ``nn.Linear`` weights are ``[out, in]``. A quantized
    tree (``quantize_params_tree``'s ``{"kernel_q", "scale"}`` leaves)
    gives the int8 state dict. An mllama tree's cross layers carry
    ``cross_attn`` (q/k/v/o and the q/k head norms) and the two tanh
    gates in place of ``attn``."""
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _to_torch(p["embed"]["embedding"]),
        "final_norm.scale": _to_torch(p["final_norm"]["scale"]),
    }
    for i in range(cfg.n_layers):
        lp = p[f"layer_{i}"]
        pre = f"layers.{i}"
        cross = i in cfg.cross_attention_layers
        for group in ("cross_attn" if cross else "attn", "mlp"):
            for name, leaf in lp[group].items():
                if name in ("q_norm", "k_norm"):
                    sd[f"{pre}.{group}.{name}.scale"] = _to_torch(
                        leaf["scale"])
                    continue
                sd.update(_proj_from_jax(f"{pre}.{group}.{name}", leaf))
        if cross:
            for gate in ("gate_attn", "gate_mlp"):
                sd[f"{pre}.{gate}"] = _to_torch(lp[gate]).reshape(1)
        sd[f"{pre}.attn_norm.scale"] = _to_torch(lp["attn_norm"]["scale"])
        sd[f"{pre}.mlp_norm.scale"] = _to_torch(lp["mlp_norm"]["scale"])
    if not cfg.tie_embeddings:
        sd.update(_proj_from_jax("lm_head", p["lm_head"]))
    return sd


def _proj_from_jax(stem: str, leaf: Dict[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """One flax ``Dense`` (``{"kernel"}``) or ``QuantDense``
    (``{"kernel_q", "scale"}``) leaf, ``[in, out]``, as ``[out, in]``."""
    if "kernel_q" in leaf:
        return {f"{stem}.weight_q": _to_torch(leaf["kernel_q"]).T.contiguous(),
                f"{stem}.scale": _to_torch(leaf["scale"])}
    return {f"{stem}.weight": _to_torch(leaf["kernel"]).T.contiguous()}


#: an mllama cross layer's tanh gates: 1-D like the norm scales, but
#: zeros in a geometry tree and seeded non-zero by ``random_params``
GATES = ("gate_attn", "gate_mlp")


def _is_gate(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in GATES


def _weight_shapes(cfg: LlamaConfig, embed_rows: Optional[int] = None
                   ) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the state dict with its shape; norm scales (and a
    cross layer's gates) are the 1-D entries. ``embed_rows``: the
    embedding's rows when they are not ``vocab_size`` (an HF mllama
    checkpoint's ``embed_tokens`` holds 8 image-token rows more)."""
    D, hd = cfg.dim, cfg.head_dim
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd
    shapes: Dict[str, Tuple[int, ...]] = {
        "embed.weight": (embed_rows or cfg.vocab_size, D),
        "final_norm.scale": (D,)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}"
        attn = "cross_attn" if i in cfg.cross_attention_layers else "attn"
        if attn == "cross_attn":
            shapes.update({f"{pre}.cross_attn.q_norm.scale": (hd,),
                           f"{pre}.cross_attn.k_norm.scale": (hd,),
                           f"{pre}.gate_attn": (1,),
                           f"{pre}.gate_mlp": (1,)})
        shapes.update({
            f"{pre}.attn_norm.scale": (D,), f"{pre}.mlp_norm.scale": (D,),
            f"{pre}.{attn}.q.weight": (q_out, D),
            f"{pre}.{attn}.k.weight": (kv_out, D),
            f"{pre}.{attn}.v.weight": (kv_out, D),
            f"{pre}.{attn}.o.weight": (D, q_out),
            f"{pre}.mlp.gate.weight": (cfg.mlp_dim, D),
            f"{pre}.mlp.up.weight": (cfg.mlp_dim, D),
            f"{pre}.mlp.down.weight": (D, cfg.mlp_dim),
        })
    if not cfg.tie_embeddings:
        shapes["lm_head.weight"] = (cfg.vocab_size, D)
    return shapes


def geometry_params(cfg: LlamaConfig, dtype=torch.bfloat16,
                    device: DeviceLike = None, quant: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Shape-exact zero-weight state dict (norm scales are ones) for
    geometry serving: real shapes, no checkpoint, meaningless outputs.
    Made on ``device`` (the card unless the caller asks for the CPU)
    directly, with no host copy. With ``quant`` every projection is BORN
    int8 (``weight_q`` zeros and f32 unit ``scale``), so an 8B tier never
    exists in ``dtype`` first. An mllama tree's cross gates are zeros, as
    the reference's are (``llama.py:474-475``): the image changes
    nothing."""
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in _weight_shapes(cfg).items():
        if _is_gate(name):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif quant and _is_quant_node(name, torch.empty(shape,
                                                        device="meta")):
            stem = name[: -len(".weight")]
            out[f"{stem}.weight_q"] = torch.zeros(shape, dtype=torch.int8,
                                                  device=device)
            out[f"{stem}.scale"] = torch.ones(shape[:1], dtype=torch.float32,
                                              device=device)
        else:
            out[name] = (torch.ones if len(shape) == 1 else torch.zeros)(
                shape, dtype=dtype, device=device)
    return out


def random_params(cfg: LlamaConfig, seed: int, std: float = 0.02,
                  dtype=torch.bfloat16, device: DeviceLike = None
                  ) -> Dict[str, torch.Tensor]:
    """Seeded random state dict: N(0, std) matrices, unit norm scales,
    drawn on ``device`` (the card unless the caller asks for the CPU) from
    an explicit generator. An mllama model's tanh gates are drawn from
    U(0.5, 1.5), not left at HF's initial 0, at which the image would
    change nothing."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in _weight_shapes(cfg).items():
        if _is_gate(name):
            t = torch.empty(shape, dtype=dtype, device=device)
            out[name] = t.uniform_(0.5, 1.5, generator=gen)
        elif len(shape) == 1:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
            out[name] = t.normal_(0.0, std, generator=gen)
    return out
