"""Llama-family causal LM (Llama-3 / Mistral / DeepSeek-distill / TinyLlama).

Port of ``scalable_hw_agnostic_inference_tpu/models/llama.py``:
``LlamaConfig`` with every preset and ``from_hf`` (``:44-150``), the
``cache=None`` full-sequence forward of ``LlamaForCausalLM`` (``:260-311``,
the scoring path; causal attention goes through the B1 kernel on CUDA) and
``geometry_params`` (``:434``). The contiguous-cache decode path, tensor
parallelism and int8 weights come in later slices.

Module names mirror the flax tree, so ``layer_{i}/attn/q`` becomes
``layers.{i}.attn.q``. Projections are ``nn.Linear`` weights ``[out, in]``;
:func:`params_from_jax` transposes the flax ``[in, out]`` kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.norms import RMSNorm
from ..ops.quant import quant_matmul
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
    # mllama gated cross-attention layer indices (empty = plain llama); the
    # port's engine rejects them until the mllama slice
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


def _linear(n_in: int, n_out: int, dtype, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=dtype, device=device)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        hd = cfg.head_dim
        self.q = _linear(cfg.dim, cfg.n_heads * hd, param_dtype, device)
        self.k = _linear(cfg.dim, cfg.n_kv_heads * hd, param_dtype, device)
        self.v = _linear(cfg.dim, cfg.n_kv_heads * hd, param_dtype, device)
        self.o = _linear(cfg.n_heads * hd, cfg.dim, param_dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        B, T, _ = x.shape
        hd = cfg.head_dim
        x = x.to(self.dtype)
        q = quant_matmul(x, self.q.weight).reshape(B, T, cfg.n_heads, hd)
        k = quant_matmul(x, self.k.weight).reshape(B, T, cfg.n_kv_heads, hd)
        v = quant_matmul(x, self.v.weight).reshape(B, T, cfg.n_kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
        # full-sequence scoring: causal within the sequence
        o = dot_product_attention(q, k, v, causal=True)
        return quant_matmul(o.reshape(B, T, cfg.n_heads * hd), self.o.weight)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.gate = _linear(cfg.dim, cfg.mlp_dim, param_dtype, device)
        self.up = _linear(cfg.dim, cfg.mlp_dim, param_dtype, device)
        self.down = _linear(cfg.mlp_dim, cfg.dim, param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        gate = quant_matmul(x, self.gate.weight)
        up = quant_matmul(x, self.up.weight)
        return quant_matmul(nn.functional.silu(gate) * up, self.down.weight)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.attn = LlamaAttention(cfg, dtype, param_dtype, device)
        self.mlp_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.mlp = LlamaMLP(cfg, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM; ``forward(ids [B, T]) -> logits [B, T, V]`` fp32.

    ``dtype`` is the compute dtype (the reference module's ``dtype``),
    ``param_dtype`` the storage dtype of freshly built weights (flax's
    default is fp32). The paged engine (``engine.runner``) reads these same
    weights.
    """

    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if cfg.cross_attention_layers:
            raise ValueError("mllama configs (cross_attention_layers) are "
                             "not ported yet")
        self.cfg, self.dtype = cfg, dtype
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=param_dtype,
                                  device=device)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, dtype, param_dtype, device)
            for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.dim, cfg.rms_eps, dtype, device=device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _linear(cfg.dim, cfg.vocab_size, param_dtype, device))

    @classmethod
    def from_state_dict(cls, cfg: LlamaConfig, state: Dict[str, torch.Tensor],
                        dtype=torch.bfloat16) -> "LlamaForCausalLM":
        """Wrap existing weights without allocating (or initialising) a
        second copy: the module is built on the meta device and the
        tensors are assigned in place."""
        with torch.device("meta"):
            model = cls(cfg, dtype=dtype)
        model.load_state_dict(state, assign=True, strict=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    def forward(self, ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T = ids.shape
        if positions is None:
            positions = torch.arange(T, dtype=torch.int32,
                                     device=ids.device).expand(B, T)
        x = self.embed.weight.to(self.dtype)[ids]
        for layer in self.layers:
            x = layer(x, positions)
        x = self.final_norm(x)
        if self.lm_head is None:
            # flax Embed.attend promotes both operands to the compute dtype
            logits = quant_matmul(x, self.embed.weight)
        else:
            logits = quant_matmul(x, self.lm_head.weight)
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
    ``[in, out]``; ``nn.Linear`` weights are ``[out, in]``."""
    if cfg.cross_attention_layers:
        raise ValueError("mllama trees are not ported yet")
    p = tree["params"]
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _to_torch(p["embed"]["embedding"]),
        "final_norm.scale": _to_torch(p["final_norm"]["scale"]),
    }
    for i in range(cfg.n_layers):
        lp = p[f"layer_{i}"]
        pre = f"layers.{i}"
        for group in ("attn", "mlp"):
            for name, leaf in lp[group].items():
                sd[f"{pre}.{group}.{name}.weight"] = _to_torch(
                    leaf["kernel"]).T.contiguous()
        sd[f"{pre}.attn_norm.scale"] = _to_torch(lp["attn_norm"]["scale"])
        sd[f"{pre}.mlp_norm.scale"] = _to_torch(lp["mlp_norm"]["scale"])
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _to_torch(
            p["lm_head"]["kernel"]).T.contiguous()
    return sd


def _weight_shapes(cfg: LlamaConfig) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the state dict with its shape; norm scales are the
    1-D entries."""
    D, hd = cfg.dim, cfg.head_dim
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd
    shapes: Dict[str, Tuple[int, ...]] = {
        "embed.weight": (cfg.vocab_size, D), "final_norm.scale": (D,)}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}"
        shapes.update({
            f"{pre}.attn_norm.scale": (D,), f"{pre}.mlp_norm.scale": (D,),
            f"{pre}.attn.q.weight": (q_out, D),
            f"{pre}.attn.k.weight": (kv_out, D),
            f"{pre}.attn.v.weight": (kv_out, D),
            f"{pre}.attn.o.weight": (D, q_out),
            f"{pre}.mlp.gate.weight": (cfg.mlp_dim, D),
            f"{pre}.mlp.up.weight": (cfg.mlp_dim, D),
            f"{pre}.mlp.down.weight": (D, cfg.mlp_dim),
        })
    if not cfg.tie_embeddings:
        shapes["lm_head.weight"] = (cfg.vocab_size, D)
    return shapes


def geometry_params(cfg: LlamaConfig, dtype=torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    """Shape-exact zero-weight state dict (norm scales are ones) for
    geometry serving: real shapes, no checkpoint, meaningless outputs.
    Made on ``device`` directly, with no host copy."""
    return {name: (torch.ones if len(shape) == 1 else torch.zeros)(
                shape, dtype=dtype, device=device)
            for name, shape in _weight_shapes(cfg).items()}


def random_params(cfg: LlamaConfig, seed: int, std: float = 0.02,
                  dtype=torch.bfloat16, device=None
                  ) -> Dict[str, torch.Tensor]:
    """Seeded random state dict: N(0, std) matrices, unit norm scales,
    drawn on ``device`` from an explicit generator."""
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    out = {}
    for name, shape in _weight_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
            out[name] = t.normal_(0.0, std, generator=gen)
    return out
