"""The T5 encoder (v1.1 family): Flux's sequence conditioning and the
embeddings unit.

Port of ``scalable_hw_agnostic_inference_tpu/models/t5.py`` (``T5Config``,
``relative_position_bucket``, ``T5Attention``, ``T5RMSNorm``, ``T5FF``,
``T5Encoder``, ``mean_pool``, ``params_from_torch``) and the
tensor-parallel rules table (``tp_rules``) over this module's names.

Over ``group=`` (one rank of the tensor-parallel encoder, the calls
GSPMD inserts in the reference made here): the attention holds the
rank's heads of q, k and v and the matching input rows of ``o``, and
all-reduces after ``o``; the relative bias table stays whole, as the
reference's table replicates it, and each rank takes its heads' columns
where it is used; the FF splits ``wi_0``/``wi_1`` on their outputs and
``wo`` on its inputs, then all-reduces; the embedding table is split on
features, so each rank looks up its slice and gathers the rest. The
norms and the mean-pool run on the replicated hidden state. A tp that
does not divide the heads, ``d_ff`` or the width is refused before
anything is allocated (:func:`check_tp`).

T5's specifics: no ``1/sqrt(d)`` scaling of the scores, a relative
position bias computed once from block 0's table and shared by every
layer, pre-RMSNorm, no biases, gated tanh GELU (v1.1) or ReLU (v1.0), an
fp32 output.

The attention carries that bias and a key mask, so it is not B1's
function: the reference computes it with XLA's einsum outside any Pallas
kernel (``impl="xla"``), and here it is the same plain PyTorch
(:func:`t5_attention`: scores in fp32, the bias added, masked keys at
``-1e30``, probabilities cast to ``v``'s dtype), on the CPU and on the card
alike. It never reaches ``ops.attention.dot_product_attention``.

Weights: :func:`params_from_jax` (the JAX package's flax tree) and
:func:`state_from_hf` (HF ``T5EncoderModel`` keys, with or without
``encoder.``; the embedding from ``shared.weight`` or
``encoder.embed_tokens.weight``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device
from ..parallel.sharding import (
    ShardingRules,
    ShardSpec,
    column_parallel,
    replicated,
    row_parallel,
)
from .encoder import Dense, param, row_linear, state_from_flax
from .llama import group_size

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 1024          # d_model
    d_kv: int = 64
    heads: int = 16
    d_ff: int = 2816         # v1.1's gated-GELU width
    n_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6
    gated: bool = True       # v1.1: gated GELU; v1.0: ReLU

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=256, dim=32, d_kv=8, heads=4, d_ff=64,
                   n_layers=2, rel_buckets=8, rel_max_distance=16)

    @classmethod
    def t5_v1_1_large(cls) -> "T5Config":
        return cls()

    @classmethod
    def t5_v1_1_xxl(cls) -> "T5Config":
        """google/t5-v1_1-xxl's encoder: FLUX.1's ``text_encoder_2``."""
        return cls(dim=4096, d_kv=64, heads=64, d_ff=10240, n_layers=24)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "T5Config":
        """From an HF T5 ``config.json`` (a dict)."""
        return cls(
            vocab_size=hf["vocab_size"],
            dim=hf["d_model"],
            d_kv=hf["d_kv"],
            heads=hf["num_heads"],
            d_ff=hf["d_ff"],
            n_layers=hf["num_layers"],
            rel_buckets=hf["relative_attention_num_buckets"],
            rel_max_distance=hf.get("relative_attention_max_distance", 128),
            eps=hf.get("layer_norm_epsilon", 1e-6),
            gated="gated" in hf.get("feed_forward_proj", "relu"),
        )


def relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's bidirectional bucketing of ``key_pos - query_pos`` (int)."""
    nb = num_buckets // 2
    ret = torch.where(rel_pos > 0, nb, 0)
    n = rel_pos.abs()
    max_exact = nb // 2
    is_small = n < max_exact
    # clamp(n, 1) guards log(0); those entries take the is_small branch
    log_ratio = torch.log(n.clamp(min=1).float() / max_exact) / \
        math.log(max_distance / max_exact)
    large = max_exact + (log_ratio * (nb - max_exact)).to(torch.int32)
    large = large.clamp(max=nb - 1)
    return ret + torch.where(is_small, n, large)


def t5_attention(q, k, v, mask: Optional[torch.Tensor],
                 bias: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, D]`` attention with an additive ``bias`` (broadcast to
    ``[B, H, T, S]``), a boolean key ``mask`` and no scaling, as the
    reference's XLA path computes it: scores in fp32, probabilities cast to
    ``v``'s dtype before the second product."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    s = s + bias.float()
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)
    return o.to(q.dtype)


class T5RMSNorm(nn.Module):
    """RMS norm in fp32 times the scale, returned in the input's dtype."""

    is_norm = True

    def __init__(self, dim: int, eps: float, pd, device):
        super().__init__()
        self.eps = eps
        self.weight = param((dim,), pd, device, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        n = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (n * self.weight.float()).to(x.dtype)


def check_tp(cfg: T5Config, tp: int) -> None:
    """Refuse a tp that does not divide the heads, ``d_ff`` or the width
    (the embedding's features), naming them."""
    bad = {n: v for n, v in (("heads", cfg.heads), ("d_ff", cfg.d_ff),
                             ("dim", cfg.dim)) if v % tp}
    if tp < 1 or bad:
        raise ValueError(f"T5 at tp={tp}: tp must divide heads="
                         f"{cfg.heads}, d_ff={cfg.d_ff} and dim={cfg.dim}; "
                         f"it does not divide {', '.join(sorted(bad))}")


class T5Attention(nn.Module):
    """Self-attention; under ``group`` the rank's ``heads / tp`` heads,
    all-reduced after ``o``."""

    def __init__(self, cfg: T5Config, pd, device, group=None):
        super().__init__()
        self.cfg, self.group = cfg, group
        self.heads = cfg.heads // group_size(group)
        inner = self.heads * cfg.d_kv
        for n in ("q", "k", "v"):
            setattr(self, n, Dense(cfg.dim, inner, False, pd, device))
        self.o = Dense(inner, cfg.dim, False, pd, device)

    def forward(self, x, mask, position_bias):
        """``position_bias [1, heads, T, T]``: this rank's heads."""
        c = self.cfg
        B, T, _ = x.shape
        q, k, v = (getattr(self, n)(x).reshape(B, T, self.heads, c.d_kv)
                   for n in ("q", "k", "v"))
        o = t5_attention(q, k, v, mask, position_bias)
        return row_linear(self.o, o.reshape(B, T, self.heads * c.d_kv),
                          self.group)


class T5FF(nn.Module):
    """The (gated) FF; under ``group`` the rank's ``d_ff / tp`` slice,
    all-reduced after ``wo``."""

    def __init__(self, cfg: T5Config, pd, device, group=None):
        super().__init__()
        self.gated, self.group = cfg.gated, group
        ff = cfg.d_ff // group_size(group)
        self.wi_0 = Dense(cfg.dim, ff, False, pd, device)
        self.wi_1 = Dense(cfg.dim, ff, False, pd, device) \
            if cfg.gated else None
        self.wo = Dense(ff, cfg.dim, False, pd, device)

    def forward(self, x):
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = F.relu(self.wi_0(x))
        return row_linear(self.wo, h, self.group)


class T5Encoder(nn.Module):
    """``input_ids [B, T]``, ``attention_mask [B, T]`` (optional) -> the
    last hidden state ``[B, T, dim]`` fp32, computing in ``dtype``.
    ``device`` defaults to the card; ``"cpu"`` for the CPU. ``group``:
    one rank of the tensor-parallel encoder (module note), its state the
    rank's shard under :func:`tp_rules`."""

    def __init__(self, cfg: T5Config, dtype=torch.float32, param_dtype=None,
                 device: DeviceLike = None, group=None):
        super().__init__()
        check_tp(cfg, group_size(group))
        if str(device) != "meta":
            device = resolve_device(device)
        pd = dtype if param_dtype is None else param_dtype
        c = cfg
        self.cfg, self.dtype, self.group = cfg, dtype, group
        self.embed = param((c.vocab_size, c.dim // group_size(group)), pd,
                           device)
        self.rel_bias = param((c.rel_buckets, c.heads), pd, device)
        for i in range(c.n_layers):
            self.add_module(f"layer_{i}_ln1", T5RMSNorm(c.dim, c.eps, pd,
                                                        device))
            self.add_module(f"layer_{i}_attn", T5Attention(c, pd, device,
                                                           group))
            self.add_module(f"layer_{i}_ln2", T5RMSNorm(c.dim, c.eps, pd,
                                                        device))
            self.add_module(f"layer_{i}_ff", T5FF(c, pd, device, group))
        self.final_ln = T5RMSNorm(c.dim, c.eps, pd, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def position_bias(self, T: int) -> torch.Tensor:
        """``[1, H, T, T]``: block 0's table at each (query, key) bucket,
        at this rank's heads under a group (their columns of the whole
        table)."""
        pos = torch.arange(T, device=self.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], self.cfg.rel_buckets,
            self.cfg.rel_max_distance)
        table = self.rel_bias
        if self.group is not None:
            h = self.cfg.heads // self.group.size
            table = table[:, self.group.rank * h:(self.group.rank + 1) * h]
        return table[buckets.long()].permute(2, 0, 1)[None]

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``ids``; under a group the rank's
        feature slice, gathered over the ranks."""
        x = self.embed[ids]
        return x if self.group is None else self.group.all_gather(x, -1)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        c = self.cfg
        ids = input_ids.to(self.device, torch.int64)
        x = self.embed_tokens(ids).to(self.dtype)
        bias = self.position_bias(ids.shape[1])
        mask = None
        if attention_mask is not None:
            mask = attention_mask.to(self.device)[:, None, None, :].bool()
        for i in range(c.n_layers):
            h = getattr(self, f"layer_{i}_ln1")(x)
            x = x + getattr(self, f"layer_{i}_attn")(h, mask, bias)
            h = getattr(self, f"layer_{i}_ln2")(x)
            x = x + getattr(self, f"layer_{i}_ff")(h)
        return self.final_ln(x).float()


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor
              ) -> torch.Tensor:
    """The masked mean over tokens: the embeddings unit's readout."""
    m = attention_mask.to(hidden.device)[..., None].to(hidden.dtype)
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)


def encode_fn(model: T5Encoder) -> Callable[[torch.Tensor], torch.Tensor]:
    """``ids -> last hidden state`` under ``torch.inference_mode``, no mask
    (Flux attends its padded T5 sequence whole, as the reference does)."""

    def encode(ids: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(ids)

    return encode


# -- weights ------------------------------------------------------------------

def hf_names(cfg: T5Config, keys) -> Dict[str, str]:
    """This module's state name -> the HF ``T5EncoderModel`` key in a
    checkpoint holding ``keys``."""
    keys = set(keys)
    pre = "encoder." if any(k.startswith("encoder.") for k in keys) else ""
    out = {
        "embed": "shared.weight" if "shared.weight" in keys
        else f"{pre}embed_tokens.weight",
        "rel_bias": f"{pre}block.0.layer.0.SelfAttention"
                    ".relative_attention_bias.weight",
        "final_ln.weight": f"{pre}final_layer_norm.weight",
    }
    ff = ("wi_0", "wi_1", "wo") if cfg.gated else ("wi", "wo")
    for i in range(cfg.n_layers):
        b = f"{pre}block.{i}.layer"
        for n in ("q", "k", "v", "o"):
            out[f"layer_{i}_attn.{n}.weight"] = \
                f"{b}.0.SelfAttention.{n}.weight"
        out[f"layer_{i}_ln1.weight"] = f"{b}.0.layer_norm.weight"
        for n in ff:
            port = "wi_0" if n == "wi" else n
            out[f"layer_{i}_ff.{port}.weight"] = \
                f"{b}.1.DenseReluDense.{n}.weight"
        out[f"layer_{i}_ln2.weight"] = f"{b}.1.layer_norm.weight"
    return out


def hf_items(get: Callable[[str], torch.Tensor], keys, cfg: T5Config
             ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The encoder's state as ``(name, tensor)`` entries from HF
    ``T5EncoderModel`` tensors, each read by ``get(name)`` when it is
    taken (``keys`` are the checkpoint's names; layers past ``n_layers``
    are not read). A missing tensor raises, naming it, before any is
    read."""
    keys = set(keys)
    names = hf_names(cfg, keys)
    for name, src in names.items():
        if src not in keys:
            raise ValueError(f"T5 checkpoint has no {src!r} (for {name})")
    return ((name, get(src)) for name, src in names.items())


def state_from_hf(get: Callable[[str], torch.Tensor], keys,
                  cfg: T5Config) -> Dict[str, torch.Tensor]:
    """The encoder's state from HF ``T5EncoderModel`` tensors: ``get(name)``
    returns one, ``keys`` are the checkpoint's names (layers past
    ``n_layers`` are not read). A missing tensor raises, naming it."""
    return dict(hf_items(get, keys, cfg))


def tp_rules() -> ShardingRules:
    """The reference's ``tp_rules`` (``t5.py:175``, its
    ``shard_t5_attention``/``shard_t5_ff`` as a table) rule for rule over
    this module's names (``[out, in]`` weights): q/k/v and the gated FF's
    inputs split on their outputs, o and ``wo`` on their inputs; the bare
    ``embed`` table ``[vocab, dim]`` on its features; the rest, the
    relative bias table among it, replicated (a rank takes its heads'
    columns of that table where it uses them)."""
    return ShardingRules([
        (r"attn\.(q|k|v)\.weight", column_parallel()),
        (r"attn\.o\.weight", row_parallel()),
        (r"ff\.(wi_0|wi_1)\.weight", column_parallel()),
        (r"ff\.wo\.weight", row_parallel()),
        (r"^embed$", ShardSpec(1)),
        (r".*", replicated()),
    ])


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of ``T5Encoder`` (numpy
    leaves) -> this module's state dict (the embedding and the bias table
    are bare parameters here)."""
    sd = state_from_flax(tree)
    for name in ("embed", "rel_bias"):
        sd[name] = sd.pop(f"{name}.weight")
    return sd


def build(cfg: T5Config, state: Dict[str, torch.Tensor],
          dtype=torch.float32, group=None) -> T5Encoder:
    """The encoder around ``state`` (built on the meta device, the tensors
    assigned: no second copy), computing in ``dtype``; under ``group``,
    ``state`` is the rank's shard."""
    m = T5Encoder(cfg, dtype=dtype, device="meta", group=group)
    m.load_state_dict(state, assign=True, strict=True)
    return m
