"""The Flux (MMDiT) transformer.

Port of ``scalable_hw_agnostic_inference_tpu/models/flux.py``
(``FluxConfig``, ``rope_freqs``, ``apply_rope_2d``, ``timestep_embedding``,
``MLPEmbedder``, ``QKNorm``, ``modulation``, ``DoubleBlock``,
``SingleBlock``, ``FluxTransformer``, ``patchify``, ``unpatchify``,
``make_ids``, ``bfl_from_diffusers``, ``params_from_torch``) and the
tensor-parallel rules table (``tp_rules``) over this module's names.

Over ``group=`` (one rank of the tensor-parallel transformer, the calls
GSPMD inserts in the reference made here, its state the rank's shard
under :func:`tp_rules`): each stream's q, k and v at the rank's ``heads /
tp`` heads (the fused ``qkv`` cut per section, its bias with it), the QK
norm per head, RoPE and the joint attention at those heads (B1 on the
card), and an all-reduce after each attention projection and each second
MLP half, its bias added once after the sum; a single block's
``linear1`` gives the rank's q, k, v and MLP sections, GELU runs on its
MLP slice, and ``linear2`` takes the rank's attention and MLP inputs,
all-reduced. The modulations, the embedders and the final layer stay
replicated. A tp that does not divide the heads or the MLP width is
refused before anything is allocated (:func:`check_tp`).

Patchified latents and T5 sequence conditioning pass through joint
(double) blocks, where the text and image streams attend together, then
through fused single blocks over the concatenated stream; 3-axis RoPE
over interleaved pairs in fp32; AdaLN modulation from the timestep, the
CLIP pooled vector and (FLUX.1-dev) the guidance embedding.

Dtypes follow the reference: denses in the compute dtype (bf16 on the
card), the affine-free LayerNorms (epsilon 1e-6, flax's) and the q/k RMS
norms in fp32, tanh GELU, the output in fp32. Every attention goes through
``ops.attention.dot_product_attention``: on a CUDA tensor that is the B1
kernel (bf16, non-causal, no lengths, MHA), on the CPU the plain path.

The modules' names map one to one onto the JAX tree (``double_{i}``,
``single_{i}``, ``img_qkv``, ``qknorm.q_scale``, ...), so the flax tree
converts by :func:`params_from_jax`; :func:`state_from_bfl` reads the
black-forest-labs single-file names (or the diffusers ``transformer/``
layout through :func:`bfl_from_diffusers`); :func:`seeded` makes random
weights on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Iterable, Iterator, Mapping,
                    Optional, Tuple)

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device
from ..ops.attention import dot_product_attention
from ..parallel.sharding import (
    ShardingRules,
    column_parallel,
    replicated,
    row_parallel,
    sectioned,
)
from .encoder import Dense, param, row_linear, seeded_init_, state_from_flax
from .llama import group_size

#: flax's LayerNorm epsilon (the reference's affine-free norms)
LN_EPS = 1e-6
#: the q/k RMS norms' epsilon
QK_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64            # 16 latent channels x a 2 x 2 patch
    hidden: int = 3072
    heads: int = 24
    n_double: int = 19
    n_single: int = 38
    mlp_ratio: int = 4
    t5_dim: int = 4096
    clip_dim: int = 768
    axes_dim: Tuple[int, ...] = (16, 56, 56)   # RoPE's split of head_dim 128
    theta: float = 10000.0
    guidance_embed: bool = True      # FLUX.1-dev; schnell has none

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @classmethod
    def flux_dev(cls) -> "FluxConfig":
        return cls()

    @classmethod
    def flux_schnell(cls) -> "FluxConfig":
        """FLUX.1-schnell: dev's widths without the guidance embedding."""
        return cls(guidance_embed=False)

    @classmethod
    def tiny(cls) -> "FluxConfig":
        # t5_dim/clip_dim match T5Config.tiny and ClipTextConfig.tiny, so
        # the tiny tier wires the real conditioning path end to end
        return cls(in_channels=16, hidden=64, heads=4, n_double=2, n_single=2,
                   t5_dim=32, clip_dim=32, axes_dim=(4, 6, 6))


# -- positions, RoPE and the timestep embedding -------------------------------

def rope_freqs(ids: torch.Tensor, axes_dim, theta: float) -> torch.Tensor:
    """Positional ids ``[B, L, n_axes]`` -> ``(cos, sin)`` pairs
    ``[B, L, head_dim / 2, 2]`` in fp32."""
    outs = []
    for i, d in enumerate(axes_dim):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=ids.device) / half))
        outs.append(ids[..., i:i + 1].float() * freqs[None, None, :])
    ang = torch.cat(outs, dim=-1)
    return torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)


def apply_rope_2d(x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """``x [B, L, H, D]`` rotated over interleaved pairs ``(x[2i],
    x[2i+1])`` by ``cs [B, L, D/2, 2]``, in fp32, returned in ``x``'s
    dtype."""
    B, L, H, D = x.shape
    xf = x.float().reshape(B, L, H, D // 2, 2)
    cos = cs[..., 0][:, :, None, :]
    sin = cs[..., 1][:, :, None, :]
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(B, L, H, D).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       scale: float = 1000.0) -> torch.Tensor:
    """``[B]`` (timesteps in [0, 1]) -> ``[B, dim]`` ``[cos | sin]`` in
    fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = scale * t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _layer_norm(x: torch.Tensor, dtype) -> torch.Tensor:
    """The affine-free LayerNorm in fp32, cast to ``dtype``."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS).to(dtype)


def _mod(x, shift, scale):
    return (1 + scale) * x + shift


# -- modules ------------------------------------------------------------------

class MLPEmbedder(nn.Module):
    def __init__(self, n_in: int, hidden: int, pd, device):
        super().__init__()
        self.in_layer = Dense(n_in, hidden, True, pd, device)
        self.out_layer = Dense(hidden, hidden, True, pd, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


class QKNorm(nn.Module):
    """RMS norm of q and k over each head, in fp32 (epsilon 1e-6), times
    the learnt scales, cast to the compute dtype."""

    def __init__(self, dim: int, pd, device):
        super().__init__()
        self.q_scale = param((dim,), pd, device, 1.0)
        self.k_scale = param((dim,), pd, device, 1.0)

    @staticmethod
    def _rms(x, scale, dtype):
        x32 = x.float()
        n = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + QK_EPS)
        return (n * scale.float()).to(dtype)

    def forward(self, q, k, dtype):
        return self._rms(q, self.q_scale, dtype), \
            self._rms(k, self.k_scale, dtype)


def modulation(layer: Dense, vec: torch.Tensor, n: int):
    """AdaLN: ``silu(vec)`` through ``layer`` (``3 n hidden`` wide), cut
    into ``3 n`` ``[B, 1, hidden]`` (shift, scale, gate) chunks."""
    out = layer(F.silu(vec))
    return out[:, None, :].chunk(3 * n, dim=-1)


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    B, L, _ = x.shape
    return x.reshape(B, L, H, -1)


def _attention(q, k, v):
    """The joint attention: B1 on the card (bf16, contiguous, no mask or
    lengths), the plain path on the CPU."""
    return dot_product_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous())


def check_tp(cfg: FluxConfig, tp: int) -> None:
    """Refuse a tp that does not divide the heads (24 for FLUX.1) or the
    MLP width, naming them."""
    m = cfg.mlp_ratio * cfg.hidden
    if tp < 1 or cfg.heads % tp or m % tp:
        raise ValueError(f"Flux at tp={tp}: tp must divide heads="
                         f"{cfg.heads} and the MLP width {m}")


class DoubleBlock(nn.Module):
    """A joint block; under ``group`` each stream at the rank's heads and
    MLP slice (module note)."""

    def __init__(self, cfg: FluxConfig, dtype, pd, device, group=None):
        super().__init__()
        self.cfg, self.dtype, self.group = cfg, dtype, group
        tp = group_size(group)
        self.heads = cfg.heads // tp
        h, m = cfg.hidden, cfg.mlp_ratio * cfg.hidden
        hr, mr = h // tp, m // tp
        for s in ("img", "txt"):
            self.add_module(f"{s}_mod", Dense(h, 6 * h, True, pd, device))
            self.add_module(f"{s}_qkv", Dense(h, 3 * hr, True, pd, device))
            self.add_module(f"{s}_qknorm", QKNorm(cfg.head_dim, pd, device))
            self.add_module(f"{s}_proj", Dense(hr, h, True, pd, device))
            self.add_module(f"{s}_mlp1", Dense(h, mr, True, pd, device))
            self.add_module(f"{s}_mlp2", Dense(mr, h, True, pd, device))

    def _qkv(self, x, s):
        H = self.heads
        q, k, v = getattr(self, f"{s}_qkv")(x).chunk(3, dim=-1)
        q, k = getattr(self, f"{s}_qknorm")(_heads(q, H), _heads(k, H),
                                            self.dtype)
        return q, k, _heads(v, H)

    def _mlp(self, x, s, shift, scale, gate):
        h = _mod(_layer_norm(x, self.dtype), shift, scale)
        h = row_linear(getattr(self, f"{s}_mlp2"),
                       _gelu(getattr(self, f"{s}_mlp1")(h)), self.group)
        return x + gate * h

    def forward(self, img, txt, vec, cs):
        dt = self.dtype
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = modulation(self.img_mod,
                                                            vec, 2)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = modulation(self.txt_mod,
                                                            vec, 2)
        iq, ik, iv = self._qkv(_mod(_layer_norm(img, dt), i_sh1, i_sc1),
                               "img")
        tq, tk, tv = self._qkv(_mod(_layer_norm(txt, dt), t_sh1, t_sc1),
                               "txt")
        # joint attention over [txt; img] tokens
        q = apply_rope_2d(torch.cat([tq, iq], dim=1), cs)
        k = apply_rope_2d(torch.cat([tk, ik], dim=1), cs)
        v = torch.cat([tv, iv], dim=1)
        o = _attention(q, k, v)
        B, L = o.shape[:2]
        o = o.reshape(B, L, -1)
        Lt = txt.shape[1]
        t_attn, i_attn = o[:, :Lt], o[:, Lt:]
        img = img + i_g1 * row_linear(self.img_proj, i_attn, self.group)
        img = self._mlp(img, "img", i_sh2, i_sc2, i_g2)
        txt = txt + t_g1 * row_linear(self.txt_proj, t_attn, self.group)
        txt = self._mlp(txt, "txt", t_sh2, t_sc2, t_g2)
        return img, txt


class SingleBlock(nn.Module):
    """The fused stream block: one dense makes q, k, v and the MLP's input,
    one dense closes both; under ``group`` the rank's sections of each
    (module note)."""

    def __init__(self, cfg: FluxConfig, dtype, pd, device, group=None):
        super().__init__()
        self.cfg, self.dtype, self.group = cfg, dtype, group
        tp = group_size(group)
        self.heads = cfg.heads // tp
        h, m = cfg.hidden, cfg.mlp_ratio * cfg.hidden
        self.width = h // tp
        self.mod = Dense(h, 3 * h, True, pd, device)
        self.linear1 = Dense(h, 3 * self.width + m // tp, True, pd, device)
        self.linear2 = Dense(self.width + m // tp, h, True, pd, device)
        self.qknorm = QKNorm(cfg.head_dim, pd, device)

    def forward(self, x, vec, cs):
        shift, scale, gate = modulation(self.mod, vec, 1)
        h = self.linear1(_mod(_layer_norm(x, self.dtype), shift, scale))
        qkv, mlp = h[..., :3 * self.width], h[..., 3 * self.width:]
        q, k, v = (_heads(t, self.heads) for t in qkv.chunk(3, dim=-1))
        q, k = self.qknorm(q, k, self.dtype)
        o = _attention(apply_rope_2d(q, cs), apply_rope_2d(k, cs), v)
        B, L = o.shape[:2]
        h = row_linear(self.linear2, torch.cat(
            [o.reshape(B, L, self.width), _gelu(mlp)], dim=-1), self.group)
        return x + gate * h


class FluxTransformer(nn.Module):
    """``(img [B, Li, in_channels], txt [B, Lt, t5_dim], pooled [B,
    clip_dim], t [B], guidance [B], ids [B, Lt + Li, 3]) -> velocity [B,
    Li, in_channels]`` fp32. ``ids`` are the RoPE positions (text rows
    zero, image rows ``(0, y, x)``); ``t`` in [0, 1]; ``guidance`` is read
    only with ``guidance_embed``. ``device`` defaults to the card;
    ``"cpu"`` for the CPU. ``group``: one rank of the tensor-parallel
    transformer (module note)."""

    def __init__(self, cfg: FluxConfig, dtype=torch.bfloat16,
                 param_dtype=None, device: DeviceLike = None, group=None):
        super().__init__()
        check_tp(cfg, group_size(group))
        self.group = group
        if str(device) != "meta":
            device = resolve_device(device)
        pd = dtype if param_dtype is None else param_dtype
        self.cfg, self.dtype = cfg, dtype
        h = cfg.hidden
        self.img_in = Dense(cfg.in_channels, h, True, pd, device)
        self.txt_in = Dense(cfg.t5_dim, h, True, pd, device)
        self.time_in = MLPEmbedder(256, h, pd, device)
        self.vector_in = MLPEmbedder(cfg.clip_dim, h, pd, device)
        self.guidance_in = MLPEmbedder(256, h, pd, device) \
            if cfg.guidance_embed else None
        for i in range(cfg.n_double):
            self.add_module(f"double_{i}", DoubleBlock(cfg, dtype, pd, device,
                                                       group))
        for i in range(cfg.n_single):
            self.add_module(f"single_{i}", SingleBlock(cfg, dtype, pd, device,
                                                       group))
        self.final_mod = Dense(h, 2 * h, True, pd, device)
        self.final_proj = Dense(h, cfg.in_channels, True, pd, device)

    @property
    def device(self) -> torch.device:
        return self.img_in.weight.device

    def forward(self, img, txt, pooled, t, guidance, ids) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        img = self.img_in(img.to(dt))
        txt = self.txt_in(txt.to(dt))
        vec = self.time_in(timestep_embedding(t, 256).to(dt))
        vec = vec + self.vector_in(pooled.to(dt))
        if self.guidance_in is not None:
            vec = vec + self.guidance_in(
                timestep_embedding(guidance, 256).to(dt))
        cs = rope_freqs(ids, c.axes_dim, c.theta)
        for i in range(c.n_double):
            img, txt = getattr(self, f"double_{i}")(img, txt, vec, cs)
        x = torch.cat([txt, img], dim=1)
        for i in range(c.n_single):
            x = getattr(self, f"single_{i}")(x, vec, cs)
        x = x[:, txt.shape[1]:]
        # the final AdaLN and the projection back to patch channels
        shift, scale = self.final_mod(F.silu(vec))[:, None, :].chunk(2, -1)
        x = _mod(_layer_norm(x, dt), shift, scale)
        return self.final_proj(x).float()


# -- patchify and the RoPE ids ------------------------------------------------

def patchify(lat: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, C]`` latents -> ``[B, (h/2)(w/2), 4C]`` tokens of 2 x 2
    patches, features channel-major, in ``(c, ph, pw)`` order: the
    BFL/diffusers packed layout that pretrained ``img_in`` and
    ``final_proj`` weights index."""
    B, h, w, C = lat.shape
    x = lat.reshape(B, h // 2, 2, w // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, (h // 2) * (w // 2), 4 * C)


def unpatchify(tok: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``[B, (h/2)(w/2), 4C]`` channel-major tokens -> ``[B, h, w, C]``."""
    B, _, C4 = tok.shape
    x = tok.reshape(B, h // 2, w // 2, C4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, h, w, C4 // 4)


def make_ids(B: int, txt_len: int, h: int, w: int,
             device: DeviceLike = None) -> torch.Tensor:
    """RoPE ids ``[B, txt_len + (h/2)(w/2), 3]`` int32 on ``device`` (the
    card unless the caller asks for the CPU): text rows zero, image rows
    ``(0, y, x)``."""
    ys = torch.arange(h // 2, dtype=torch.int32).repeat_interleave(w // 2)
    xs = torch.arange(w // 2, dtype=torch.int32).repeat(h // 2)
    img = torch.stack([torch.zeros_like(ys), ys, xs], dim=-1)
    ids = torch.cat([torch.zeros((txt_len, 3), dtype=torch.int32), img])
    return ids[None].expand(B, -1, -1).contiguous().to(
        resolve_device(device))


# -- weights ------------------------------------------------------------------

def diffusers_plan(has: Callable[[str], bool]
                   ) -> Dict[str, Callable[[Callable[[str], Any]], Any]]:
    """How each BFL single-file tensor is made from a diffusers
    ``FluxTransformer2DModel`` state whose names satisfy ``has``: ``{bfl
    name: make(get)}``, ``get(name)`` reading one diffusers tensor when
    ``make`` runs (so a rank can read the checkpoint one BFL entry at a
    time). ``to_q``/``to_k``/``to_v`` fuse back into ``qkv`` (a single
    block's ``proj_mlp`` joins its ``linear1``), and ``norm_out.linear``
    swaps its ``[scale, shift]`` halves back to BFL's ``[shift,
    scale]``."""
    out: Dict[str, Callable[[Callable[[str], Any]], Any]] = {}

    def mv(dst: str, src: str) -> None:
        for suf in (".weight", ".bias"):
            if has(src + suf):
                out[dst + suf] = lambda get, s=src + suf: get(s)

    def fuse(dst: str, srcs) -> None:
        for suf in (".weight", ".bias"):
            parts = [s + suf for s in srcs if has(s + suf)]
            if parts:
                out[dst + suf] = lambda get, ps=tuple(parts): torch.cat(
                    [get(p) for p in ps], dim=0)

    def swapped(get, src):
        a, b = torch.chunk(get(src), 2, dim=0)
        return torch.cat([b, a], 0)

    mv("img_in", "x_embedder")
    mv("txt_in", "context_embedder")
    mv("time_in.in_layer", "time_text_embed.timestep_embedder.linear_1")
    mv("time_in.out_layer", "time_text_embed.timestep_embedder.linear_2")
    mv("vector_in.in_layer", "time_text_embed.text_embedder.linear_1")
    mv("vector_in.out_layer", "time_text_embed.text_embedder.linear_2")
    mv("guidance_in.in_layer", "time_text_embed.guidance_embedder.linear_1")
    mv("guidance_in.out_layer", "time_text_embed.guidance_embedder.linear_2")
    mv("final_layer.linear", "proj_out")
    for suf in (".weight", ".bias"):
        if has("norm_out.linear" + suf):
            out["final_layer.adaLN_modulation.1" + suf] = \
                lambda get, s="norm_out.linear" + suf: swapped(get, s)

    def same(dst: str, src: str) -> None:
        out[dst] = lambda get, s=src: get(s)

    i = 0
    while has(f"transformer_blocks.{i}.norm1.linear.weight"):
        s, d = f"transformer_blocks.{i}", f"double_blocks.{i}"
        mv(f"{d}.img_mod.lin", f"{s}.norm1.linear")
        mv(f"{d}.txt_mod.lin", f"{s}.norm1_context.linear")
        fuse(f"{d}.img_attn.qkv",
             [f"{s}.attn.to_q", f"{s}.attn.to_k", f"{s}.attn.to_v"])
        fuse(f"{d}.txt_attn.qkv", [f"{s}.attn.add_q_proj",
                                   f"{s}.attn.add_k_proj",
                                   f"{s}.attn.add_v_proj"])
        for side, q, k in (("img", "norm_q", "norm_k"),
                           ("txt", "norm_added_q", "norm_added_k")):
            same(f"{d}.{side}_attn.norm.query_norm.scale",
                 f"{s}.attn.{q}.weight")
            same(f"{d}.{side}_attn.norm.key_norm.scale",
                 f"{s}.attn.{k}.weight")
        mv(f"{d}.img_attn.proj", f"{s}.attn.to_out.0")
        mv(f"{d}.txt_attn.proj", f"{s}.attn.to_add_out")
        mv(f"{d}.img_mlp.0", f"{s}.ff.net.0.proj")
        mv(f"{d}.img_mlp.2", f"{s}.ff.net.2")
        mv(f"{d}.txt_mlp.0", f"{s}.ff_context.net.0.proj")
        mv(f"{d}.txt_mlp.2", f"{s}.ff_context.net.2")
        i += 1
    i = 0
    while has(f"single_transformer_blocks.{i}.norm.linear.weight"):
        s, d = f"single_transformer_blocks.{i}", f"single_blocks.{i}"
        mv(f"{d}.modulation.lin", f"{s}.norm.linear")
        fuse(f"{d}.linear1", [f"{s}.attn.to_q", f"{s}.attn.to_k",
                              f"{s}.attn.to_v", f"{s}.proj_mlp"])
        mv(f"{d}.linear2", f"{s}.proj_out")
        same(f"{d}.norm.query_norm.scale", f"{s}.attn.norm_q.weight")
        same(f"{d}.norm.key_norm.scale", f"{s}.attn.norm_k.weight")
        i += 1
    return out


def bfl_from_diffusers(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A diffusers ``FluxTransformer2DModel`` state dict (a FLUX.1
    snapshot's ``transformer/``) re-keyed into the BFL single-file names
    (:func:`diffusers_plan`). A pure key remap and concatenation: ``sd``
    is any mapping with ``in`` and ``[]``."""
    get = sd.__getitem__
    return {k: make(get) for k, make in
            diffusers_plan(lambda n: n in sd).items()}


#: diffusers' name of the guidance embedder's first layer (schnell has none)
DIFFUSERS_GUIDANCE = "time_text_embed.guidance_embedder.linear_1.weight"
#: BFL's
BFL_GUIDANCE = "guidance_in.in_layer.weight"


def is_diffusers_layout(keys: Iterable[str]) -> bool:
    return "x_embedder.weight" in set(keys)


def bfl_names(cfg: FluxConfig) -> Dict[str, str]:
    """This module's state name -> the BFL single-file key."""
    out: Dict[str, str] = {}

    def lin(port: str, bfl: str) -> None:
        out[f"{port}.weight"] = f"{bfl}.weight"
        out[f"{port}.bias"] = f"{bfl}.bias"

    def qk(port: str, bfl: str) -> None:
        out[f"{port}.q_scale"] = f"{bfl}.query_norm.scale"
        out[f"{port}.k_scale"] = f"{bfl}.key_norm.scale"

    lin("img_in", "img_in")
    lin("txt_in", "txt_in")
    embs = ("time_in", "vector_in") + (
        ("guidance_in",) if cfg.guidance_embed else ())
    for e in embs:
        lin(f"{e}.in_layer", f"{e}.in_layer")
        lin(f"{e}.out_layer", f"{e}.out_layer")
    lin("final_mod", "final_layer.adaLN_modulation.1")
    lin("final_proj", "final_layer.linear")
    for i in range(cfg.n_double):
        p, b = f"double_{i}", f"double_blocks.{i}"
        for s in ("img", "txt"):
            lin(f"{p}.{s}_mod", f"{b}.{s}_mod.lin")
            lin(f"{p}.{s}_qkv", f"{b}.{s}_attn.qkv")
            qk(f"{p}.{s}_qknorm", f"{b}.{s}_attn.norm")
            lin(f"{p}.{s}_proj", f"{b}.{s}_attn.proj")
            lin(f"{p}.{s}_mlp1", f"{b}.{s}_mlp.0")
            lin(f"{p}.{s}_mlp2", f"{b}.{s}_mlp.2")
    for i in range(cfg.n_single):
        p, b = f"single_{i}", f"single_blocks.{i}"
        lin(f"{p}.mod", f"{b}.modulation.lin")
        lin(f"{p}.linear1", f"{b}.linear1")
        lin(f"{p}.linear2", f"{b}.linear2")
        qk(f"{p}.qknorm", f"{b}.norm")
    return out


def config_for_keys(keys: Iterable[str],
                    base: Optional[FluxConfig] = None) -> FluxConfig:
    """``base`` (FLUX.1-dev's widths) with ``guidance_embed`` read off a
    checkpoint's keys: schnell is the one without a guidance embedder."""
    keys = set(keys)
    base = base or FluxConfig.flux_dev()
    return dataclasses.replace(base, guidance_embed=bool(
        {BFL_GUIDANCE, DIFFUSERS_GUIDANCE} & keys))


def state_items(get: Callable[[str], torch.Tensor], cfg: FluxConfig,
                keys: Optional[Iterable[str]] = None
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """The transformer's state as ``(name, tensor)`` entries from a BFL
    state dict, each read by ``get(name)`` when it is taken. Given the
    checkpoint's ``keys`` in the diffusers ``transformer/`` layout, each
    entry is made from its diffusers tensors through
    :func:`diffusers_plan` (a fused ``qkv`` reads its three parts, then
    lets them go). A missing tensor raises, naming it (before any is read
    when ``keys`` are given)."""
    names = bfl_names(cfg)
    read = get
    known = None if keys is None else set(keys)
    if known is not None and is_diffusers_layout(known):
        plan = diffusers_plan(known.__contains__)
        known = set(plan)

        def read(src):
            return plan[src](get)
    if known is not None:
        for name, src in names.items():
            if src not in known:
                raise ValueError(f"Flux checkpoint has no {src!r} (for "
                                 f"{name})")

    def entries():
        for name, src in names.items():
            try:
                t = read(src)
            except KeyError:
                raise ValueError(f"Flux checkpoint has no {src!r} "
                                 f"(for {name})") from None
            yield name, t

    return entries()


def state_from_bfl(get: Callable[[str], torch.Tensor], cfg: FluxConfig,
                   keys: Optional[Iterable[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The transformer's state from a BFL state dict (or, given
    ``keys`` in the diffusers layout, a diffusers one): ``get(name)``
    returns one tensor (:func:`state_items`). A missing tensor raises,
    naming it."""
    return dict(state_items(get, cfg, keys))


def tp_rules(cfg: Optional[FluxConfig] = None) -> ShardingRules:
    """The reference's ``tp_rules`` (``flux.py:312``) over this module's
    names (``[out, in]`` weights: column-parallel splits dim 0,
    row-parallel dim 1), each weight split on the dim the reference
    splits: the fused qkv and the first MLP half on their outputs, the
    attention projection and the second half on their inputs. What the
    reference's GSPMD does for free a rank's forward needs here: the fused
    weights are cut per section (``qkv`` q | k | v, ``linear1`` q | k | v
    | mlp, ``linear2``'s inputs attn | mlp, the MLP at ``cfg``'s
    ``mlp_ratio``), and each column-parallel bias splits with its output
    where the reference replicates it; a row-parallel bias stays whole
    (added once, after the all-reduce). The embedders, modulations, norms
    and the final layer are replicated."""
    r = (cfg or FluxConfig()).mlp_ratio
    return ShardingRules([
        (r"(img|txt)_qkv\.(weight|bias)", sectioned(0, 1, 1, 1)),
        (r"(img|txt)_proj\.weight", row_parallel()),
        (r"(img|txt)_mlp1\.(weight|bias)", column_parallel()),
        (r"(img|txt)_mlp2\.weight", row_parallel()),
        (r"single_\d+\.linear1\.(weight|bias)", sectioned(0, 1, 1, 1, r)),
        (r"single_\d+\.linear2\.weight", sectioned(1, 1, r)),
        (r"(time_in|vector_in|guidance_in)\.(in|out)_layer\.weight",
         replicated()),
        (r".*", replicated()),
    ])


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of ``FluxTransformer``
    (numpy leaves) -> this module's state dict (``q_scale``/``k_scale``
    keep their names)."""
    return state_from_flax(tree)


def build(cfg: FluxConfig, state: Dict[str, torch.Tensor],
          dtype=torch.bfloat16, group=None) -> FluxTransformer:
    """The transformer around ``state`` (built on the meta device, the
    tensors assigned: no second copy), computing in ``dtype``; under
    ``group``, ``state`` is the rank's shard."""
    m = FluxTransformer(cfg, dtype=dtype, device="meta", group=group)
    m.load_state_dict(state, assign=True, strict=True)
    return m


def seeded(cfg: FluxConfig, seed: int, dtype=torch.bfloat16,
           param_dtype=None, device: DeviceLike = None) -> FluxTransformer:
    """Random weights drawn on the device (``encoder.seeded_init_``), the
    q/k norm scales 1."""
    m = seeded_init_(FluxTransformer(cfg, dtype=dtype, param_dtype=param_dtype,
                                     device=device), seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, QKNorm):
                mod.q_scale.fill_(1.0)
                mod.k_scale.fill_(1.0)
    return m
