"""UNet2DConditionModel, the SD denoiser.

Port of ``scalable_hw_agnostic_inference_tpu/models/unet.py``
(``UNetConfig``, ``timestep_embedding``, ``ResBlock``, ``CrossAttention``,
``TransformerBlock``, ``Transformer2D``, ``UNet2DCondition``,
``params_from_torch``). The modules carry the JAX tree's names
(``down_{i}_res_{j}``, ``down_{i}_attn_{j}``, ``mid_attn``,
``up_{i}_conv``, ...), so :func:`params_from_jax` is a rename, and
:func:`state_from_diffusers` maps the diffusers ``UNet2DConditionModel``
keys onto them.

The public surface is the reference's NHWC (``sample [B, H, W, C]`` in,
``[B, H, W, C_out]`` f32 out); inside it runs NCHW. A transformer's tokens
are the pixels row by row, as the reference flattens them, and
GroupNorm's groups the same runs of consecutive channels. Dtypes follow
the reference: the timestep MLP, GroupNorm, LayerNorm and ``conv_out`` in
fp32, every other convolution and dense in the compute ``dtype`` (bf16 on
the card), the output fp32. Two choices of the reference are kept where
diffusers differs (ROADMAP C): GEGLU's GELU is the tanh approximation
(flax's ``nn.gelu`` default; diffusers' is exact) and every norm's epsilon
is flax's 1e-6 (diffusers' resnets and LayerNorms use 1e-5).

Every self- and cross-attention goes through
``ops.attention.dot_product_attention``: on a CUDA tensor that is the B1
kernel, two launches for each transformer block (32 a forward at SD2.x's
16 blocks); heads of a size outside B1's (SD1.x's 40, 80 and 160) raise
there.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device
from ..ops.attention import dot_product_attention
from .encoder import Conv2d, Dense, GroupNorm, LayerNorm, state_from_flax
from .vae import tokens, untokens, upsample2x

#: flax's LayerNorm and GroupNorm epsilon, which the reference keeps
EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attn_heads: Tuple[int, ...] = (5, 10, 20, 20)   # per resolution level
    cross_attn: Tuple[bool, ...] = (True, True, True, False)  # down order
    norm_groups: int = 32
    transformer_layers: int = 1

    @property
    def time_embed_dim(self) -> int:
        return self.block_out[0] * 4

    def head_dims(self) -> Tuple[int, ...]:
        """The attention head size of each level that has attention."""
        return tuple(ch // h for ch, h, a in zip(
            self.block_out, self.attn_heads, self.cross_attn) if a)

    @classmethod
    def sd21(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls(cross_attention_dim=768, attn_heads=(8, 8, 8, 8))

    @classmethod
    def tiny(cls) -> "UNetConfig":
        # cross_attention_dim is ClipTextConfig.tiny().dim: the tiny
        # serving tier wires the real text encoder end to end
        return cls(block_out=(8, 16), layers_per_block=1,
                   cross_attention_dim=32, attn_heads=(2, 2),
                   cross_attn=(True, False), norm_groups=4)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "UNetConfig":
        block_out = tuple(hf.get("block_out_channels", (320, 640, 1280, 1280)))
        # diffusers' naming quirk: "attention_head_dim" holds the NUMBER OF
        # HEADS per level (SD2.x [5, 10, 20, 20]: 5 heads of 64 at 320
        # channels; SD1.x's scalar 8: 8 heads of 40)
        ahd = hf.get("attention_head_dim", 8)
        if isinstance(ahd, (list, tuple)):
            heads = tuple(int(h) for h in ahd)
        else:
            heads = tuple(int(ahd) for _ in block_out)
        down = hf.get("down_block_types",
                      ("CrossAttnDownBlock2D",) * (len(block_out) - 1)
                      + ("DownBlock2D",))
        return cls(
            in_channels=hf.get("in_channels", 4),
            out_channels=hf.get("out_channels", 4),
            block_out=block_out,
            layers_per_block=hf.get("layers_per_block", 2),
            cross_attention_dim=hf.get("cross_attention_dim", 1024),
            attn_heads=heads,
            cross_attn=tuple(t.startswith("CrossAttn") for t in down),
            norm_groups=hf.get("norm_num_groups", 32),
            transformer_layers=hf.get("transformer_layers_per_block", 1),
        )


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """``[B]`` timesteps -> ``[B, dim]`` sinusoidal features (fp32)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class ResBlock(nn.Module):
    """GN-SiLU-conv twice, the time embedding added between the convs."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int,
                 dtype, pd, device):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(groups, in_ch, pd, device, EPS)
        self.conv1 = Conv2d(in_ch, out_ch, 3, dtype, device, pd)
        self.time_emb = Dense(temb_dim, out_ch, True, pd, device)
        self.norm2 = GroupNorm(groups, out_ch, pd, device, EPS)
        self.conv2 = Conv2d(out_ch, out_ch, 3, dtype, device, pd)
        self.shortcut = Conv2d(in_ch, out_ch, 1, dtype, device, pd) \
            if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dt))
        h = h + self.time_emb(F.silu(temb).to(dt))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)).to(dt))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return (x + h).to(dt)


class CrossAttention(nn.Module):
    """Self-attention (``context`` None) or cross-attention over
    ``context``, ``heads`` heads of ``dim / heads``."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, pd, device):
        super().__init__()
        self.heads = heads
        self.q = Dense(dim, dim, False, pd, device)
        self.k = Dense(ctx_dim, dim, False, pd, device)
        self.v = Dense(ctx_dim, dim, False, pd, device)
        self.o = Dense(dim, dim, True, pd, device)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, C = x.shape
        ctx = x if context is None else context
        S, Dh = ctx.shape[1], C // self.heads
        q = self.q(x).reshape(B, T, self.heads, Dh)
        k = self.k(ctx).reshape(B, S, self.heads, Dh)
        v = self.v(ctx).reshape(B, S, self.heads, Dh)
        o = dot_product_attention(q, k, v).reshape(B, T, C)
        return self.o(o)


class TransformerBlock(nn.Module):
    """LN -> self-attention, LN -> cross-attention, LN -> GEGLU feed-forward
    (diffusers' basic block)."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, dtype, pd,
                 device):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, EPS, pd, device)
        self.attn1 = CrossAttention(dim, dim, heads, pd, device)
        self.norm2 = LayerNorm(dim, EPS, pd, device)
        self.attn2 = CrossAttention(dim, ctx_dim, heads, pd, device)
        self.norm3 = LayerNorm(dim, EPS, pd, device)
        self.ff_in = Dense(dim, dim * 8, True, pd, device)
        self.ff_out = Dense(dim * 4, dim, True, pd, device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x + self.attn1(self.norm1(x, dt), None)
        x = x + self.attn2(self.norm2(x, dt), context)
        val, gate = self.ff_in(self.norm3(x, dt)).chunk(2, dim=-1)
        return x + self.ff_out(val * F.gelu(gate, approximate="tanh"))


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> proj_in -> blocks -> proj_out, residual."""

    def __init__(self, ch: int, ctx_dim: int, heads: int, n_layers: int,
                 groups: int, dtype, pd, device):
        super().__init__()
        self.dtype, self.n_layers = dtype, n_layers
        self.norm = GroupNorm(groups, ch, pd, device, EPS)
        self.proj_in = Dense(ch, ch, True, pd, device)
        for i in range(n_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                ch, ctx_dim, heads, dtype, pd, device))
        self.proj_out = Dense(ch, ch, True, pd, device)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2], x.shape[3]
        h = self.proj_in(tokens(self.norm(x)).to(self.dtype))
        for i in range(self.n_layers):
            h = getattr(self, f"block_{i}")(h, context)
        return x + untokens(self.proj_out(h), H, W)


class UNet2DCondition(nn.Module):
    """``sample [B, H, W, C_in]``, ``timesteps [B]``, ``context [B, L,
    ctx]`` -> ``[B, H, W, C_out]`` f32. ``device`` defaults to the card;
    ``"cpu"`` for the CPU."""

    def __init__(self, cfg: UNetConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device: DeviceLike = None):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        pd, g, td = param_dtype, cfg.norm_groups, cfg.time_embed_dim
        n = len(cfg.block_out)
        ctx = cfg.cross_attention_dim

        def res(name, cin, cout):
            self.add_module(name, ResBlock(cin, cout, td, g, dtype, pd,
                                           device))

        def xf(name, ch, heads):
            self.add_module(name, Transformer2D(
                ch, ctx, heads, cfg.transformer_layers, g, dtype, pd,
                device))

        self.time_embed_1 = Dense(cfg.block_out[0], td, True, pd, device)
        self.time_embed_2 = Dense(td, td, True, pd, device)
        self.conv_in = Conv2d(cfg.in_channels, cfg.block_out[0], 3, dtype,
                              device, pd)
        skips: List[int] = [cfg.block_out[0]]
        ch_in = cfg.block_out[0]
        for i, ch in enumerate(cfg.block_out):
            for j in range(cfg.layers_per_block):
                res(f"down_{i}_res_{j}", ch_in, ch)
                ch_in = ch
                if cfg.cross_attn[i]:
                    xf(f"down_{i}_attn_{j}", ch, cfg.attn_heads[i])
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_conv", Conv2d(
                    ch, ch, 3, dtype, device, pd, stride=2))
                skips.append(ch)
        mid = cfg.block_out[-1]
        res("mid_res_0", ch_in, mid)
        xf("mid_attn", mid, cfg.attn_heads[-1])
        res("mid_res_1", mid, mid)
        ch_in = mid
        for i, ch in enumerate(reversed(cfg.block_out)):
            level = n - 1 - i
            for j in range(cfg.layers_per_block + 1):
                res(f"up_{i}_res_{j}", ch_in + skips.pop(), ch)
                ch_in = ch
                if cfg.cross_attn[level]:
                    xf(f"up_{i}_attn_{j}", ch, cfg.attn_heads[level])
            if i < n - 1:
                self.add_module(f"up_{i}_conv",
                                Conv2d(ch, ch, 3, dtype, device, pd))
        self.norm_out = GroupNorm(g, cfg.block_out[0], pd, device, EPS)
        self.conv_out = Conv2d(cfg.block_out[0], cfg.out_channels, 3,
                               torch.float32, device, pd)

    @property
    def device(self) -> torch.device:
        return self.conv_in.weight.device

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        n = len(cfg.block_out)
        context = context.to(dt)
        temb = timestep_embedding(timesteps, cfg.block_out[0])
        temb = self.time_embed_2(F.silu(self.time_embed_1(temb))).to(dt)

        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if cfg.cross_attn[i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, context)
                skips.append(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_conv")(h)
                skips.append(h)
        h = self.mid_res_0(h, temb)
        h = self.mid_attn(h, context)
        h = self.mid_res_1(h, temb)
        for i in range(n):
            level = n - 1 - i
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_res_{j}")(h, temb)
                if cfg.cross_attn[level]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, context)
            if i < n - 1:
                h = getattr(self, f"up_{i}_conv")(upsample2x(h))
        out = self.conv_out(F.silu(self.norm_out(h)))
        return out.float().permute(0, 2, 3, 1)


# -- weights -------------------------------------------------------------------

def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of ``UNet2DCondition``
    (numpy leaves) -> this module's state dict."""
    return state_from_flax(tree)


def build(cfg: UNetConfig, state: Dict[str, torch.Tensor],
          dtype=torch.bfloat16) -> UNet2DCondition:
    """The UNet around ``state`` (built on the meta device, the tensors
    assigned: no second copy), computing in ``dtype``."""
    m = UNet2DCondition(cfg, dtype=dtype, device="meta")
    m.load_state_dict(state, assign=True, strict=True)
    return m


_TOP = ((re.compile(r"down_(\d+)_res_(\d+)$"), r"down_blocks.\1.resnets.\2"),
        (re.compile(r"down_(\d+)_attn_(\d+)$"),
         r"down_blocks.\1.attentions.\2"),
        (re.compile(r"down_(\d+)_conv$"), r"down_blocks.\1.downsamplers.0.conv"),
        (re.compile(r"up_(\d+)_res_(\d+)$"), r"up_blocks.\1.resnets.\2"),
        (re.compile(r"up_(\d+)_attn_(\d+)$"), r"up_blocks.\1.attentions.\2"),
        (re.compile(r"up_(\d+)_conv$"), r"up_blocks.\1.upsamplers.0.conv"),
        (re.compile(r"block_(\d+)$"), r"transformer_blocks.\1"))

_SEGMENT = {"time_embed_1": "time_embedding.linear_1",
            "time_embed_2": "time_embedding.linear_2",
            "mid_res_0": "mid_block.resnets.0",
            "mid_attn": "mid_block.attentions.0",
            "mid_res_1": "mid_block.resnets.1",
            "norm_out": "conv_norm_out", "time_emb": "time_emb_proj",
            "shortcut": "conv_shortcut", "q": "to_q", "k": "to_k",
            "v": "to_v", "o": "to_out.0", "ff_in": "ff.net.0.proj",
            "ff_out": "ff.net.2"}


def diffusers_name(port_name: str) -> str:
    """This module's state name -> the diffusers ``UNet2DConditionModel``
    key."""
    out = []
    for seg in port_name.split("."):
        for pat, rep in _TOP:
            if pat.match(seg):
                seg = pat.sub(rep, seg)
                break
        else:
            seg = _SEGMENT.get(seg, seg)
        out.append(seg)
    return ".".join(out)


def state_from_diffusers(get: Callable[[str], torch.Tensor], keys,
                         cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """The UNet's state from a diffusers ``UNet2DConditionModel`` state
    dict: ``get(name)`` returns one tensor, ``keys`` are its names.
    ``proj_in``/``proj_out`` are linear (SD2.x) or 1x1 convolutions
    (SD1.x)."""
    keys = set(keys)
    out = {}
    for name in UNet2DCondition(cfg, device="meta").state_dict():
        src = diffusers_name(name)
        if src not in keys:
            raise ValueError(f"UNet checkpoint has no {src!r} (for {name})")
        t = get(src)
        if t.ndim == 4 and name.split(".")[-2] in ("proj_in", "proj_out"):
            t = t[:, :, 0, 0]
        out[name] = t
    return out
