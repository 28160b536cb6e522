"""AutoencoderKL, the SD VAE.

Port of ``scalable_hw_agnostic_inference_tpu/models/vae.py``
(``VAEConfig``, ``ResnetBlock``, ``SpatialAttention``, ``MidBlock``,
``Decoder``, ``Encoder``, ``AutoencoderKL`` with ``decode`` and
``encode``, the diffusers converter). GroupNorm + SiLU resnet stacks,
single-head spatial attention in the mid blocks, nearest 2x upsampling.

The reference is NHWC throughout; the port's public surface is too
(``decode(z [B, h, w, latent]) -> [B, H, W, 3]``, ``encode(x [B, H, W, 3])
-> (mean, logvar) [B, h, w, latent]``), and it runs NCHW inside. A spatial
attention's tokens are the pixels row by row (``h * W + w``), as the
reference's ``reshape(B, H * W, C)`` orders them, and GroupNorm's groups
are the same runs of consecutive channels.

Dtypes follow the reference: GroupNorm in fp32, convolutions and denses in
the compute ``dtype`` (bf16), the 1x1 ``post_quant``/``quant`` denses and
both ``conv_out`` in fp32. ``SpatialAttention`` is one head of ``C``
(512 at SD's width) over ``H * W`` tokens: the reference computes it with
``einsum`` outside any Pallas kernel, and ``C`` is outside B1's head sizes,
so it stays ``torch.matmul`` and softmax here (scores in fp32, as the
reference's ``preferred_element_type`` keeps them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import DeviceLike, resolve_device
from .encoder import Conv2d, Dense, GroupNorm, state_from_flax


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    use_quant_conv: bool = True

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out=(8, 16), layers_per_block=1, norm_groups=4,
                   scaling_factor=0.18215)

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "VAEConfig":
        return cls(
            in_channels=hf.get("in_channels", 3),
            latent_channels=hf.get("latent_channels", 4),
            block_out=tuple(hf.get("block_out_channels",
                                   (128, 256, 512, 512))),
            layers_per_block=hf.get("layers_per_block", 2),
            norm_groups=hf.get("norm_num_groups", 32),
            scaling_factor=hf.get("scaling_factor", 0.18215),
            shift_factor=hf.get("shift_factor") or 0.0,
            use_quant_conv=hf.get("use_quant_conv", True),
        )


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsampling of an NCHW tensor (each pixel
    repeated into a 2 x 2 block, the reference's ``_upsample2x``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> ``[B, H * W, C]``, pixels row by row."""
    return x.flatten(2).transpose(1, 2)


def untokens(h: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``[B, H * W, C]`` -> NCHW."""
    return h.transpose(1, 2).reshape(h.shape[0], -1, H, W)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, dtype, pd,
                 device):
        super().__init__()
        self.dtype = dtype
        self.norm1 = GroupNorm(groups, in_ch, pd, device)
        self.conv1 = Conv2d(in_ch, out_ch, 3, dtype, device, pd)
        self.norm2 = GroupNorm(groups, out_ch, pd, device)
        self.conv2 = Conv2d(out_ch, out_ch, 3, dtype, device, pd)
        self.shortcut = Conv2d(in_ch, out_ch, 1, dtype, device, pd) \
            if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dt))
        h = self.conv2(F.silu(self.norm2(h)).to(dt))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return (x + h).to(dt)


class SpatialAttention(nn.Module):
    """Single-head attention over the ``H * W`` pixels."""

    def __init__(self, ch: int, groups: int, dtype, pd, device):
        super().__init__()
        self.dtype = dtype
        self.norm = GroupNorm(groups, ch, pd, device)
        for n in ("q", "k", "v", "o"):
            setattr(self, n, Dense(ch, ch, True, pd, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = tokens(self.norm(x)).to(self.dtype)
        q, k, v = self.q(h), self.k(h), self.v(h)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) / (C ** 0.5)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = self.o(torch.matmul(p, v))
        return (x + untokens(o, H, W)).to(self.dtype)


class MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, dtype, pd, device):
        super().__init__()
        self.res1 = ResnetBlock(ch, ch, groups, dtype, pd, device)
        self.attn = SpatialAttention(ch, groups, dtype, pd, device)
        self.res2 = ResnetBlock(ch, ch, groups, dtype, pd, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res2(self.attn(self.res1(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype, pd, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        g = cfg.norm_groups
        rev = tuple(reversed(cfg.block_out))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, dtype, device,
                              pd)
        self.mid = MidBlock(rev[0], g, dtype, pd, device)
        ch_in = rev[0]
        for i, ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(
                    ch_in, ch, g, dtype, pd, device))
                ch_in = ch
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_conv",
                                Conv2d(ch, ch, 3, dtype, device, pd))
        self.norm_out = GroupNorm(g, rev[-1], pd, device)
        # the RGB projection in fp32: 3 output channels, and the [-1, 1]
        # image stays exact for the uint8 quantization
        self.conv_out = Conv2d(rev[-1], cfg.in_channels, 3, torch.float32,
                               device, pd)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.mid(self.conv_in(z))
        n = len(cfg.block_out)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_conv")(upsample2x(h))
        return self.conv_out(F.silu(self.norm_out(h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype, pd, device):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        g = cfg.norm_groups
        bo = cfg.block_out
        self.conv_in = Conv2d(cfg.in_channels, bo[0], 3, dtype, device, pd)
        ch_in = bo[0]
        for i, ch in enumerate(bo):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(
                    ch_in, ch, g, dtype, pd, device))
                ch_in = ch
            if i < len(bo) - 1:
                # diffusers pads (0, 1, 0, 1), then a stride-2 VALID conv
                self.add_module(f"down_{i}_conv", Conv2d(
                    ch, ch, 3, dtype, device, pd, stride=2, padding=0))
        self.mid = MidBlock(bo[-1], g, dtype, pd, device)
        self.norm_out = GroupNorm(g, bo[-1], pd, device)
        self.conv_out = Conv2d(bo[-1], 2 * cfg.latent_channels, 3,
                               torch.float32, device, pd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.conv_in(x)
        n = len(cfg.block_out)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_conv")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """``decode(z) -> image in [-1, 1]``; ``encode(x) -> (mean, logvar)``.
    ``device`` defaults to the card; ``"cpu"`` for the CPU. Without
    ``encoder`` only the decoding half is built (a serving pod never
    encodes)."""

    def __init__(self, cfg: VAEConfig, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device: DeviceLike = None,
                 encoder: bool = True):
        super().__init__()
        if str(device) != "meta":
            device = resolve_device(device)
        self.cfg, self.dtype = cfg, dtype
        pd = param_dtype
        lc = cfg.latent_channels
        self.decoder = Decoder(cfg, dtype, pd, device)
        self.encoder = Encoder(cfg, dtype, pd, device) if encoder else None
        if cfg.use_quant_conv:
            self.post_quant = Dense(lc, lc, True, pd, device)
            self.quant = Dense(2 * lc, 2 * lc, True, pd, device) \
                if encoder else None

    @property
    def device(self) -> torch.device:
        return self.decoder.conv_in.weight.device

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``z [B, h, w, latent]`` scaled latents -> ``[B, H, W, 3]`` f32:
        un-scale, un-shift, ``post_quant``, decode."""
        z = z.float() / self.cfg.scaling_factor + self.cfg.shift_factor
        if self.cfg.use_quant_conv:
            z = self.post_quant(z)
        return self.decoder(z.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode_uint8(self, z: torch.Tensor) -> torch.Tensor:
        """:meth:`decode`, then [-1, 1] -> uint8 on the device (the
        pipelines' one small transfer back)."""
        img = torch.clamp(self.decode(z) * 127.5 + 127.5, 0.0, 255.0)
        return torch.round(img).to(torch.uint8)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x [B, H, W, 3]`` -> ``(mean, logvar)`` ``[B, h, w, latent]``,
        ``logvar`` clipped to [-30, 20]."""
        if self.encoder is None:
            raise ValueError("this AutoencoderKL was built without its "
                             "encoder")
        m = self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.cfg.use_quant_conv:
            m = self.quant(m)
        mean, logvar = m.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)


# -- weights -------------------------------------------------------------------

def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params": ...}`` tree of ``AutoencoderKL``
    (numpy leaves; with or without its encoder half) -> this module's
    state dict."""
    return state_from_flax(tree)


def build(cfg: VAEConfig, state: Dict[str, torch.Tensor],
          dtype=torch.bfloat16) -> AutoencoderKL:
    """The VAE around ``state`` (built on the meta device, the tensors
    assigned), with its encoder when ``state`` holds one."""
    m = AutoencoderKL(cfg, dtype=dtype, device="meta",
                      encoder="encoder.conv_in.weight" in state)
    m.load_state_dict(state, assign=True, strict=True)
    return m


def _resnet_names(port: str, hf: str, has_shortcut: bool) -> Dict[str, str]:
    out = {}
    for n in ("norm1", "conv1", "norm2", "conv2"):
        for leaf in ("weight", "bias"):
            out[f"{port}.{n}.{leaf}"] = f"{hf}.{n}.{leaf}"
    if has_shortcut:
        for leaf in ("weight", "bias"):
            out[f"{port}.shortcut.{leaf}"] = f"{hf}.conv_shortcut.{leaf}"
    return out


def _conv_names(port: str, hf: str) -> Dict[str, str]:
    return {f"{port}.{leaf}": f"{hf}.{leaf}" for leaf in ("weight", "bias")}


def _mid_names(port: str, hf: str, keys) -> Dict[str, str]:
    a = f"{hf}.attentions.0"
    # modern diffusers: to_q/to_k/to_v/to_out.0; older: query/key/value/
    # proj_attn
    names = (("to_q", "to_k", "to_v", "to_out.0")
             if f"{a}.to_q.weight" in keys
             else ("query", "key", "value", "proj_attn"))
    out = {**_resnet_names(f"{port}.res1", f"{hf}.resnets.0", False),
           **_resnet_names(f"{port}.res2", f"{hf}.resnets.1", False),
           **_conv_names(f"{port}.attn.norm", f"{a}.group_norm")}
    for n, src in zip(("q", "k", "v", "o"), names):
        out.update(_conv_names(f"{port}.attn.{n}", f"{a}.{src}"))
    return out


def diffusers_names(cfg: VAEConfig, keys) -> Dict[str, str]:
    """This module's state name -> the diffusers ``AutoencoderKL`` key."""
    keys = set(keys)
    rev = tuple(reversed(cfg.block_out))
    out = {**_conv_names("decoder.conv_in", "decoder.conv_in"),
           **_mid_names("decoder.mid", "decoder.mid_block", keys),
           **_conv_names("decoder.norm_out", "decoder.conv_norm_out"),
           **_conv_names("decoder.conv_out", "decoder.conv_out")}
    ch_in = rev[0]
    for i, ch in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            out.update(_resnet_names(f"decoder.up_{i}_res_{j}",
                                     f"decoder.up_blocks.{i}.resnets.{j}",
                                     ch_in != ch))
            ch_in = ch
        if i < len(rev) - 1:
            out.update(_conv_names(
                f"decoder.up_{i}_conv",
                f"decoder.up_blocks.{i}.upsamplers.0.conv"))
    if "encoder.conv_in.weight" in keys:
        bo = cfg.block_out
        out.update({**_conv_names("encoder.conv_in", "encoder.conv_in"),
                    **_mid_names("encoder.mid", "encoder.mid_block", keys),
                    **_conv_names("encoder.norm_out",
                                  "encoder.conv_norm_out"),
                    **_conv_names("encoder.conv_out", "encoder.conv_out")})
        ch_in = bo[0]
        for i, ch in enumerate(bo):
            for j in range(cfg.layers_per_block):
                out.update(_resnet_names(
                    f"encoder.down_{i}_res_{j}",
                    f"encoder.down_blocks.{i}.resnets.{j}", ch_in != ch))
                ch_in = ch
            if i < len(bo) - 1:
                out.update(_conv_names(
                    f"encoder.down_{i}_conv",
                    f"encoder.down_blocks.{i}.downsamplers.0.conv"))
        if cfg.use_quant_conv:
            out.update(_conv_names("quant", "quant_conv"))
    if cfg.use_quant_conv:
        out.update(_conv_names("post_quant", "post_quant_conv"))
    return out


def state_from_diffusers(get: Callable[[str], torch.Tensor], keys,
                         cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """The VAE's state from a diffusers ``AutoencoderKL`` state dict:
    ``get(name)`` returns one tensor, ``keys`` are its names. The 1x1
    convolutions that stand for denses (``post_quant_conv``,
    ``quant_conv``, old checkpoints' attention projections) lose their
    spatial dimensions."""
    out = {}
    for name, src in diffusers_names(cfg, keys).items():
        t = get(src)
        if name.endswith("weight") and t.ndim == 4 and (
                name.split(".")[-2] in ("q", "k", "v", "o")
                or name.startswith(("post_quant", "quant"))):
            t = t[:, :, 0, 0]
        out[name] = t
    return out
