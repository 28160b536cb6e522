"""Transformer-encoder building blocks: DistilBERT, ViT and YOLOS
(``models/bert.py``, ``vit.py``, ``yolos.py``), the CLIP tower of the
soft-prefix VLM (``models/vlm.py``), CLIP's causal text encoder
(``models/clip.py``) and the dense and LayerNorm layers mllama's vision
model, the UNet and the VAE share.

Port of ``scalable_hw_agnostic_inference_tpu/models/encoder.py``
(``ACTIVATIONS``, ``SelfAttention``, ``EncoderBlock``, ``Encoder``,
``attention_mask_2d``): pre-LN (ViT, CLIP) or post-LN (DistilBERT),
causal or not, with a ``[B, S]`` key-validity mask. The modules' names map
one to one onto the JAX tree: ``layer_{i}``, ``attn.{q,k,v,o}``, ``ln1``,
``ln2``, ``fc1``, ``fc2``. A flax ``Dense`` kernel ``[in, out]`` is held as
``weight [out, in]`` (the HF layout), a ``LayerNorm`` ``scale`` as
``weight``.

Attention goes through ``ops.attention.dot_product_attention``: on a CUDA
tensor that is the B1 kernel (bf16), on the CPU the plain path. The
reference passes its mask as a ``[B, 1, 1, S]`` boolean
(``attention_mask_2d``); here a right-padded mask (each row's valid keys a
prefix) becomes B1's per-row key ``lengths`` (:func:`key_lengths`). A mask
that is not a prefix takes the masked plain path on the CPU and raises on
the card, where attention runs only through B1. B1 takes bf16 only, so an
encoder computing in fp32 (the text encoder) rounds q, k and v to bf16 at
the call on the card and takes the output back to fp32; on the CPU it
stays fp32, as the reference computes. Parameters are held in
``param_dtype`` and cast to the compute ``dtype`` at use, as flax casts
them; LayerNorms compute in fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.attention import dot_product_attention

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": lambda x: nn.functional.gelu(x),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def param(shape, dtype, device, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """A dense layer ``x @ W^T (+ b)`` in ``x``'s dtype (``weight [out,
    in]``, the HF layout)."""

    def __init__(self, n_in: int, n_out: int, bias: bool, dtype, device):
        super().__init__()
        self.weight = param((n_out, n_in), dtype, device)
        self.bias = param((n_out,), dtype, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return nn.functional.linear(x, self.weight.to(x.dtype), b)


def row_linear(layer: Dense, x: torch.Tensor, group=None) -> torch.Tensor:
    """``layer`` as a row-parallel dense over ``group``'s ranks: the
    rank's partial product over its slice of the inputs, all-reduced, and
    the whole bias added once, after the sum. A group of one (or none)
    runs ``layer`` itself, its bias fused as on one device (the all-reduce
    of one rank is its identity)."""
    if group is None or group.size == 1:
        out = layer(x)
        return out if group is None else group.all_reduce(out)
    out = group.all_reduce(
        nn.functional.linear(x, layer.weight.to(x.dtype)))
    return out if layer.bias is None else out + layer.bias.to(out.dtype)


class Embed(nn.Module):
    """An embedding table ``weight [n, dim]`` (flax ``Embed``'s
    ``embedding``), looked up in its own dtype."""

    def __init__(self, n: int, dim: int, dtype, device):
        super().__init__()
        self.weight = param((n, dim), dtype, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]


class LayerNorm(nn.Module):
    """LayerNorm in fp32, cast to ``out_dtype`` (flax ``LayerNorm``
    computes its statistics in fp32 and returns its ``dtype``)."""

    is_norm = True

    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = param((dim,), dtype, device, 1.0)
        self.bias = param((dim,), dtype, device)

    def forward(self, x: torch.Tensor, out_dtype) -> torch.Tensor:
        return nn.functional.layer_norm(
            x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
            self.eps).to(out_dtype)


class GroupNorm(nn.Module):
    """flax ``GroupNorm(groups, dtype=float32)`` over an NCHW tensor:
    statistics over each group of ``channels / groups`` consecutive
    channels and every pixel, in fp32, returning fp32 (flax's default
    epsilon, 1e-6)."""

    is_norm = True

    def __init__(self, groups: int, channels: int, dtype, device,
                 eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = param((channels,), dtype, device, 1.0)
        self.bias = param((channels,), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.group_norm(x.float(), self.groups,
                                        self.weight.float(),
                                        self.bias.float(), self.eps)


class Conv2d(nn.Module):
    """A square convolution computing in ``dtype`` (parameters cast in, as
    flax's ``Conv(dtype=...)`` casts them) over an NCHW tensor; ``weight
    [out, in, k, k]`` (the torch layout; flax's kernel is ``[k, k, in,
    out]``). ``padding`` defaults to ``k // 2`` on every side."""

    def __init__(self, n_in: int, n_out: int, k: int, dtype, device,
                 param_dtype=None, stride: int = 1, padding=None):
        super().__init__()
        self.dtype, self.stride = dtype, stride
        self.padding = k // 2 if padding is None else padding
        pd = dtype if param_dtype is None else param_dtype
        self.weight = param((n_out, n_in, k, k), pd, device)
        self.bias = param((n_out,), pd, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return nn.functional.conv2d(x.to(dt), self.weight.to(dt),
                                    self.bias.to(dt), self.stride,
                                    self.padding)


def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights in place, drawn by torch on the module's
    device (not flax's initializers): norm scales 1 and shifts 0, other
    vectors N(0, 0.02), each matrix, kernel or embedding N(0, 1/fan_in)
    with ``fan_in`` the product of its trailing dimensions."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            for name, t in mod.named_parameters(recurse=False):
                if getattr(mod, "is_norm", False):
                    t.fill_(1.0 if name == "weight" else 0.0)
                elif t.ndim == 1:
                    t.normal_(0.0, 0.02, generator=gen)
                else:
                    fan_in = math.prod(t.shape[1:])
                    t.normal_(0.0, fan_in ** -0.5, generator=gen)
    return module


def state_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (numpy leaves) -> the state dict of the port
    module whose submodules carry the tree's names: a 2-d ``kernel [in,
    out]`` becomes ``weight [out, in]``, a 4-d conv ``kernel [k, k, in,
    out]`` ``weight [out, in, k, k]``, ``scale`` and ``embedding``
    ``weight``; ``bias`` stays ``bias``."""
    from .llama import _to_torch

    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf, path + (key,))
                continue
            t = _to_torch(leaf)
            if key == "kernel":
                t = t.T if t.ndim == 2 else t.permute(3, 2, 0, 1)
                key = "weight"
            elif key in ("scale", "embedding"):
                key = "weight"
            out[".".join(path + (key,))] = t.contiguous()

    walk(tree.get("params", tree), ())
    return out


def state_from_names(get: Callable[[str], torch.Tensor], keys,
                     names: Dict[str, str], what: str
                     ) -> Dict[str, torch.Tensor]:
    """A module's state read from a checkpoint through ``names`` (this
    module's state name -> the checkpoint's key): ``get(key)`` returns a
    tensor, ``keys`` are the checkpoint's names. A missing key raises,
    naming it and ``what`` the checkpoint is."""
    keys = set(keys)
    out = {}
    for name, src in names.items():
        if src not in keys:
            raise ValueError(f"{what} checkpoint has no {src!r} (for {name})")
        out[name] = get(src)
    return out


def hf_block_names(src: str, dst: str, hf: Dict[str, str]
                   ) -> Dict[str, str]:
    """One encoder block's names: ``{dst}.{n}.{weight,bias}`` ->
    ``{src}.{hf[n]}.{weight,bias}`` for each of ``attn.{q,k,v,o}``,
    ``ln1``, ``ln2``, ``fc1``, ``fc2`` that ``hf`` maps."""
    return {f"{dst}.{n}.{leaf}": f"{src}.{h}.{leaf}"
            for n, h in hf.items() for leaf in ("weight", "bias")}


def key_lengths(attention_mask: Optional[torch.Tensor]
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """A ``[B, S]`` key-validity mask -> ``(lengths [B], None)`` when each
    row's valid keys are a prefix (a right-padded batch: B1's ``lengths``),
    else ``(None, mask [B, 1, 1, S])`` for the plain path, the reference's
    ``attention_mask_2d``. On a CUDA tensor a mask that is not a prefix
    raises: attention there runs only through B1. ``None`` gives
    ``(None, None)``."""
    if attention_mask is None:
        return None, None
    m = attention_mask.to(torch.bool)
    lengths = m.sum(dim=1, dtype=torch.int32)
    prefix = torch.arange(m.shape[1], device=m.device)[None, :] \
        < lengths[:, None]
    if bool(torch.equal(m, prefix)):
        return lengths, None
    if m.is_cuda:
        raise ValueError(
            "attention mask is not right-padded (a row's valid keys are not "
            "a prefix): on CUDA attention runs only through the B1 kernel, "
            "which takes per-row key lengths")
    return None, m[:, None, None, :]


class SelfAttention(nn.Module):
    """Multi-head self-attention with merged-head dense projections,
    causal or not, over the keys ``lengths`` or ``mask`` (from
    :func:`key_lengths`) leave valid."""

    def __init__(self, dim: int, heads: int, dtype, device,
                 causal: bool = False):
        super().__init__()
        self.dim, self.heads, self.causal = dim, heads, causal
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Dense(dim, dim, True, dtype, device))

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        hd = self.dim // self.heads
        q = self.q(x).reshape(B, T, self.heads, hd)
        k = self.k(x).reshape(B, T, self.heads, hd)
        v = self.v(x).reshape(B, T, self.heads, hd)
        kw = dict(causal=self.causal, kv_lengths=lengths, mask=mask)
        if q.is_cuda and q.dtype != torch.bfloat16:
            o = dot_product_attention(q.bfloat16(), k.bfloat16(),
                                      v.bfloat16(), **kw).to(q.dtype)
        else:
            o = dot_product_attention(q, k, v, **kw)
        return self.o(o.reshape(B, T, self.dim))


class EncoderBlock(nn.Module):
    """A pre-LN block (``x + attn(ln1(x))``, then
    ``x + fc2(act(fc1(ln2(x))))``) or, with ``pre_ln=False``, a post-LN
    one (``ln1(x + attn(x))``, then ``ln2(x + fc2(act(fc1(x))))``)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, act: str = "gelu",
                 ln_eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=torch.float32, device=None,
                 causal: bool = False, pre_ln: bool = True):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"activation {act!r} not in {list(ACTIVATIONS)}")
        self.act = act
        self.dtype, self.pre_ln = dtype, pre_ln
        pd = param_dtype
        self.ln1 = LayerNorm(dim, ln_eps, pd, device)
        self.attn = SelfAttention(dim, heads, pd, device, causal=causal)
        self.ln2 = LayerNorm(dim, ln_eps, pd, device)
        self.fc1 = Dense(dim, mlp_dim, True, pd, device)
        self.fc2 = Dense(mlp_dim, dim, True, pd, device)

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(ACTIVATIONS[self.act](self.fc1(h)))

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.pre_ln:
            x = self.ln1(x + self.attn(x, lengths, mask), self.dtype)
            return self.ln2(x + self._mlp(x), self.dtype)
        x = x + self.attn(self.ln1(x, self.dtype), lengths, mask)
        return x + self._mlp(self.ln2(x, self.dtype))


class Encoder(nn.Module):
    """A stack of :class:`EncoderBlock` named ``layer_{i}``."""

    def __init__(self, n_layers: int, dim: int, heads: int, mlp_dim: int,
                 act: str = "gelu", ln_eps: float = 1e-5,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None, causal: bool = False, pre_ln: bool = True):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(
                dim, heads, mlp_dim, act=act, ln_eps=ln_eps, dtype=dtype,
                param_dtype=param_dtype, device=device, causal=causal,
                pre_ln=pre_ln))

    def forward(self, x: torch.Tensor, collect_hidden: bool = False,
                n_blocks: int = -1,
                attention_mask: Optional[torch.Tensor] = None):
        """The output after ``n_blocks`` blocks (all when negative); with
        ``collect_hidden`` also every hidden state on the way (the input
        first, the output last), as the reference returns them.
        ``attention_mask`` ``[B, S]`` marks the valid keys
        (:func:`key_lengths`); padded query rows attend the valid keys, as
        the reference's do."""
        lengths, mask = key_lengths(attention_mask)
        n = self.n_layers if n_blocks < 0 else n_blocks
        hidden = []
        for i in range(n):
            if collect_hidden:
                hidden.append(x)
            x = getattr(self, f"layer_{i}")(x, lengths, mask)
        if collect_hidden:
            hidden.append(x)
            return x, hidden
        return x
