"""Transformer-encoder building blocks: the CLIP tower of the soft-prefix
VLM (``models/vlm.py``) and the dense and LayerNorm layers mllama's vision
model shares.

Port of ``scalable_hw_agnostic_inference_tpu/models/encoder.py``
(``ACTIVATIONS``, ``SelfAttention``, ``EncoderBlock``, ``Encoder``), cut
to what the CLIP tower runs: pre-LN, non-causal, quick-GELU or exact
GELU. The reference's post-LN (DistilBERT) and causal branches serve
models the port does not have. The modules' names map one to one onto the
JAX tree: ``layer_{i}``, ``attn.{q,k,v,o}``, ``ln1``, ``ln2``, ``fc1``,
``fc2``. A flax ``Dense`` kernel ``[in, out]`` is held as ``weight [out,
in]`` (the HF layout), a ``LayerNorm`` ``scale`` as ``weight``.

Attention goes through ``ops.attention.dot_product_attention``: on a CUDA
tensor that is the B1 kernel (non-causal, no lengths, bf16), on the CPU
the plain path. Parameters are held in ``param_dtype`` and cast to the
compute ``dtype`` at use, as flax casts them; LayerNorms compute in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict

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


class LayerNorm(nn.Module):
    """LayerNorm in fp32, cast to ``out_dtype`` (flax ``LayerNorm``
    computes its statistics in fp32 and returns its ``dtype``)."""

    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = param((dim,), dtype, device, 1.0)
        self.bias = param((dim,), dtype, device)

    def forward(self, x: torch.Tensor, out_dtype) -> torch.Tensor:
        return nn.functional.layer_norm(
            x.float(), x.shape[-1:], self.weight.float(), self.bias.float(),
            self.eps).to(out_dtype)


class SelfAttention(nn.Module):
    """Non-causal multi-head self-attention with merged-head dense
    projections."""

    def __init__(self, dim: int, heads: int, dtype, device):
        super().__init__()
        self.dim, self.heads = dim, heads
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Dense(dim, dim, True, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        hd = self.dim // self.heads
        q = self.q(x).reshape(B, T, self.heads, hd)
        k = self.k(x).reshape(B, T, self.heads, hd)
        v = self.v(x).reshape(B, T, self.heads, hd)
        o = dot_product_attention(q, k, v)
        return self.o(o.reshape(B, T, self.dim))


class EncoderBlock(nn.Module):
    """A pre-LN block: ``x + attn(ln1(x))``, then
    ``x + fc2(act(fc1(ln2(x))))``."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, act: str = "gelu",
                 ln_eps: float = 1e-5, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"activation {act!r} not in {list(ACTIVATIONS)}")
        self.act = act
        self.dtype = dtype
        pd = param_dtype
        self.ln1 = LayerNorm(dim, ln_eps, pd, device)
        self.attn = SelfAttention(dim, heads, pd, device)
        self.ln2 = LayerNorm(dim, ln_eps, pd, device)
        self.fc1 = Dense(dim, mlp_dim, True, pd, device)
        self.fc2 = Dense(mlp_dim, dim, True, pd, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x, self.dtype))
        h = self.ln2(x, self.dtype)
        return x + self.fc2(ACTIVATIONS[self.act](self.fc1(h)))


class Encoder(nn.Module):
    """A stack of :class:`EncoderBlock` named ``layer_{i}``."""

    def __init__(self, n_layers: int, dim: int, heads: int, mlp_dim: int,
                 act: str = "gelu", ln_eps: float = 1e-5,
                 dtype=torch.float32, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncoderBlock(
                dim, heads, mlp_dim, act=act, ln_eps=ln_eps, dtype=dtype,
                param_dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor, collect_hidden: bool = False,
                n_blocks: int = -1):
        """The output after ``n_blocks`` blocks (all when negative); with
        ``collect_hidden`` also every hidden state on the way (the input
        first, the output last), as the reference returns them."""
        n = self.n_layers if n_blocks < 0 else n_blocks
        hidden = []
        for i in range(n):
            if collect_hidden:
                hidden.append(x)
            x = getattr(self, f"layer_{i}")(x)
        if collect_hidden:
            hidden.append(x)
            return x, hidden
        return x
