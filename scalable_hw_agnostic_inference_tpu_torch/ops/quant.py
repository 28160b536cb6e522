"""Int8 weight-only projections and int8 KV-block quantization.

Port of ``scalable_hw_agnostic_inference_tpu/ops/quant.py``: the weight
quantizer ``quantize_weight`` / ``dequantize_weight`` (``:32,:40``), the
conversion predicate ``_is_quant_node`` (``:44``) with
``quantize_state_dict`` and ``quantized_weight_names`` (the counterparts of
``quantize_params_tree`` and ``quantized_kernel_paths``, ``:53,:68``),
``quant_matmul`` (``:142``) and the int8 KV-block codec
``quantize_kv_blocks``, ``dequantize_kv_blocks`` and
``requantize_block_tokens`` (``:99-139``). The arithmetic is the
reference's step for step: an fp32 amax, a ``1e-8`` floor, ``/ 127``,
``round`` (half to even in both frameworks) then ``clip(-127, 127)``.
Weights are ``nn.Linear`` weights, ``[out, in]``, so a weight's amax runs
over ``dim=1`` and its scale is f32 ``[out]``.

An int8 projection is ``(x @ Wq^T in x's dtype) * scale.to(x.dtype)``, as
the reference's: the product is rounded to ``x``'s dtype first, then
multiplied by the rounded scale. The reference leaves it to XLA, which
converts the int8 tiles in registers at every width; on the card a plain
``x @ Wq.to(bf16)^T`` would write and re-read a bf16 copy of every weight
on every call (5 bytes per weight against bf16's 2). So every int8 call
goes to the hand-written W8A16 kernel (``ops/cuda/int8_matmul.py``), which
takes decode widths and wide ones (prefill, chunks, fused windows) in two
instantiations of one source.
"""

from __future__ import annotations

import re
from typing import Dict, Set, Tuple

import torch

from .cuda.int8_matmul import int8_matmul, int8_matmul_reference

#: state-dict names of the projections that quantize (the reference's
#: ``_QUANT_PARENT`` in the port's names): attention q/k/v/o (an mllama
#: cross layer's too), MLP gate/up/down and an untied ``lm_head``; never
#: the embedding, a norm or a gate
_QUANT_NAME = re.compile(
    r"(^|\.)((cross_)?attn\.(q|k|v|o)|mlp\.(gate|up|down)|lm_head)"
    r"\.weight$")

def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[out, in]`` float weight -> (int8 ``[out, in]``, f32 ``[out]``
    scale): symmetric per output channel."""
    w32 = w.float()
    amax = w32.abs().amax(dim=1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(w32 / scale[:, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight`: ``q * scale`` per output row."""
    return (q.float() * scale.float()[:, None]).to(dtype)


def _is_quant_node(name: str, tensor: torch.Tensor) -> bool:
    """THE conversion predicate: a 2-D weight under a projection name.
    Shared by :func:`quantize_state_dict` and :func:`quantized_weight_names`
    so the two can never disagree about which weights shrink to int8. A
    tied ``lm_head`` is the embedding and has no name of its own here."""
    return bool(_QUANT_NAME.search(name)) and tensor.dim() == 2


def quantize_state_dict(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Replace every quantizable ``<proj>.weight`` with ``<proj>.weight_q``
    (int8) and ``<proj>.scale`` (f32), one weight at a time on the weight's
    own device; every other entry is passed through."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if _is_quant_node(name, t):
            q, s = quantize_weight(t)
            stem = name[: -len(".weight")]
            out[f"{stem}.weight_q"], out[f"{stem}.scale"] = q, s
        else:
            out[name] = t
    return out


def quantized_weight_names(state: Dict[str, torch.Tensor]) -> Set[str]:
    """The names :func:`quantize_state_dict` would convert (works on meta
    tensors too: the budget math prices exactly these at int8 width)."""
    return {name for name, t in state.items() if _is_quant_node(name, t)}


def quant_matmul(x: torch.Tensor, proj: torch.nn.Module) -> torch.Tensor:
    """``x @ W^T`` in ``x``'s dtype for a projection module: an
    ``nn.Linear`` (the weight cast to ``x``'s dtype) or a
    ``models.llama.QuantLinear`` (``weight_q`` int8 and ``scale`` f32, the
    reference's ``{"kernel_q", "scale"}``). Every int8 call, leading dims
    flattened into rows, goes to the W8A16 kernel's wrapper (its plain
    version for a tensor on the CPU)."""
    weight_q = getattr(proj, "weight_q", None)
    if weight_q is None:
        return torch.nn.functional.linear(x, proj.weight.to(x.dtype))
    rows = x.numel() // x.shape[-1]
    y = int8_matmul(x.reshape(rows, x.shape[-1]).contiguous(), weight_q,
                    proj.scale)
    return y.reshape(*x.shape[:-1], weight_q.shape[0])


def quantize_kv_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., block_size, Hkv, Dh]`` float KV -> (int8 same shape,
    ``[..., Hkv]`` f32 scale). Symmetric per block x kv head: one head's
    outlier cannot flatten another head's resolution."""
    x32 = x.float()
    amax = x32.abs().amax(dim=(-3, -1))                   # [..., Hkv]
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None, :, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv_blocks(q: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_blocks`: ``[..., Bs, Hkv, Dh]`` int8 +
    ``[..., Hkv]`` f32 scale -> float blocks in ``dtype``."""
    x = q.float() * scale[..., None, :, None].float()
    return x.to(dtype)


def requantize_block_tokens(q_blk: torch.Tensor, scale: torch.Tensor,
                            new_kv: torch.Tensor, pos_in_block: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one fresh token's KV into int8 blocks and re-quantize them.

    ``q_blk`` ``[B, Bs, Hkv, Dh]`` int8 (the gathered target blocks),
    ``scale`` ``[B, Hkv]``, ``new_kv`` ``[B, Hkv, Dh]`` float,
    ``pos_in_block`` ``[B]``. The new scale is the running max of the old
    one and the token's own: a block's scale only grows, so tokens already
    there lose at most half a step of the final scale. Returns the new
    blocks and scales (the inputs are not modified).
    """
    B = q_blk.shape[0]
    x = dequantize_kv_blocks(q_blk, scale, dtype=torch.float32)
    x[torch.arange(B, device=x.device), pos_in_block.long()] = new_kv.float()
    tok_amax = new_kv.float().abs().amax(dim=-1)          # [B, Hkv]
    new_scale = torch.maximum(scale.float(), tok_amax.clamp_min(1e-8) / 127.0)
    q = torch.round(x / new_scale[:, None, :, None]).clamp(-127, 127)
    return q.to(torch.int8), new_scale
