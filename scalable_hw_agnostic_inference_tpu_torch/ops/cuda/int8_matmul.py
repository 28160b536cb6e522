"""W8A16 projection: the int8 weight-only kernel's wrapper and its plain
version.

No Pallas counterpart: the JAX package leaves ``quant_matmul``'s int8
product to XLA (``scalable_hw_agnostic_inference_tpu/ops/quant.py:142``),
which converts the int8 tiles in registers. On the card that fusion is
``csrc/int8_matmul.cu``; its source note says what bounds it on the H100
and what its design does about that.

:func:`int8_matmul` launches the kernel for a CUDA tensor and raises for
anything the kernel does not take; for a tensor on the CPU it runs
:func:`int8_matmul_reference`, the reference's expression.
"""

from __future__ import annotations

import torch

from . import _build
from .ragged_paged_attention import sm_count

#: the widest call the kernel takes (one to four m16 tiles): a decode
#: step's batch (at most the largest decode bucket, 64 rows) or the
#: sampled rows' ``lm_head``. Past it the call is a prefill or a chunk of
#: hundreds of rows, where the tensor cores, not the weight bytes, bound
#: it (at 512 rows a weight byte feeds 512 multiply-adds, past the card's
#: ~295 per byte), and the kernel, which re-reads x from L2 for every 8 to
#: 64 output rows, is not built for that; ``ops.quant`` routes by it
MAX_ROWS = 64
#: output rows a CTA may own: 8 warps as WN n8 tiles side by side
ROWS_PER_CTA = (64, 32, 16, 8)


def int8_matmul_reference(x: torch.Tensor, weight_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(x @ Wq^T) * scale`` in ``x``'s dtype, the
    weight cast to it, the product rounded before the rounded scale
    multiplies it (the reference's ``quant_matmul`` int8 branch)."""
    y = torch.nn.functional.linear(x, weight_q.to(x.dtype))
    return y * scale.to(x.dtype)


def int8_plan(n_out: int, n_sms: int) -> int:
    """Output rows per CTA: the largest of :data:`ROWS_PER_CTA` that still
    gives at least 15/16 of a CTA per SM (rows per CTA set how often x is
    read from L2 per weight byte; CTAs set how many SMs stream weights),
    halved once where the halves still run in one wave of two CTAs per SM
    (an SM's second CTA computes while the first waits on its copies)."""
    rows = next((r for r in ROWS_PER_CTA
                 if -(-n_out // r) * 16 >= n_sms * 15), ROWS_PER_CTA[-1])
    if rows > ROWS_PER_CTA[-1] and -(-n_out // (rows // 2)) <= 2 * n_sms:
        rows //= 2
    return rows


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def int8_matmul(x: torch.Tensor, weight_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``y [M, N] = (x [M, K] @ weight_q [N, K]^T) * scale [N]`` with int8
    weights. On a CUDA tensor this launches the W8A16 kernel (x bf16, at
    most :data:`MAX_ROWS` rows, ``N % 8 == 0``, ``K % 64 == 0``) or raises;
    on a CPU tensor it runs :func:`int8_matmul_reference`."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, weight_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    if x.dim() != 2 or weight_q.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"int8_matmul takes x [M, K], weight_q [N, K], "
                         f"scale [N]; got {tuple(x.shape)}, "
                         f"{tuple(weight_q.shape)}, {tuple(scale.shape)}")
    M, K = x.shape
    N = weight_q.shape[0]
    if weight_q.shape[1] != K or scale.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, weight_q "
                         f"{tuple(weight_q.shape)}, scale "
                         f"{tuple(scale.shape)} do not match")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"int8_matmul kernel takes 1 to {MAX_ROWS} rows, "
                         f"got {M}")
    if N % 8 or K % 64:
        raise ValueError(f"int8_matmul kernel takes N % 8 == 0 and "
                         f"K % 64 == 0, got N={N}, K={K}")
    x = x.contiguous()
    _check("x", x, x.device, torch.bfloat16)
    _check("weight_q", weight_q, x.device, torch.int8)
    _check("scale", scale, x.device, torch.float32)
    rows = int8_plan(N, sm_count(x.device.index))
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    int8_matmul.launches += 1
    err = lib.shai_int8_matmul(
        x.data_ptr(), weight_q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        M, N, K, rows, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    return y


#: kernel launches since the last reset (``chip_smoke.py`` reads it to show
#: the serving path went through the kernel)
int8_matmul.launches = 0
