#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, end to end.

    python3 chip_smoke.py                  # every phase (needs one card)
    python3 chip_smoke.py --phases build,flash,paged,ragged

Phases:
  1. ``card``   the card's name and power limit (nvidia-smi);
  2. ``build``  build every kernel from ``csrc/*.cu`` with nvcc (sm_90a);
  3. ``flash``  hold B1 (flash attention) against its plain version at
                Llama-3-8B prefill shapes, and time kernel, plain version,
                bound and the SDPA yardstick;
  4. ``paged``  the same for B2 (paged decode attention, the decode CTA of
                B3's walk) at decode shapes and at serve's shape, plus block
                sizes 8 and 24 and a group of 32 heads; B2 must return
                exactly B3's output with ``rows_per_table`` 1, and the
                split count and the in-kernel merge are measured against
                the alternatives;
  5. ``ragged`` the same for B3 (ragged paged attention) over bf16 and
                int8 pools at decode (split-K) and chunked-prefill
                continuation shapes (one table row shared through
                ``rows_per_table``, and copied per row); B2 given int8
                scales must return B3's result; and B3 over the fused
                step's mixed rows (one launch over row groups: 8 decode
                rows, lengths 1 to 4096, and a 512-token chunk at starts
                0, 512 and 2560, M=256), timed beside the decode-only and
                chunk-only launches it replaces;
  6. ``decode_graph`` one decode step at Llama-3-8B width (32 layers,
                seeded weights) captured as a CUDA graph
                (``engine/graphs.py``) at serve's bucketed shape (B=8, a
                32-block bucket, bf16 pool) and at the ragged int8 full
                window (256 blocks, lengths 1 to 4096): the replay's
                tokens, positions and logprob readout (top ids, top
                logprobs, the sampled token's logprob) against the eager
                call of the same decode function on the same inputs and
                draws, bit for bit; fresh draws per replay; wall and
                device time per step, eager against replay, launches per
                step, capture time and the graph pool's bytes; the
                readout's own device time at serve's shape;
  7. ``engine`` the engine at Llama-3-8B widths with seeded random weights,
                warmed (every decode key captured), one prompt chunked
                through the static-start continuation, half the rows
                asking for 5 logprobs: greedy tokens against the argmax
                of the full-sequence scoring forward over prompt +
                generated tokens, each sampled token's logprob against
                that forward's log-softmax (``LP_TOL``), under the default
                async decode and equal to a lock-step run's
                (``SHAI_ASYNC_DECODE=0``), logprob entries included;
  8. ``engine_ragged`` the same model under ``SHAI_RAGGED_ATTENTION=1``
                (bf16), ``SHAI_RAGGED_ATTENTION=1 SHAI_KV_QUANT=int8`` and
                ``SHAI_KV_QUANT=int8`` alone, each also equal to lock-step;
  9. ``engine_fused`` the same model under ``SHAI_RAGGED_ATTENTION=1
                SHAI_FUSED_STEP=1``, bf16 and then ``SHAI_KV_QUANT=int8``:
                async equal to lock-step, greedy tokens equal to the
                laddered ragged run's or parting only at a near-tie of its
                top-2 logprobs (``TIE_GAP``), B3 exactly the layers times
                the fused and chunk-only replays (no continuation
                function, no eager continuation launch);
 10. ``serve``  serve ``llama-8b-geometry`` over HTTP (the unit a user runs,
                its closed set warmed before readiness) and answer 8
                concurrent ``POST /generate``; then an OpenAI round: 8
                concurrent streamed ``POST /v1/completions`` (the client's
                time to the first SSE chunk beside the engine's TTFT),
                ``n=2``, ``logprobs: 5`` (every sampled logprob
                ``-log(128256)`` within ``GEOMETRY_LP_ATOL``: zero weights
                give a uniform distribution), an expired
                ``X-SHAI-Deadline-Ms`` (504) and a ``/metrics`` scrape
                holding the ``shai_*`` contract families;
 11. ``serve_ragged`` the same unit with ``SHAI_RAGGED_ATTENTION=1
                SHAI_KV_QUANT=int8`` and an engine ConfigMap of
                ``max_model_len`` 4096: two of the 8 prompts chunk;
 12. ``serve_fused`` the same with ``SHAI_FUSED_STEP=1 SHAI_KV_COW=1``
                (the chunks ride the fused graphs' replays), then one
                ``n=4`` completion admitted as one prefill with 3
                copy-on-write forks; its numbers beside serve_ragged's.

Each engine and serve phase (and the serve phase's OpenAI round) zeroes
the launch counters just before its run and requires exactly its own
kernels to have risen just after, and B2's or B3's count to be exactly
the layers times the graph replays (plus, for B3 on the laddered engine,
the layers times the ragged continuation chunks); the serve phases also
require 0 recompiles after warmup and the warmed executable count
unchanged.
Any failed phase makes the script exit non-zero without the result lines.
A full run prints the card's name and power limit, then, second to last,
``{"kernels": [...]}`` (per kernel: route, source, the TPU kernel it
replaces, launches in the serve phase that runs it, max error,
kernel/plain/bound/library times; B3 also its fused mixed-row launch) and,
last, ``{"ok": true, "device":
{...}}``. It exits non-zero at once when CUDA is unavailable or the port's
package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

PHASES = ("card", "build", "flash", "paged", "ragged", "decode_graph",
          "engine", "engine_ragged", "engine_fused", "serve", "serve_ragged",
          "serve_fused")

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# bf16 tensor-core FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# kernel vs plain version: the plain version runs in fp32 on the same
# values (inputs upcast, output not rounded), and each output vector (one
# query and head, D values) must hold max |out - ref| <= KERNEL_ATOL +
# KERNEL_RRMS * rms(ref vector). Error model, u = 2^-8 (bf16 unit
# roundoff): B1 rounds P to bf16 before P.V and both kernels round the
# output, each at most u relative, so over D = 128 values the error stays
# near 6u * rms = 0.023 rms; 0.05 leaves twice that. A walk that loses the
# last k of n live keys moves each value by about sqrt(k/n) rms (0.06 rms
# at 8 of 2048, some of 128 values three times that), which this fails:
# every case also checks that the plain version with each row's length cut
# by DROPPED_KEYS fails it. KERNEL_ATOL only admits fp32 noise, so a
# length-0 row must come out as zeros.
KERNEL_ATOL = 1e-6
KERNEL_RRMS = 0.05
DROPPED_KEYS = 8

# engine vs scoring forward: logits of the random-weight model are O(1-5);
# the two paths round bf16 activations in different places over 32 layers
# (batched prefill vs single-sequence scoring, paged decode vs full
# causal attention), so a token may differ only where the scoring
# forward's logit for it is within this much of its maximum. The bucketed
# engine's tokens are scored by the scoring forward through B1's plain
# version (fp32 attention), so that the bar does not move with B1. The
# same engine through the kernels' plain versions, the reference semantics
# on the same card, misses that forward's argmax by 0.125 (0.156 for the
# ragged bf16 engine): the rounding of the rest of the model alone, so a
# bar of 0.1 fails the reference itself. 0.25 leaves 1.6x the larger; a
# wrong cache, table or mask gives tokens whole logits below the maximum.
TIE_TOL = 0.25
# the fused engine against the laddered ragged engine: greedy tokens may
# part only where the laddered run's top-2 logprobs are this close
# (``tests/parity.py``'s tie rule: bf16 rounding of a logit of a few units)
TIE_GAP = 3e-2
# The ragged and int8 runs are scored by the scoring forward through B1,
# and also through B1's plain version: the largest logit change between
# the two scoring forwards, eps, is what a rounding-level change of the
# attention arithmetic does to this model. If the engine's logits are
# within eps of the scoring forward's, its argmax is within 2 * eps of the
# scoring maximum, which the ragged bf16 run must hold.
NOISE_TIES = 2.0
# An int8 KV pool changes the numbers, not only their rounding, and this
# random-weight model's logits are flat (top-2 gaps of a few tenths among
# 128,256 tokens), so int8 flips many near-ties. An int8 run must stay
# within 2 * eps, and make as many of its tokens the scoring argmax as the
# same engine run through the kernels' plain versions (the reference
# semantics on the same card), less this share of the tokens: the two runs
# decode freely and part after their first flip.
INT8_SLACK = 0.1

# engine logprobs vs the scoring forward: each sampled token's logprob
# (the decode graph's readout, or the prefill's for the first token) must
# be within LP_TOL of the log-softmax of the full-sequence scoring forward
# through B1's plain version at that position. The same rounding that
# puts the engine's greedy token up to 0.156 below the scoring forward's
# maximum logit (TIE_TOL) moves a token's logit and, far less, the
# log-sum-exp over 128,256 logits, so it takes TIE_TOL.
LP_TOL = TIE_TOL
# the geometry tier's zero weights give all-equal logits: every logprob is
# -log(vocab) up to the f32 rounding of a log-sum-exp over 128,256 terms
GEOMETRY_LP_ATOL = 1e-5

ENGINE_LAYERS = 32
ENGINE_NEW_TOKENS = 16
# the engine phases' prompts: 1300 tokens chunk 512 + 512 + 276 under the
# (128, 512) buckets; the engine phase also keeps slice 1's 120
ENGINE_PROMPTS = (5, 37, 300, 1300)
SERVE_REQUESTS = 8
# serve_ragged's engine ConfigMap: the 8B counterpart of
# deploy/disagg/vllm-split-deploy.yaml's engine shapes, two buckets so
# that prompts past 512 tokens chunk
SERVE_RAGGED_CONFIG = {"max_model_len": 4096, "block_size": 16,
                       "max_num_seqs": 8,
                       "context_encoding_buckets": [128, 512],
                       "max_new_tokens": 16}

REPO = os.path.dirname(os.path.abspath(__file__))
TPU_PKG = "scalable_hw_agnostic_inference_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def _env(values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- timing ------------------------------------------------------------------


class Timer:
    """Median device time of one call, from CUDA events around each call.
    A 1 GiB write before every call evicts the 50 MB L2 (the real caller
    finds its operands cold) and keeps the device busy for some 0.3 ms
    while the host enqueues the call (a wrapper's checks, its scratch
    allocations, the launch), so host overhead stays out of the window. A
    256 MB write (80 us) was too short for the split-K wrapper on a slow
    host: its decode times doubled between two machines. :meth:`host`
    measures that host side on its own."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 2,
                 clean: bool = False) -> float:
        """``clean``: flush by reading the 1 GiB (a sum) instead of writing
        it, so the L2 holds clean lines: a bytes-bound kernel then pays no
        write-back of the flush's dirty lines, as in a decode step, whose
        earlier kernels mostly read weights."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if clean:
                self.flush.sum()
            else:
                self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def host(self, fn, reps: int = 50) -> float:
        """Host wall time of one call in ms: a wrapper's checks, plan,
        allocations and launch, without waiting for the device (the
        calls queue up behind each other, far from the launch queue's
        depth)."""
        fn()
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        seconds = time.perf_counter() - t0
        self.torch.cuda.synchronize()
        return seconds / reps * 1e3


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ------------------------------------------------------------------


def phase_card(ctx):
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    ctx["card"] = out
    log(f"card: {out}")


def phase_build(ctx):
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import _build

    t0 = time.monotonic()
    _build.build()
    _build.library()
    log(f"build: {len(_build.sources())} sources -> {_build.LIB_NAME} in "
        f"{time.monotonic() - t0:.1f} s (nvcc {_build.last_build_seconds:.1f}"
        f" s; 0 means already built)")
    # -Xptxas=-v: each kernel instantiation's registers and spills, named
    # kernel<D[, pool type]> from its mangled name
    import re

    name = "?"
    for line in _build.build_log().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"([a-z]+_kernel)ILi(\d+)E(a|13__nv_bfloat16)?",
                          line)
            name = line.strip() if m is None else (
                f"{m.group(1)}<{m.group(2)}"
                + {"a": ", int8", "13__nv_bfloat16": ", bf16"}.get(
                    m.group(3) or "", "") + ">")
        elif "registers" in line or "spill" in line.lower():
            log(f"  ptxas: {name}: {line.split(':', 1)[-1].strip()}")


def _tolerance_share(out, ref) -> float:
    """Largest ``|out - ref|`` over its tolerance (see ``KERNEL_RRMS``);
    infinite when ``out`` holds a non-finite value."""
    import torch

    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        return float("inf")
    rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
    tol = KERNEL_ATOL + KERNEL_RRMS * rms
    return ((out - ref).abs() / tol).max().item()


def _check_close(what: str, out, ref, dropped=None):
    """Fail unless ``out`` is finite and within the kernel tolerance of
    ``ref``, and unless ``dropped`` (the plain version with each row's
    last ``DROPPED_KEYS`` live keys left out) is not. Returns the largest
    absolute error and the shares of the tolerance used by ``out`` and by
    ``dropped``."""
    share = _tolerance_share(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    if share > 1.0:
        raise AssertionError(
            f"{what}: max |err| {err:.3e} uses {share:.2f} of the tolerance "
            f"{KERNEL_ATOL} + {KERNEL_RRMS} rms(ref), or is non-finite")
    d_share = None
    if dropped is not None:
        d_share = _tolerance_share(dropped, ref)
        if d_share <= 1.0:
            raise AssertionError(
                f"{what}: the tolerance is too loose: the plain version "
                f"without each row's last {DROPPED_KEYS} keys passes it "
                f"({d_share:.2f})")
    return err, share, d_share


def _cut(lens):
    return (lens - DROPPED_KEYS).clamp_min(1)


def _flash_case(torch, gen, B, T, S, H, Hkv, D, lengths, causal):
    q = torch.randn(B, T, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, Hkv, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, Hkv, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    lens = (None if lengths is None else
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    return q, k, v, lens


def _flash_work(B, T, S, H, Hkv, D, lengths, causal):
    """Bytes each input read once / output written once (keys only up to
    each row's length) and FLOPs over the live (query, key) pairs."""
    n_bytes = 2 * (2 * B * T * H * D)  # q in, o out
    pairs = 0
    for b in range(B):
        n = S if lengths is None else min(lengths[b], S)
        n_bytes += 2 * (2 * n * Hkv * D)
        for i in range(T):
            live = min(n, S - T + i + 1) if causal else n
            pairs += max(live, 0)
    if lengths is not None:
        n_bytes += 4 * B
    return n_bytes, 4 * D * H * pairs


def phase_flash(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    timer = ctx["timer"]
    H, Hkv = 32, 8
    # (B, T, S, D, lengths, causal, timed): Llama-3-8B prefill shapes;
    # lengths mix 1 and the full length; T < S (continuation) cases, one
    # whose causal offset S - T = 784 is no multiple of a key tile (the
    # static continuation at start 784); T = 100, no multiple of the query
    # tile; B = 4 at every other head size
    cases = [
        (1, 512, 512, 128, [512], True, True),
        (4, 512, 512, 128, [1, 100, 333, 512], True, True),
        (1, 2048, 2048, 128, [2048], True, True),
        (4, 2048, 2048, 128, [1, 700, 1500, 2048], True, True),
        (2, 512, 2048, 128, [2048, 1000], True, True),
        (1, 512, 1296, 128, [1296], True, True),
        (2, 100, 300, 128, [300, 37], True, False),
        (1, 512, 512, 128, None, False, False),
        (4, 512, 512, 64, [1, 100, 333, 512], True, True),
        (4, 512, 512, 192, [1, 100, 333, 512], True, True),
        (4, 512, 512, 256, [1, 100, 333, 512], True, True),
    ]
    small = [(64, 2, 256, 256, 8, 2, [200, 0], True),
             (192, 1, 128, 128, 8, 2, [100], True),
             (256, 2, 256, 256, 8, 2, [256, 77], True)]
    worst = 0.0
    rows = []
    for B, T, S, D, lengths, causal, timed in cases:
        q, k, v, lens = _flash_case(torch, gen, B, T, S, H, Hkv, D, lengths,
                                    causal)
        out = fa.flash_attention(q, k, v, causal=causal, lengths=lens)
        f32 = (q.float(), k.float(), v.float())
        ref = fa.flash_attention_reference(*f32, causal=causal, lengths=lens)
        dropped = None if lens is None else fa.flash_attention_reference(
            *f32, causal=causal, lengths=_cut(lens))
        torch.cuda.synchronize()
        shape = (f"B={B} T={T} S={S} H={H} Hkv={Hkv} D={D} causal={causal} "
                 f"lengths={lengths}")
        err, share, d_share = _check_close(f"flash_attention {shape}", out,
                                           ref, dropped)
        del f32, ref, dropped
        worst = max(worst, err)
        line = {"shape": shape, "max_abs_err": err, "tol_share": share,
                "dropped_keys_tol_share": d_share}
        if timed:
            ms = timer(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                  lengths=lens))
            plain = timer(lambda: fa.flash_attention_reference(
                q, k, v, causal=causal, lengths=lens), reps=5)
            # yardstick only: SDPA with the equivalent boolean mask, K/V
            # expanded to the query heads outside the timed call
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous()
            vt = v.repeat_interleave(H // Hkv, 2).transpose(1, 2).contiguous()
            kpos = torch.arange(S, device="cuda")
            mask = (kpos[None, :] < lens.long()[:, None])[:, None, None, :]
            qpos = torch.arange(T, device="cuda") + (S - T)
            mask = mask & (qpos[:, None] >= kpos[None, :])[None, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = timer(lambda: sdpa(qt, kt, vt, attn_mask=mask))
            del qt, kt, vt, mask
            host = timer.host(lambda: fa.flash_attention(
                q, k, v, causal=causal, lengths=lens))
            n_bytes, flops = _flash_work(B, T, S, H, Hkv, D, lengths, causal)
            bms, by = bound_ms(n_bytes, flops)
            line.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=lib, host_ms=host)
        rows.append(line)
        log("flash_attention: " + json.dumps(line))
    for D_, B, T, S, H_, Hkv_, lengths, causal in small:
        q, k, v, lens = _flash_case(torch, gen, B, T, S, H_, Hkv_, D_,
                                    lengths, causal)
        out = fa.flash_attention(q, k, v, causal=causal, lengths=lens)
        f32 = (q.float(), k.float(), v.float())
        ref = fa.flash_attention_reference(*f32, causal=causal, lengths=lens)
        dropped = fa.flash_attention_reference(*f32, causal=causal,
                                               lengths=_cut(lens))
        err, share, d_share = _check_close(f"flash_attention D={D_}", out,
                                           ref, dropped)
        worst = max(worst, err)
        if 0 in lengths and bool(out[lengths.index(0)].any()):
            raise AssertionError("flash_attention: a length-0 row is not 0")
        log(f"flash_attention: D={D_} B={B} T={T} lengths={lengths} "
            f"max |err| {err:.3e}, {share:.3f} of the tolerance (dropped "
            f"keys: {d_share:.2f})")
    # the summary row: the serving config's largest prefill bucket, batched
    ctx["flash"] = dict(rows[1], max_abs_err=worst)


def _paged_case(torch, gen, B, H, Hkv, D, bs, N, M, lengths):
    q = torch.randn(B, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    perm = torch.randperm(N, generator=gen, device="cuda")
    tables = perm[: B * M].reshape(B, M).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def _paged_work(B, H, Hkv, D, bs, M, lengths):
    n_bytes = 2 * (2 * B * H * D) + 4 * B  # q in, o out, lengths
    toks = 0
    for n in lengths:
        live = min(n, M * bs)
        toks += live
        n_bytes += 4 * (-(-live // bs))    # the live table entries
    n_bytes += 2 * (2 * toks * Hkv * D)    # live K and V
    return n_bytes, 4 * D * H * toks


def _device_us_by_kernel(torch, fn, calls: int = 20):
    """``{kernel: (device us, launches)}`` per call of ``fn``, from a
    ``torch.profiler`` trace of ``calls`` calls (empty when the profiler
    records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us:
            t, n = out.get(e.key, (0.0, 0.0))
            out[e.key] = (t + us / calls, n + e.count / calls)
    return out


def _paged_plan_choices(torch, timer, pa, rpa, q, kp, vp, tables, lens):
    """B2 at one shape under each split count, with the decode CTA's last
    split merging (key ``"s"``) or a second launch merging (``"s+merge"``),
    and the second launch's share of the device time at the plan's split
    count (profiler, warm L2); returns a dict of the times."""
    rows, H, _ = q.shape
    _, bs, Hkv, _ = kp.shape
    planned = rpa.decode_plan(rows, H, Hkv, bs, tables.shape[1],
                              torch.cuda.get_device_properties(
                                  q.device).multi_processor_count)[1]
    times = {}
    for s in sorted({1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, planned}):
        for merge_in_kernel in (True, False):
            if s == 1 and not merge_in_kernel:
                continue
            times[(s, merge_in_kernel)] = timer(lambda: rpa._launch(
                pa.paged_decode_attention, q, kp, vp, tables, lens, None,
                None, None, 1, splits=s, merge_in_kernel=merge_in_kernel))
    by_kernel = _device_us_by_kernel(torch, lambda: rpa._launch(
        pa.paged_decode_attention, q, kp, vp, tables, lens, None, None, None,
        1, splits=planned, merge_in_kernel=False))
    merge_us = sum(us for k, (us, _) in by_kernel.items()
                   if "merge_kernel" in k)
    walk_us = sum(us for k, (us, _) in by_kernel.items()
                  if "decode_kernel" in k or "merge_kernel" in k)
    line = {"planned_splits": planned,
            "ms_by_splits": {f"{s}{'' if m else '+merge'}": t
                             for (s, m), t in times.items()},
            "second_launch_us": merge_us, "walk_us": walk_us,
            "second_launch_share": merge_us / walk_us if walk_us else None}
    log("paged_decode_attention plan: " + json.dumps(line))
    return line


def phase_paged(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    timer = ctx["timer"]
    H, Hkv, D, bs, N = 32, 8, 128, 16, 1024
    # (label, B, M, lengths, timed): decode shapes, a pool of N shuffled
    # blocks, lengths from 1 to 2048 (= M * bs); one truncated context
    # bucket; serve's decode step (its 8 prompts of 24 to 297 bytes, 8
    # tokens into decode, in its 32-block bucket)
    cases = [
        ("B=1 M=128", 1, 128, [2048], True),
        ("B=8 M=128", 8, 128, [1, 17, 255, 512, 1000, 1500, 2047, 2048],
         True),
        ("B=8 M=64", 8, 64, [1, 16, 33, 300, 512, 777, 1000, 1024], False),
        ("serve B=8 M=32", 8, 32, [32, 71, 110, 149, 188, 227, 266, 305],
         True),
    ]
    # (D, B, H, Hkv, M, bs, lengths): other head dims, block sizes 8 and
    # 24, groups of 32 heads (two m16 tiles), each but two with a
    # length-0 row
    small = [(64, 4, 4, 1, 32, 16, [1, 40, 0, 511]),
             (192, 2, 8, 2, 8, 16, [70, 3]),
             (256, 2, 16, 2, 8, 16, [5, 128]),
             (128, 3, 32, 8, 16, 8, [0, 100, 128]),
             (128, 3, 32, 8, 10, 24, [0, 239, 240]),
             (128, 3, 32, 1, 16, 16, [0, 77, 256]),
             (256, 2, 32, 1, 8, 16, [0, 128])]
    worst = 0.0
    rows = {}
    for label, B, M, lengths, timed in cases:
        q, kp, vp, tables, lens = _paged_case(torch, gen, B, H, Hkv, D, bs,
                                              N, M, lengths)
        out = pa.paged_decode_attention(q, kp, vp, tables, lens)
        f32 = (q.float(), kp.float(), vp.float(), tables)
        ref = pa.paged_decode_attention_reference(*f32, lens)
        dropped = pa.paged_decode_attention_reference(*f32, _cut(lens))
        torch.cuda.synchronize()
        shape = (f"B={B} H={H} Hkv={Hkv} D={D} bs={bs} N={N} M={M} "
                 f"lengths={lengths}")
        err, share, d_share = _check_close(
            f"paged_decode_attention {shape}", out, ref, dropped)
        del f32
        worst = max(worst, err)
        line = {"shape": shape, "max_abs_err": err, "tol_share": share,
                "dropped_keys_tol_share": d_share}
        if timed:
            ms = timer(lambda: pa.paged_decode_attention(q, kp, vp, tables,
                                                         lens))
            plain = timer(lambda: pa.paged_decode_attention_reference(
                q, kp, vp, tables, lens), reps=5)
            host = timer.host(lambda: pa.paged_decode_attention(
                q, kp, vp, tables, lens))
            n_bytes, flops = _paged_work(B, H, Hkv, D, bs, M, lengths)
            bms, by = bound_ms(n_bytes, flops)
            line.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=None, host_ms=host)
            line["ms_clean_l2"] = timer(lambda: pa.paged_decode_attention(
                q, kp, vp, tables, lens), clean=True)
            line["plan"] = _paged_plan_choices(torch, timer, pa, rpa, q, kp,
                                               vp, tables, lens)
        if label == "B=8 M=128":
            _check_b2_is_b3(torch, pa, rpa, q, kp, vp, tables, lens)
        rows[label] = line
        log("paged_decode_attention: " + json.dumps(line))
    for D_, B, H_, Hkv_, M, bs_, lengths in small:
        q, kp, vp, tables, lens = _paged_case(torch, gen, B, H_, Hkv_, D_,
                                              bs_, B * M, M, lengths)
        out = pa.paged_decode_attention(q, kp, vp, tables, lens)
        f32 = (q.float(), kp.float(), vp.float(), tables)
        ref = pa.paged_decode_attention_reference(*f32, lens)
        dropped = pa.paged_decode_attention_reference(*f32, _cut(lens))
        err, share, d_share = _check_close(
            f"paged_decode_attention D={D_} bs={bs_}", out, ref, dropped)
        worst = max(worst, err)
        if 0 in lengths and bool(out[lengths.index(0)].any()):
            raise AssertionError("paged_decode_attention: a length-0 row is "
                                 "not 0")
        log(f"paged_decode_attention: D={D_} G={H_ // Hkv_} bs={bs_} "
            f"lengths={lengths} max |err| {err:.3e}, {share:.3f} of the "
            f"tolerance (dropped keys: {d_share:.2f})")
    # the summary row: the batch-8 decode step over a 128-block bucket
    ctx["paged"] = dict(rows["B=8 M=128"], max_abs_err=worst)


def _check_b2_is_b3(torch, pa, rpa, q, kp, vp, tables, lens):
    """B2 on a bf16 pool is B3's decode CTA with one table row per query
    row on B2's own tables: the same output bit for bit, each call raising
    its own wrapper's counter by one."""
    pa.paged_decode_attention.launches = 0
    rpa.ragged_paged_attention.launches = 0
    b2 = pa.paged_decode_attention(q, kp, vp, tables, lens)
    b3 = rpa.ragged_paged_attention(q, kp, vp, tables, lens,
                                    rows_per_table=1)
    torch.cuda.synchronize()
    counts = (pa.paged_decode_attention.launches,
              rpa.ragged_paged_attention.launches)
    if not torch.equal(b2, b3) or counts != (1, 1):
        raise AssertionError(f"paged_decode_attention is not B3 with "
                             f"rows_per_table=1 (equal {torch.equal(b2, b3)}"
                             f", launches B2/B3 {counts})")
    log("paged_decode_attention: B2 returned B3's output (rows_per_table=1) "
        "bit for bit; launches B2 1, B3 1")


def _ragged_inputs(torch, gen, rows, H, Hkv, D, bs, N, M, lengths, quant,
                   tables_mode):
    """A shuffled pool of ``N`` blocks (int8 through the port's
    ``quantize_kv_blocks`` when ``quant``) and its tables: one table per
    row (``"own"``), one table copied to every row (``"repeated"``, the
    continuation layout as the TPU kernel takes it), or one table row
    that every row shares (``"shared"``, passed with ``rows_per_table``)."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_kv_blocks,
    )

    q = torch.randn(rows, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    vp = torch.randn(N, bs, Hkv, D, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    perm = torch.randperm(N, generator=gen, device="cuda")
    tables = {"own": lambda: perm[: rows * M].reshape(rows, M),
              "repeated": lambda: perm[:M].repeat(rows, 1),
              "shared": lambda: perm[:M][None]}[tables_mode]()
    tables = tables.to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    ks = vs = None
    if quant:
        kp, ks = quantize_kv_blocks(kp)
        vp, vs = quantize_kv_blocks(vp)
    return q, kp, vp, ks, vs, tables, lens


def _ragged_work(tables, lengths, H, Hkv, D, bs, quant, rows_per_table=1,
                 row_table=None):
    """Bytes each input read once / output written once and FLOPs over the
    live keys, for B3 on these tables and lengths: q in and out, the
    lengths, each table row's live entries once, the live tokens of each
    distinct live K/V block once (int8 at 1 byte, bf16 at 2) and, for
    int8, each such block's two f32 scales; 4·D·H FLOPs per live key.
    ``row_table``: each row's table row (row groups), else row //
    ``rows_per_table``."""
    tab, lens = tables.tolist(), lengths.tolist()
    rows, M = len(lens), len(tab[0])
    n_bytes = 2 * (2 * rows * H * D) + 4 * rows
    live_tok, live_entries = {}, {}
    toks = 0
    for r in range(rows):
        n = min(max(lens[r], 0), M * bs)
        toks += n
        nb = -(-n // bs)
        tr = r // rows_per_table if row_table is None else row_table[r]
        live_entries[tr] = max(live_entries.get(tr, 0), nb)
        for j in range(nb):
            blk = tab[tr][j]
            live_tok[blk] = max(live_tok.get(blk, 0), min(bs, n - j * bs))
    n_bytes += 4 * sum(live_entries.values())
    n_bytes += 2 * sum(live_tok.values()) * Hkv * D * (1 if quant else 2)
    if quant:
        n_bytes += 2 * 4 * Hkv * len(live_tok)
    return n_bytes, 4 * D * H * toks


def phase_ragged(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    timer = ctx["timer"]
    H, Hkv, D, bs, N = 32, 8, 128, 16, 2048
    # (label, rows, lengths, M, tables mode): Llama-3-8B heads over the
    # full window M of a shuffled pool; decode at M = 128 (lengths 1 to
    # 2048) and at M = 256, serve_ragged's window (lengths to 4096); the
    # continuation layout of a 512-token chunk at start 1024, with the
    # table copied per row and with one shared table row
    # (rows_per_table = 512); a 441-row tail chunk at start 2560, M = 256
    cont = [1024 + t + 1 for t in range(512)]
    cases = [
        ("decode B=8", 8, [1, 17, 255, 512, 1000, 1500, 2047, 2048], 128,
         "own"),
        ("decode B=1", 1, [2048], 128, "own"),
        ("continuation 512 rows, start 1024", 512, cont, 128, "repeated"),
        ("continuation 512 rows, start 1024, rows_per_table=512", 512, cont,
         128, "shared"),
        ("tail chunk 441 rows, start 2560, rows_per_table=441", 441,
         [2560 + t + 1 for t in range(441)], 256, "shared"),
        ("decode B=8 M=256", 8, [1, 300, 1000, 2047, 2500, 3333, 4000, 4096],
         256, "own"),
        ("decode B=1 M=256", 1, [4096], 256, "own"),
    ]
    # (D, H, Hkv, M, bs, lengths): other head dims and groups, length-0
    # rows, and the largest block size in deploy/'s ConfigMaps
    small = [(64, 4, 1, 32, 16, [1, 40, 0, 511]),
             (192, 8, 2, 8, 16, [70, 0]),
             (256, 16, 2, 8, 16, [0, 128]),
             (128, 32, 8, 4, 1024, [4096, 0, 1500])]
    worst = 0.0
    rows = {}
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        for label, R, lengths, M, mode in cases:
            q, kp, vp, ks, vs, tables, lens = _ragged_inputs(
                torch, gen, R, H, Hkv, D, bs, N, M, lengths, quant, mode)
            rpt = R if mode == "shared" else 1
            args = (q, kp, vp, tables, lens, ks, vs)
            out = rpa.ragged_paged_attention(*args, rows_per_table=rpt)
            qf = q.float()
            ref = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, lens, ks, vs, rows_per_table=rpt)
            dropped = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, _cut(lens), ks, vs, rows_per_table=rpt)
            torch.cuda.synchronize()
            shape = (f"{label} {kind}: H={H} Hkv={Hkv} D={D} bs={bs} N={N} "
                     f"M={M} lengths "
                     + (f"{lengths[0]}..{lengths[-1]}" if R > 8
                        else str(lengths)))
            err, share, d_share = _check_close(
                f"ragged_paged_attention {shape}", out, ref, dropped)
            del qf, ref, dropped
            worst = max(worst, err)
            ms = timer(lambda: rpa.ragged_paged_attention(
                *args, rows_per_table=rpt))
            plain = timer(lambda: rpa.ragged_paged_attention_reference(
                *args, rows_per_table=rpt), reps=5)
            host = timer.host(lambda: rpa.ragged_paged_attention(
                *args, rows_per_table=rpt))
            n_bytes, flops = _ragged_work(tables.cpu(), lens.cpu(), H, Hkv,
                                          D, bs, quant, rpt)
            bms, by = bound_ms(n_bytes, flops)
            plan = rpa.ragged_plan(
                R, rpt, H, Hkv, bs, M, torch.cuda.get_device_properties(
                    q.device).multi_processor_count)
            line = {"shape": shape, "max_abs_err": err, "tol_share": share,
                    "dropped_keys_tol_share": d_share, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": None, "host_ms": host,
                    "rows_per_tile": plan[0], "splits": plan[1]}
            if label == "decode B=8" and not quant:
                # B2 on the same inputs, in the same call
                line["b2_ms"] = timer(lambda: pa.paged_decode_attention(
                    q, kp, vp, tables, lens))
            if label == "decode B=8" and quant:
                _check_b2_delegates(torch, pa, rpa, q, kp, vp, ks, vs,
                                    tables, lens, bs)
            rows[(label, kind)] = line
            log("ragged_paged_attention: " + json.dumps(line))
            del q, kp, vp, ks, vs, tables, lens, args, out
        for D_, H_, Hkv_, M_, bs_, lengths in small:
            R = len(lengths)
            q, kp, vp, ks, vs, tables, lens = _ragged_inputs(
                torch, gen, R, H_, Hkv_, D_, bs_, R * M_, M_, lengths, quant,
                "own")
            out = rpa.ragged_paged_attention(q, kp, vp, tables, lens, ks, vs)
            qf = q.float()
            ref = rpa.ragged_paged_attention_reference(qf, kp, vp, tables,
                                                       lens, ks, vs)
            dropped = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, _cut(lens), ks, vs)
            err, share, d_share = _check_close(
                f"ragged_paged_attention D={D_} bs={bs_} {kind}", out, ref,
                dropped)
            worst = max(worst, err)
            if bool(out[lengths.index(0)].any()):
                raise AssertionError("ragged_paged_attention: a length-0 row "
                                     "is not 0")
            log(f"ragged_paged_attention: D={D_} G={H_ // Hkv_} bs={bs_} "
                f"{kind} lengths={lengths} max |err| {err:.3e}, {share:.3f} "
                f"of the tolerance (dropped keys: {d_share:.2f})")
    worst = max(worst, _mixed_rows(ctx, torch, rpa, timer, gen))
    # the summary row: the int8 batch-8 decode step, the serving path's
    # most frequent launch
    ctx["ragged"] = dict(rows[("decode B=8", "int8")], max_abs_err=worst)


def _mixed_rows(ctx, torch, rpa, timer, gen) -> float:
    """B3 over the fused step's mixed rows (``mixed_phase_ragged_attention``,
    one launch over row groups) at the fused serve shape: B=8 decode rows
    (lengths 1 to 4096) and a C=512 chunk at starts 0, 512 and 2560, M=256,
    block 16, Llama-3-8B heads, over bf16 and int8 pools. Each against the
    plain version (the same tolerance and dropped-keys check as every B3
    case), timed from a flushed L2 beside its bytes bound and the two B3
    launches it replaces (the decode rows alone, the chunk alone with
    ``rows_per_table`` 512). Returns the largest error."""
    from scalable_hw_agnostic_inference_tpu_torch.ops.attention import (
        mixed_phase_groups,
        mixed_phase_ragged_attention,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_kv_blocks,
    )

    H, Hkv, D, bs, M, B, C = 32, 8, 128, 16, 256, 8, 512
    N = (B + 1) * M + 1
    dec_lens = [1, 300, 1000, 2047, 2500, 3333, 4000, 4096]
    worst, out_rows = 0.0, []
    for quant in (False, True):
        kind = "int8" if quant else "bf16"
        for start in (0, 512, 2560):
            # B + C query rows over B + 1 table rows of a shuffled pool
            q = torch.randn(B + C, H, D, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            kp, vp = (torch.randn(N, bs, Hkv, D, generator=gen,
                                  device="cuda", dtype=torch.bfloat16)
                      for _ in range(2))
            perm = torch.randperm(N, generator=gen, device="cuda")
            tables = perm[:(B + 1) * M].reshape(B + 1, M).to(
                torch.int32).contiguous()
            ks = vs = None
            if quant:
                kp, ks = quantize_kv_blocks(kp)
                vp, vs = quantize_kv_blocks(vp)
            q_dec, q_chunk = q[:B].contiguous(), q[B:].contiguous()
            t_dec, c_table = tables[:B].contiguous(), tables[B:].contiguous()
            pos_dec = torch.tensor([n - 1 for n in dec_lens],
                                   dtype=torch.int32, device="cuda")
            c_pos = torch.arange(start, start + C, dtype=torch.int32,
                                 device="cuda")
            lens = torch.cat([pos_dec, c_pos]) + 1
            groups = mixed_phase_groups(B, C)
            args = (q_dec, q_chunk, kp, vp, t_dec, c_table, pos_dec, c_pos,
                    ks, vs)
            o_dec, o_chk = mixed_phase_ragged_attention(*args)
            out = torch.cat([o_dec, o_chk])
            qf = q.float()
            ref = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, lens, ks, vs, groups=groups)
            dropped = rpa.ragged_paged_attention_reference(
                qf, kp, vp, tables, _cut(lens), ks, vs, groups=groups)
            torch.cuda.synchronize()
            shape = (f"mixed rows {kind}: B={B} decode rows (lengths "
                     f"{dec_lens[0]}..{dec_lens[-1]}) + a C={C} chunk at "
                     f"start {start}, H={H} Hkv={Hkv} D={D} bs={bs} M={M}")
            err, share, d_share = _check_close(
                f"ragged_paged_attention {shape}", out, ref, dropped)
            del qf, ref, dropped, out
            worst = max(worst, err)
            lens_dec = lens[:B].contiguous()
            lens_chk = lens[B:].contiguous()
            ms = timer(lambda: mixed_phase_ragged_attention(*args))
            dec_ms = timer(lambda: rpa.ragged_paged_attention(
                q_dec, kp, vp, t_dec, lens_dec, ks, vs))
            chk_ms = timer(lambda: rpa.ragged_paged_attention(
                q_chunk, kp, vp, c_table, lens_chk, ks, vs,
                rows_per_table=C))
            plain = timer(lambda: rpa.ragged_paged_attention_reference(
                q, kp, vp, tables, lens, ks, vs, groups=groups), reps=3)
            n_bytes, flops = _ragged_work(
                tables.cpu(), lens.cpu(), H, Hkv, D, bs, quant,
                row_table=[min(r, B) for r in range(B + C)])
            bms, by = bound_ms(n_bytes, flops)
            plan = rpa.groups_plan(groups, H, Hkv, bs, M,
                                   torch.cuda.get_device_properties(
                                       q.device).multi_processor_count)
            line = {"shape": shape, "max_abs_err": err, "tol_share": share,
                    "dropped_keys_tol_share": d_share, "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": None, "decode_alone_ms": dec_ms,
                    "chunk_alone_ms": chk_ms,
                    "two_launches_ms": dec_ms + chk_ms,
                    "rows_per_tile": plan[0], "decode_splits": plan[1]}
            out_rows.append(line)
            log("ragged_paged_attention mixed: " + json.dumps(line))
            del q, kp, vp, ks, vs, tables, args
    # the summary row: the int8 chunk at 2560 beside 8 decode rows
    ctx["ragged_mixed"] = out_rows[-1]
    return worst


def _check_b2_delegates(torch, pa, rpa, q, kp, vp, ks, vs, tables, lens,
                        bs):
    """B2 given int8 scales returns B3 on the caller's truncated tables,
    as the TPU kernel's int8 branch does: the same output as B3 called
    directly, with B3's counter rising and B2's not."""
    cut_t = tables[:, :64].contiguous()
    cut_l = lens.clamp_max(64 * bs)
    pa.paged_decode_attention.launches = 0
    rpa.ragged_paged_attention.launches = 0
    via_b2 = pa.paged_decode_attention(q, kp, vp, cut_t, cut_l, ks, vs)
    direct = rpa.ragged_paged_attention(q, kp, vp, cut_t, cut_l, ks, vs)
    torch.cuda.synchronize()
    counts = (pa.paged_decode_attention.launches,
              rpa.ragged_paged_attention.launches)
    if not torch.equal(via_b2, direct) or counts != (0, 2):
        raise AssertionError(f"paged_decode_attention with scales is not B3 "
                             f"(equal {torch.equal(via_b2, direct)}, "
                             f"launches B2/B3 {counts})")
    log("ragged_paged_attention: B2 with int8 scales returned B3's output "
        "exactly; launches B2 0, B3 2")


def _step_wall_ms(torch, fn, reps: int = 20) -> float:
    """Median wall ms of one call of ``fn`` from the host's enqueue to the
    device's end (a synchronize after each call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_step(torch, fn, calls: int = 10):
    """``(device ms, kernel launches)`` per call of ``fn`` (profiler);
    ``(None, None)`` when the profiler records no device activity."""
    by_kernel = _device_us_by_kernel(torch, fn, calls)
    if not by_kernel:
        return None, None
    return (sum(us for us, _ in by_kernel.values()) / 1e3,
            sum(n for _, n in by_kernel.values()))


def _decode_graph_case(ctx, torch, what, lengths, ragged, quant, M):
    """One decode key at full width: a pool of random blocks behind
    shuffled tables, 8 rows at ``lengths`` (half greedy, half sampled),
    captured as a graph and held against the eager call of the same decode
    function on the same inputs and draws."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.cache import (
        PagedKVCache,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
        DecodeGraph,
        GraphPool,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.runner import (
        make_decode,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        ragged_paged_attention as rpa,
    )

    cfg, model = _engine_model(ctx)
    B, bs = len(lengths), 16
    N = B * M + 1
    gen = torch.Generator(device="cuda").manual_seed(11)
    cache = PagedKVCache(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, N, bs,
                         M, dtype=torch.bfloat16, device="cuda", quant=quant)
    for lay in cache.kv:
        for name, t in lay.items():
            if name in ("ks", "vs"):
                t.uniform_(0.5 / 127, 3.0 / 127, generator=gen)
            elif quant:
                t.random_(-127, 128, generator=gen)
            else:
                t.normal_(generator=gen)
    perm = torch.randperm(N - 1, generator=gen, device="cuda") + 1
    tables = perm[: B * M].reshape(B, M).to(torch.int32)
    pool = GraphPool(torch.device("cuda", torch.cuda.current_device()))
    pool.reserve([rpa.split_scratch_size(
        B, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, bs, M,
        rpa.sm_count(torch.cuda.current_device()))])
    decode = make_decode(cfg, bs, M, B, ctx_blocks=M, ragged=ragged,
                         kv_quant=quant, feedback=True)
    g = DecodeGraph((M, B), decode, model, cache.kv, B, M, cfg.vocab_size,
                    device="cuda", pool=pool)
    a = g.inputs
    a["tokens"].copy_(torch.randint(3, cfg.vocab_size, (B,), generator=gen,
                                    device="cuda", dtype=torch.int32))
    a["pos"].copy_(torch.tensor(lengths, device="cuda") - 1)
    a["tables"].copy_(tables)
    a["temp"].copy_(torch.tensor([0, 0, 0, 0, 1, 1, 0.7, 0.7],
                                 device="cuda")[:B])
    a["topk"].copy_(torch.tensor([0, 0, 0, 0, 0, 50, 0, 0],
                                 device="cuda")[:B])
    a["topp"].copy_(torch.tensor([1, 1, 1, 1, 1, 1, 0.9, 1.0],
                                 device="cuda")[:B])
    _reset_counters()
    g.capture()
    captured = _read_counters()
    from scalable_hw_agnostic_inference_tpu_torch.engine.graphs import (
        OUTPUTS,
    )

    name = ("ragged_paged_attention" if ragged or quant
            else "paged_decode_attention")
    if g.launches != {name: cfg.n_layers}:
        raise AssertionError(f"{what}: the graph holds launches "
                             f"{g.launches}, want {cfg.n_layers} of {name}")
    # the eager call and the replay on the same inputs and draws: the
    # replay's decode writes each row's key and value again (the same
    # values), so it attends the same pool
    gen_u = torch.Generator(device="cuda").manual_seed(5)
    g.draw(gen_u)
    eager_outs = dict(zip(OUTPUTS, g.eager()))
    _reset_counters()
    g.replay()
    torch.cuda.synchronize()
    replay_counts = _read_counters()
    # tokens, positions and the three logprob readouts, bit for bit
    equal = {n: torch.equal(getattr(g, n), e) for n, e in eager_outs.items()}
    exact = all(equal.values())
    diff = (g.top_lp - eager_outs["top_lp"]).abs().max().item()
    if not (bool(torch.isfinite(g.top_lp).all())
            and bool(torch.isfinite(g.tok_lp).all())):
        raise AssertionError(f"{what}: non-finite logprobs")
    # a greedy row's token is its readout's top id
    if not torch.equal(g.top_ids[:4, 0], g.nxt[:4]):
        raise AssertionError(f"{what}: greedy tokens are not the top ids")
    greedy_equal = torch.equal(g.nxt[:4], eager_outs["nxt"][:4])
    # consecutive replays draw afresh: a sampled row's uniforms change
    u0 = g.uniforms.clone()
    first = g.nxt.clone()
    g.draw(gen_u)
    g.replay()
    torch.cuda.synchronize()
    redrawn = not torch.equal(u0, g.uniforms)
    resampled = not torch.equal(first[4:], g.nxt[4:])
    still_greedy = torch.equal(first[:4], g.nxt[:4])

    def eager_step():
        g.draw(gen_u)
        g.eager()

    def replay_step():
        g.draw(gen_u)
        g.replay()

    wall_eager = _step_wall_ms(torch, eager_step)
    wall_replay = _step_wall_ms(torch, replay_step)
    dev_eager, launches_eager = _device_step(torch, eager_step)
    dev_replay, launches_replay = _device_step(torch, replay_step)
    line = {
        "case": what, "B": B, "M": M, "lengths": lengths,
        "ragged": ragged, "int8": quant,
        "bit_exact": exact, "outputs_equal": equal,
        "max_abs_top_lp_diff": diff,
        "greedy_tokens_equal": greedy_equal,
        "redrawn": redrawn, "sampled_rows_changed": resampled,
        "greedy_rows_unchanged": still_greedy,
        "graph_launches": g.launches, "capture_counts": captured,
        "replay_counts": replay_counts,
        "capture_s": g.capture_seconds, "pool_bytes": pool.bytes(),
        "wall_ms_eager": wall_eager, "wall_ms_replay": wall_replay,
        "device_ms_eager": dev_eager, "device_ms_replay": dev_replay,
        "kernels_per_eager_step": launches_eager,
        "kernels_per_replay": launches_replay,
    }
    log("decode_graph: " + json.dumps(line))
    del g, cache
    gc.collect()
    torch.cuda.empty_cache()
    if replay_counts[name] != cfg.n_layers:
        raise AssertionError(f"{what}: one replay counted {replay_counts}")
    if not exact:
        raise AssertionError(f"{what}: the replay is not the eager call bit "
                             f"for bit ({equal}, max top-logprob diff "
                             f"{diff}, greedy tokens equal {greedy_equal})")
    if not (redrawn and resampled and still_greedy):
        raise AssertionError(f"{what}: draws {redrawn}, sampled rows changed "
                             f"{resampled}, greedy rows kept {still_greedy}")
    return line


def _readout_cost(ctx, torch, B: int = 8) -> dict:
    """The logprob readout alone (``runner.token_logprobs``: a log-softmax,
    a top-5 and a gather over ``[B, V]`` f32 logits) at serve's decode
    shape: CUDA-event time of one call with a cold L2, its kernels and
    device time from the profiler, and its bytes bound (the logits read
    once, the outputs written once)."""
    from scalable_hw_agnostic_inference_tpu_torch.engine.runner import (
        K_LOGPROBS,
        token_logprobs,
    )

    cfg, _ = _engine_model(ctx)
    gen = torch.Generator(device="cuda").manual_seed(12)
    logits = torch.randn(B, cfg.vocab_size, generator=gen, device="cuda")
    toks = logits.argmax(-1).to(torch.int32)
    ms = ctx["timer"](lambda: token_logprobs(logits, toks))
    by_kernel = _device_us_by_kernel(torch, lambda: token_logprobs(logits,
                                                                   toks))
    n_bytes = 4 * B * cfg.vocab_size + 4 * B + B * (2 * 4 * K_LOGPROBS + 4)
    line = {"B": B, "V": cfg.vocab_size, "ms": ms,
            "bound_ms": bound_ms(n_bytes, 0)[0],
            "device_us_by_kernel": {k: round(us, 2) for k, (us, _)
                                    in by_kernel.items()},
            "device_ms": (sum(us for us, _ in by_kernel.values()) / 1e3
                          if by_kernel else None)}
    log("decode_graph: logprob readout " + json.dumps(line))
    return line


def phase_decode_graph(ctx):
    import torch

    ctx["readout"] = _readout_cost(ctx, torch)
    ctx["decode_graph"] = [
        # serve's bucketed decode step: its 32-block bucket, bf16 pool
        _decode_graph_case(ctx, torch, "serve bucketed bf16",
                           [32, 71, 110, 149, 188, 227, 266, 305], False,
                           False, 32),
        # serve_ragged's: the full 256-block window over an int8 pool
        _decode_graph_case(ctx, torch, "ragged int8 full window",
                           [1, 17, 255, 512, 1000, 2047, 3000, 4096], True,
                           True, 256),
    ]


KERNELS = ("flash_attention", "paged_decode_attention",
           "ragged_paged_attention")


def _counters():
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    return {"flash_attention": fa.flash_attention,
            "paged_decode_attention": pa.paged_decode_attention,
            "ragged_paged_attention": rpa.ragged_paged_attention}


def _reset_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {name: fn.launches for name, fn in _counters().items()}


def _check_counters(what: str, counts, expect) -> None:
    """Exactly the kernels in ``expect`` were launched in the run."""
    wrong = [k for k in KERNELS if bool(counts[k]) != (k in expect)]
    if wrong:
        raise AssertionError(f"{what}: launches {counts}; expected exactly "
                             f"{sorted(expect)} to rise")


def _engine_model(ctx):
    """The engine phases' model, built once: Llama-3-8B widths,
    ``ENGINE_LAYERS`` layers, seeded N(0, 0.02) bf16 weights."""
    if "engine_model" not in ctx:
        import dataclasses

        from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
            LlamaConfig,
            LlamaForCausalLM,
            random_params,
        )

        cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                                  n_layers=ENGINE_LAYERS)
        t0 = time.monotonic()
        ctx["engine_model"] = cfg, LlamaForCausalLM.from_state_dict(
            cfg, random_params(cfg, seed=0, std=0.02, device="cuda"))
        log(f"engine model: Llama-3-8B widths, {cfg.n_layers} of 32 layers, "
            f"seeded N(0, 0.02) weights, built in "
            f"{time.monotonic() - t0:.1f} s")
    return ctx["engine_model"]


def _drop_engine_model(ctx) -> None:
    import torch

    ctx.pop("engine_model", None)
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _plain_attention():
    """Swap every attention kernel the engine and the scoring forward call
    for its plain PyTorch version (fp32 softmax), then restore them."""
    from scalable_hw_agnostic_inference_tpu_torch.engine import runner
    from scalable_hw_agnostic_inference_tpu_torch.ops import attention
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
        paged_attention as pa,
        ragged_paged_attention as rpa,
    )

    def flash(q, k, v, *, causal=False, scale=None, lengths=None):
        return fa.flash_attention_reference(q, k, v, causal=causal,
                                            scale=scale, lengths=lengths)

    def paged(q, kp, vp, tables, lengths, k_scale=None, v_scale=None, *,
              scale=None):
        if k_scale is not None:
            return rpa.ragged_paged_attention_reference(
                q, kp, vp, tables, lengths, k_scale, v_scale, scale=scale)
        return pa.paged_decode_attention_reference(q, kp, vp, tables,
                                                   lengths, scale=scale)

    ragged = rpa.ragged_paged_attention_reference
    swaps = [(attention, "flash_attention", flash),
             (attention, "_ragged_kernel", ragged),
             (runner, "ragged_kernel", ragged),
             (runner, "paged_decode_attention", paged)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _graphs(eng):
    """Every captured graph of the engine: the decode keys, and under the
    fused step the fused keys and the chunk-only graph."""
    out = list(eng._decode_fns.values()) + list(eng._fused_fns.values())
    return out + ([eng._fused_chunk] if eng._fused_chunk is not None else [])


def _replays(eng):
    return {g.key: g.replays for g in _graphs(eng)}


def _count_chunks(eng):
    """Count the engine's continuation chunks from here on (each ragged
    chunk launches B3 once per layer); returns the counter list."""
    calls = []
    inner = eng._continue_prefill

    def counted(s):
        calls.append(1)
        return inner(s)

    eng._continue_prefill = counted
    return calls


def _expected_walk(eng, before, chunks):
    """B2's and B3's exact launch counts since ``before`` (the graphs'
    replay counts then): each replay adds the launches its graph captured,
    and each laddered ragged continuation chunk launches B3 once per
    layer (under the fused step every chunk rides a replay)."""
    out = {"paged_decode_attention": 0, "ragged_paged_attention": 0}
    for g in _graphs(eng):
        n = g.replays - before.get(g.key, 0)
        for name, per in g.launches.items():
            if name in out:
                out[name] += per * n
    if eng._ragged and not eng._fused:
        out["ragged_paged_attention"] += eng.cfg.n_layers * len(chunks)
    return out


def _check_walk(what: str, counts, expect) -> None:
    got = {k: counts[k] for k in expect}
    if got != expect:
        raise AssertionError(f"{what}: B2/B3 launches {got}, the decode "
                             f"replays and chunks make {expect}")


def _generate(ctx, prompts, switches, all_lp=False):
    """One engine run of greedy requests under the engine switches (async
    decode unless they say otherwise), its closed set warmed first; the
    even rows (``all_lp``: every row) ask for 5 logprobs. Returns the
    finished requests, the launch counts, the seconds, the continuation
    keys it compiled, its leaked blocks and a dict of the pipeline's
    numbers."""
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
        SamplingParams,
    )

    cfg, model = _engine_model(ctx)
    ecfg = EngineConfig(max_model_len=2048, max_num_seqs=4, block_size=16,
                        context_encoding_buckets=(128, 512),
                        max_new_tokens=ENGINE_NEW_TOKENS)
    env = {"SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": "",
           "SHAI_ASYNC_DECODE": "1", **switches}
    with _env(env):
        eng = LLMEngine(cfg, model, ecfg, device="cuda")
        t0 = time.monotonic()
        n_warm = eng.warm_executables()
        warm_s = time.monotonic() - t0
        before = _replays(eng)
        chunks = _count_chunks(eng)
        _reset_counters()
        t0 = time.monotonic()
        ids = [eng.add_request(p, SamplingParams(
            temperature=0.0, max_new_tokens=ENGINE_NEW_TOKENS,
            logprobs=0 if i % 2 and not all_lp else 5))
            for i, p in enumerate(prompts)]
        done = {}
        while set(ids) - set(done):
            for f in eng.step():
                done[f.req_id] = f
        fins = [done[i] for i in ids]
        eng.finish_pending()
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        counts = _read_counters()
    for i, f in enumerate(fins):
        if len(f.token_ids) != ENGINE_NEW_TOKENS:
            raise AssertionError(f"{len(f.token_ids)} tokens, want "
                                 f"{ENGINE_NEW_TOKENS}")
        if f.logprobs and [e["token"] for e in f.logprobs] != f.token_ids:
            raise AssertionError("the logprob entries do not name the "
                                 "returned tokens")
    conts = sorted(k for k in eng._prefill if k[0] in ("cont", "rcont"))
    info = {"async": eng._async, "warmed": n_warm, "warm_s": warm_s,
            "recompiles": eng.obs.recompiles,
            "replays": sum(_replays(eng).values()) - sum(before.values()),
            "chunks": len(chunks),
            "flushes": eng.obs.flush_reasons(),
            "walk": _expected_walk(eng, before, chunks),
            "fused": eng._fused,
            "chunk_only_replays": (eng._fused_chunk.replays
                                   - before.get(eng._fused_chunk.key, 0)
                                   if eng._fused_chunk is not None else 0),
            "per_replay": sorted({n for g in _graphs(eng)
                                  for n in g.launches.values()})}
    # one replay of the largest batch key, host enqueue to device end: a
    # fused key computes its whole chunk window even when it is the null
    # one (its inputs are the last step's; the pool is free by now)
    big = max((g for g in _graphs(eng) if g.key != ("chunk", 1)),
              key=lambda g: g.inputs["tokens"].shape[0])
    with torch.inference_mode():
        if eng._fused:
            big.load_window(None)
        info["replay_ms"] = _step_wall_ms(torch, big.replay)
    return fins, counts, seconds, conts, eng.cache.leaked_blocks, info


def _score(model, prompts, fins):
    """Score each run's tokens with the full-sequence scoring forward,
    through B1 and through B1's plain version: ``{"b1": (argmax hits,
    worst logit deficit), "plain": (hits, worst), "tokens": n, "eps":
    eps, "lp_err": e, "lp_err_shifted": s}``, where eps is the largest
    logit change between the two, e the largest distance of a returned
    logprob from the plain forward's log-softmax at its token, and s the
    same distance one position off (what a misaligned readout would
    show)."""
    import torch

    score = {"b1": (0, 0.0), "plain": (0, 0.0), "tokens": 0, "eps": 0.0,
             "lp_err": 0.0, "lp_err_shifted": 0.0}
    with torch.inference_mode():
        for p, f in zip(prompts, fins):
            ids = torch.tensor([p + f.token_ids], device="cuda")
            logits = model(ids)[0, len(p) - 1: -1].float()  # each token's
            with _plain_attention():
                plain = model(ids)[0, len(p) - 1: -1].float()
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("non-finite scoring logits")
            score["eps"] = max(score["eps"],
                               (logits - plain).abs().max().item())
            tok = torch.tensor(f.token_ids, device="cuda")
            if f.logprobs:
                got = torch.tensor([e["logprob"] for e in f.logprobs],
                                   device="cuda")
                lsm = torch.log_softmax(plain, -1)
                want = lsm.gather(1, tok[:, None])[:, 0]
                score["lp_err"] = max(score["lp_err"],
                                      (got - want).abs().max().item())
                off = lsm[1:].gather(1, tok[:-1, None])[:, 0]
                score["lp_err_shifted"] = max(
                    score["lp_err_shifted"],
                    (got[:-1] - off).abs().max().item())
            for key, lg in (("b1", logits), ("plain", plain)):
                deficit = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
                hits, worst = score[key]
                score[key] = (hits + int((lg.argmax(-1) == tok).sum()),
                              max(worst, deficit.max().item()))
            score["tokens"] += len(f.token_ids)
    return score


def _run_engine(ctx, what, prompt_lens, switches, expect, cont_key, rule):
    """Generate ``ENGINE_NEW_TOKENS`` greedy tokens for prompts of
    ``prompt_lens`` tokens under the engine switches ``switches`` and
    score them: ``rule`` "tie" holds the worst deficit against the plain
    scoring forward to ``TIE_TOL``, "noise" the worst against the scoring
    forward through B1 to ``NOISE_TIES * eps``, and "int8" to that too
    and also the argmax hits to those of the same engine run through the
    kernels' plain versions less ``INT8_SLACK``. "tie" and "int8" log that
    plain run's own deficits. The run must chunk (``cont_key`` names the
    continuation it compiles), launch exactly the kernels ``expect`` and
    leak no block."""
    import torch

    cfg, model = _engine_model(ctx)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in prompt_lens]
    fins, counts, seconds, conts, leaked, info = _generate(ctx, prompts,
                                                          switches)
    _check_walk(what, counts, info["walk"])
    # the same requests lock-step: the same tokens, the same device work
    sync = _generate(ctx, prompts, {**switches, "SHAI_ASYNC_DECODE": "0"})
    if not info["async"] or sync[5]["async"]:
        raise AssertionError(f"{what}: async {info['async']} / lock-step "
                             f"{not sync[5]['async']}")
    if [f.token_ids for f in fins] != [f.token_ids for f in sync[0]]:
        raise AssertionError(f"{what}: async and lock-step tokens differ")
    if [f.logprobs for f in fins] != [f.logprobs for f in sync[0]]:
        raise AssertionError(f"{what}: async and lock-step logprob entries "
                             f"differ")
    _check_walk(f"{what} lock-step", sync[1], sync[5]["walk"])
    log(f"{what}: async {seconds:.2f} s, lock-step {sync[2]:.2f} s, tokens "
        f"and logprob entries equal; async {json.dumps(info)}; lock-step "
        f"{json.dumps(sync[5])}")
    s = _score(model, prompts, fins)
    (exact, worst), (p_hits, p_worst), total = s["b1"], s["plain"], \
        s["tokens"]
    eps = s["eps"]
    log(f"{what}: {switches or 'default switches'}; prompts "
        f"{list(prompt_lens)} x {ENGINE_NEW_TOKENS} greedy tokens in "
        f"{seconds:.2f} s; {exact}/{total} equal the scoring argmax, worst "
        f"logit deficit {worst:.4f} ({p_hits}/{total} and {p_worst:.4f} "
        f"against the plain scoring forward), eps {eps:.4f}; logprobs "
        f"within {s['lp_err']:.4f} of the plain forward's log-softmax (one "
        f"position off: {s['lp_err_shifted']:.4f}); continuations "
        f"{conts}; launches {counts}; leaked blocks {leaked}")
    if rule == "tie" and p_worst > TIE_TOL:
        raise AssertionError(f"{what}: worst deficit {p_worst:.4f} against "
                             f"the plain scoring forward over the tie "
                             f"tolerance {TIE_TOL}")
    if rule == "tie" and s["lp_err"] > LP_TOL:
        raise AssertionError(f"{what}: a logprob is {s['lp_err']:.4f} from "
                             f"the plain scoring forward's, over {LP_TOL}")
    if rule in ("noise", "int8") and worst > NOISE_TIES * eps:
        raise AssertionError(f"{what}: worst deficit {worst:.4f} over "
                             f"{NOISE_TIES} * eps = {NOISE_TIES * eps:.4f}")
    if rule in ("tie", "int8"):
        with _plain_attention():
            p_fins, p_counts, _, _, _, _ = _generate(ctx, prompts,
                                                     switches)
        ps = _score(model, prompts, p_fins)
        log(f"{what}: the same engine through the kernels' plain versions: "
            f"{ps['b1'][0]}/{total} equal the scoring argmax, worst deficit "
            f"{ps['b1'][1]:.4f} ({ps['plain'][0]}/{total} and "
            f"{ps['plain'][1]:.4f} against the plain scoring forward); "
            f"launches {p_counts}")
        _check_counters(f"{what} plain", p_counts, ())
        if rule == "int8" and exact < ps["b1"][0] - INT8_SLACK * total:
            raise AssertionError(f"{what}: {exact}/{total} tokens are the "
                                 f"scoring argmax, the plain versions' run "
                                 f"{ps['b1'][0]}/{total}")
    if leaked:
        raise AssertionError(f"{what}: leaked KV blocks")
    if cont_key not in conts:
        raise AssertionError(f"{what}: no chunk ran through {cont_key}")
    _check_counters(what, counts, expect)


def phase_engine(ctx):
    # bucketed bf16: prefill, static-start continuation and scoring through
    # B1, decode through B2
    _run_engine(ctx, "engine", (5, 37, 120, 300, 1300), {},
                {"flash_attention", "paged_decode_attention"},
                ("cont", 32, 512), "tie")


def _tie_diverge(got, want):
    """``tests/parity.py``'s greedy tie rule: each of ``got``'s token
    streams equals ``want``'s, or parts from it where ``want``'s top-2
    logprobs are within ``TIE_GAP`` (a near-tie of bf16 rounding). Returns
    the gaps at the partings; raises at a decisive one."""
    gaps = []
    for g, w in zip(got, want):
        if g.token_ids == w.token_ids:
            continue
        i = next((n for n, (a, b) in enumerate(zip(g.token_ids, w.token_ids))
                  if a != b), min(len(g.token_ids), len(w.token_ids)))
        if i >= len(w.logprobs):
            continue
        top = w.logprobs[i]["top_logprobs"]
        gap = float(top[0]) - float(top[1])
        gaps.append(gap)
        if gap >= TIE_GAP:
            raise AssertionError(f"diverged at token {i} with a decisive "
                                 f"margin {gap:.4f} >= {TIE_GAP}: "
                                 f"{g.token_ids} != {w.token_ids}")
    return gaps


def _run_fused(ctx, what, switches):
    """The fused engine (``SHAI_FUSED_STEP=1``) on the engine_ragged
    prompts, async and lock-step, against the laddered ragged engine under
    the same switches: the tie rule on the tokens, async equal to
    lock-step, B3 exactly the layers times the fused and chunk-only
    replays (no eager continuation launch, no continuation function),
    no leaked block."""
    cfg, _ = _engine_model(ctx)
    import torch

    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in ENGINE_PROMPTS]
    fused_sw = {**switches, "SHAI_FUSED_STEP": "1"}
    fins, counts, seconds, conts, leaked, info = _generate(ctx, prompts,
                                                           fused_sw)
    _check_walk(what, counts, info["walk"])
    if not info["fused"] or conts or info["per_replay"] != [cfg.n_layers]:
        raise AssertionError(f"{what}: fused {info['fused']}, continuation "
                             f"functions {conts}, B3 launches per replay "
                             f"{info['per_replay']}")
    sync = _generate(ctx, prompts, {**fused_sw, "SHAI_ASYNC_DECODE": "0"})
    if [f.token_ids for f in fins] != [f.token_ids for f in sync[0]]:
        raise AssertionError(f"{what}: async and lock-step tokens differ")
    _check_walk(f"{what} lock-step", sync[1], sync[5]["walk"])
    lad = _generate(ctx, prompts, {**switches, "SHAI_FUSED_STEP": "0"},
                    all_lp=True)
    gaps = _tie_diverge(fins, lad[0])
    same = sum(f.token_ids == w.token_ids for f, w in zip(fins, lad[0]))
    log(f"{what}: {switches}; fused async {seconds:.2f} s, lock-step "
        f"{sync[2]:.2f} s, laddered {lad[2]:.2f} s; {same}/{len(fins)} "
        f"token streams equal the laddered run's (tie gaps at the partings "
        f"{gaps}); async {json.dumps(info)}; lock-step "
        f"{json.dumps(sync[5])}; laddered {json.dumps(lad[5])}; launches "
        f"{counts}; leaked blocks {leaked}")
    if leaked or sync[4] or lad[4]:
        raise AssertionError(f"{what}: leaked KV blocks")
    _check_counters(what, counts, {"flash_attention",
                                   "ragged_paged_attention"})
    ctx.setdefault("engine_fused", {})[what] = {
        "equal_streams": same, "streams": len(fins), "tie_gaps": gaps,
        "chunks": info["chunks"],
        "chunk_only_replays": info["chunk_only_replays"],
        "b3_launches": counts["ragged_paged_attention"],
        "fused_replay_ms": info["replay_ms"],
        "laddered_replay_ms": lad[5]["replay_ms"]}


def phase_engine_fused(ctx):
    # (a) bf16, (b) int8: decode and every chunk through the fused graphs'
    # mixed-row B3 launches (the serve phases drop the model)
    _run_fused(ctx, "engine_fused (a)", {"SHAI_RAGGED_ATTENTION": "1"})
    _run_fused(ctx, "engine_fused (b)", {"SHAI_RAGGED_ATTENTION": "1",
                                          "SHAI_KV_QUANT": "int8"})


def phase_engine_ragged(ctx):
    # (a) ragged bf16: decode and the continuation through B3
    _run_engine(ctx, "engine_ragged (a)", ENGINE_PROMPTS,
                {"SHAI_RAGGED_ATTENTION": "1"},
                {"flash_attention", "ragged_paged_attention"},
                ("rcont", 512), "noise")
    # (b) ragged int8
    _run_engine(ctx, "engine_ragged (b)", ENGINE_PROMPTS,
                {"SHAI_RAGGED_ATTENTION": "1", "SHAI_KV_QUANT": "int8"},
                {"flash_attention", "ragged_paged_attention"},
                ("rcont", 512), "int8")
    # (c) bucketed int8: decode through B2's delegation to B3, the static
    # continuation through B1 on the dequantized prior blocks
    _run_engine(ctx, "engine_ragged (c)", ENGINE_PROMPTS,
                {"SHAI_KV_QUANT": "int8"},
                {"flash_attention", "ragged_paged_attention"},
                ("cont", 32, 512), "int8")


def _http(url: str, payload=None, timeout: float = 300.0, headers=None,
          raw: bool = False):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return r.status, (body.decode() if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _serve_prompts(long_bytes=()):
    """``SERVE_REQUESTS`` prompts of mixed length (prefill buckets 128 and
    512); the last ``len(long_bytes)`` are about that many bytes long
    instead (the tokenizer is byte-level)."""
    prompts = [f"request {i}: " + "tell me more " * (3 * i + 1)
               for i in range(SERVE_REQUESTS)]
    for j, n in enumerate(long_bytes):
        i = SERVE_REQUESTS - len(long_bytes) + j
        text = f"request {i}: " + "tell me more about paged attention. " * (
            n // 36 + 1)
        prompts[i] = text[:n]
    return prompts


def _send_concurrent(base: str, prompts):
    """One concurrent greedy ``POST /generate`` per prompt; returns the
    responses and the wall seconds."""
    results = [None] * len(prompts)

    def one(i):
        results[i] = _http(base + "/generate", {
            "prompt": prompts[i], "temperature": 0.0, "max_new_tokens": 16})

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, time.monotonic() - t0


def _stream_completion(base: str, prompt: str):
    """One streamed greedy ``POST /v1/completions``: ``(status, seconds to
    the first SSE chunk, seconds to the end, the data payloads)``."""
    body = json.dumps({"prompt": prompt, "max_tokens": 16,
                       "temperature": 0, "stream": True}).encode()
    req = urllib.request.Request(base + "/v1/completions", data=body,
                                 headers={"content-type": "application/json"})
    t0 = time.monotonic()
    first, events = None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        status = r.status
        while True:
            line = r.readline()   # the chunked framing is undone here
            if not line:
                break
            if line.startswith(b"data: "):
                if first is None:
                    first = time.monotonic() - t0
                events.append(line[len(b"data: "):].strip().decode())
    return status, first, time.monotonic() - t0, events


def _pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


#: the ``/metrics`` families of the serving contract (the reference's
#: names and types): requests and latency, the engine's histograms,
#: gauges and counters
METRIC_FAMILIES = {
    "shai_requests_total": "counter",
    "shai_request_latency_seconds": "histogram",
    "shai_ttft_seconds": "histogram", "shai_tpot_seconds": "histogram",
    "shai_queue_wait_seconds": "histogram",
    "shai_engine_step_gap_seconds": "histogram",
    **{f"shai_engine_{g}": "gauge" for g in (
        "running", "waiting", "chunking", "kv_utilization", "kv_occupancy",
        "kv_blocks_free", "pad_fraction")},
    **{f"shai_engine_{c}_total": "counter" for c in (
        "steps", "preemptions", "recompiles", "requests_finished",
        "pipeline_flushes")},
}


def _openai_round(ctx, what, base, eng, prompts, expect):
    """The OpenAI routes on the served engine: ``len(prompts)`` concurrent
    streamed completions (client time to the first SSE chunk beside the
    engine's TTFT), ``n=2``, ``logprobs: 5`` on the zero-weight tier
    (uniform: every logprob ``-log(vocab)``), an expired deadline (504)
    and a ``/metrics`` scrape. Exactly the kernels ``expect`` rise, B2/B3
    exactly 32 per replay."""
    import math

    from scalable_hw_agnostic_inference_tpu_torch.utils.latency import (
        LatencyCollector,
    )

    eng.ttft = LatencyCollector()
    before = _replays(eng)
    chunks = _count_chunks(eng)
    _reset_counters()
    results = [None] * len(prompts)

    def one(i):
        results[i] = _stream_completion(base, prompts[i])

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    bad = [r for r in results if r is None or r[0] != 200
           or r[3][-1] != "[DONE]"]
    if bad:
        raise AssertionError(f"{what}: failed streams {bad[:2]}")
    finals = [json.loads(r[3][-2])["choices"][0]["finish_reason"]
              for r in results]
    firsts, ends = [r[1] for r in results], [r[2] for r in results]
    ttft = eng.ttft.report()
    line = {"streams": len(prompts), "wall_s": wall,
            "client_first_chunk_ms": {"p50": _pct(firsts, 0.5) * 1e3,
                                      "p99": _pct(firsts, 0.99) * 1e3},
            "client_done_ms": {"p50": _pct(ends, 0.5) * 1e3,
                               "p99": _pct(ends, 0.99) * 1e3},
            "engine_ttft_ms": {"p50": ttft["p50"] * 1e3,
                               "p99": ttft["p99"] * 1e3},
            "chunks_per_stream": [len(r[3]) - 1 for r in results],
            "finish_reasons": finals}
    # n = 2: two choices of one prompt
    status, out = _http(base + "/v1/completions", {
        "prompt": prompts[0], "max_tokens": 8, "temperature": 0, "n": 2})
    if status != 200 or len(out["choices"]) != 2 or \
            out["usage"]["completion_tokens"] != 16:
        raise AssertionError(f"{what}: n=2 gave {status} {out}")
    # logprobs on the zero-weight tier: a uniform distribution
    status, out = _http(base + "/v1/completions", {
        "prompt": prompts[1], "max_tokens": 8, "temperature": 0,
        "logprobs": 5})
    uniform = -math.log(eng.cfg.vocab_size)
    lps = out["choices"][0]["logprobs"] if status == 200 else None
    lp_err = max(abs(v - uniform) for v in lps["token_logprobs"]
                 + [x for d in lps["top_logprobs"] for x in d.values()]) \
        if lps else None
    if lps is None or len(lps["token_logprobs"]) != 8 or \
            lp_err > GEOMETRY_LP_ATOL:
        raise AssertionError(f"{what}: logprobs {status} {out}, max "
                             f"|lp + log V| {lp_err}")
    line["logprobs_max_err_vs_uniform"] = lp_err
    # a budget of 1 ms: the deadline passes before the first step
    status, out = _http(base + "/v1/completions", {
        "prompt": prompts[2], "max_tokens": 8}, headers={
        "X-SHAI-Deadline-Ms": "1"})
    if status != 504:
        raise AssertionError(f"{what}: an expired deadline gave {status} "
                             f"{out}")
    line["deadline_504"] = out["detail"]
    counts = _read_counters()
    exact = _expected_walk(eng, before, chunks)
    _check_counters(f"{what} OpenAI round", counts, expect)
    _check_walk(f"{what} OpenAI round", counts, exact)
    line.update(launches=counts, walk=exact)
    # the /metrics page: the contract families, with their types
    status, text = _http(base + "/metrics", raw=True)
    types_ = dict(ln.split()[2:4] for ln in text.splitlines()
                  if ln.startswith("# TYPE "))
    missing = {n: t for n, t in METRIC_FAMILIES.items()
               if types_.get(n) != t}
    if status != 200 or missing:
        raise AssertionError(f"{what}: /metrics {status}, missing or "
                             f"mistyped {missing}")
    line["metric_families"] = len(types_)
    log(f"{what}: OpenAI round " + json.dumps(line))
    ctx.setdefault("openai", {})[what] = line


#: the kernel class of PyTorch's own attention kernels (SDPA), which no
#: serve phase may launch
LIBRARY_ATTENTION = "library attention (SDPA)"


def _kernel_class(name: str, walk: str) -> str:
    """The kernel class of a device event. ``walk`` names the wrapper whose
    launches the shared walk's kernels (tile, decode CTA, merge and row
    groups) are in this phase: B2 in ``serve``, B3 in ``serve_ragged`` and
    ``serve_fused``; each phase runs only one of the two."""
    if "flash_kernel" in name:
        return "B1 flash_attention"
    if any(k in name.lower() for k in ("fmha", "flash_fwd", "attention_kernel",
                                       "efficient_attention")):
        return LIBRARY_ATTENTION
    if any(k in name for k in ("ragged_kernel", "decode_kernel",
                               "merge_kernel", "groups_kernel")):
        return walk
    if any(w in name.lower() for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    if "LogSoftMax" in name or "topk" in name.lower():
        return "logprob readout (log-softmax, top-k)"
    return "other (elementwise, norms, rope, sampling, scatter, copies)"


def _profile(torch, fn, walk: str) -> None:
    """Run ``fn`` once more under ``torch.profiler`` and print the device's
    busy share of the wall time and its time by kernel class. The trace
    goes to a temporary directory and is not kept. A second pass of the
    same work, so the timed pass above runs without the profiler."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    dev = sorted((e["ts"], e["ts"] + e["dur"], e) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "dur" in e)
    if not dev:
        log("profile: the profiler recorded no device activity; device "
            "busy share not measured")
        return None
    busy, end = 0.0, float("-inf")
    for a, b, _ in dev:     # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_class, by_name = {}, {}
    for a, b, e in dev:
        name = e.get("name", "") if e["cat"] == "kernel" else e["cat"]
        c = _kernel_class(name, walk)
        by_class[c] = by_class.get(c, 0.0) + (b - a)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    total = sum(by_class.values())
    log(f"profile: traced pass {wall_us / 1e6:.2f} s wall, device busy "
        f"{busy / 1e6:.3f} s = {busy / wall_us:.1%} of the wall; "
        f"{len(dev)} device events")
    for c, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"profile:   {c}: {us / 1e3:.1f} ms = {us / total:.1%} of "
            f"device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:     {us / 1e3:.1f} ms {name[:100]}")
    if LIBRARY_ATTENTION in by_class:
        raise AssertionError("profile: a library attention kernel ran")
    return {"wall_s": wall_us / 1e6, "busy_s": busy / 1e6,
            "busy_share": busy / wall_us}


def _serve(ctx, what, env, prompts, expect, walk, openai=False, then=None):
    """Serve ``llama-8b-geometry`` over HTTP under ``env`` and send
    ``prompts`` concurrently: all must answer 200, exactly the kernels
    ``expect`` must rise, no block may leak. Prints TTFT/TPOT, ``/stats``
    and a profiled second pass; with ``openai``, then runs the OpenAI
    round; ``then(base, eng)`` runs last, before the recompile and leak
    checks. Returns the /generate responses."""
    import torch

    _drop_engine_model(ctx)
    env = {"DEVICE": "cuda", "MODEL_ID": "llama-8b-geometry",
           "BATCH_SIZE": str(SERVE_REQUESTS), "PORT": "0", **env}
    with _env(env):
        from scalable_hw_agnostic_inference_tpu_torch.serve.app import (
            create_app,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import (
            Server,
        )
        from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
            VllmService,
        )
        from scalable_hw_agnostic_inference_tpu_torch.utils.env import (
            ServeConfig,
        )
        from scalable_hw_agnostic_inference_tpu_torch.utils.latency import (
            LatencyCollector,
        )

        cfg = ServeConfig.from_env()
        service = VllmService(cfg)
        server = Server(create_app(cfg, service), host="127.0.0.1", port=0)
        host, port = server.start_background()
        base = f"http://{host}:{port}"
        try:
            t0 = time.monotonic()
            while True:
                status, body = _http(base + "/readiness")
                if status == 200:
                    break
                if status == 500 or time.monotonic() - t0 > 600:
                    raise AssertionError(f"{what}: not ready: {status} "
                                         f"{body}")
                time.sleep(0.5)
            eng = service._engine
            graphs = _graphs(eng)
            log(f"{what}: llama-8b-geometry ready in "
                f"{time.monotonic() - t0:.1f} s (load + warmup); engine "
                f"max_model_len {eng.ecfg.max_model_len}, buckets "
                f"{list(eng.ecfg.context_encoding_buckets)}, ragged "
                f"{eng._ragged}, int8 KV {eng._kv_quant}, async "
                f"{eng._async}; warmed {eng.obs.warmed_executables} "
                f"executables in {service.warm_seconds:.2f} s before "
                f"readiness: graphs {[g.key for g in graphs]}, capture s "
                f"{[round(g.capture_seconds, 3) for g in graphs]}, launches "
                f"per replay {graphs[0].launches}, graph pool "
                f"{eng._graphs.bytes()} bytes, KV pool "
                f"{eng.cache.pool_bytes} bytes")
            # async unless the caller's environment asks for lock-step
            want_async = os.environ.get("SHAI_ASYNC_DECODE", "1") != "0"
            if eng._async != want_async or not all(g.captured
                                                   for g in graphs):
                raise AssertionError(f"{what}: async {eng._async}, captured "
                                     f"{[g.captured for g in graphs]}")
            # latency instruments count from here: the warmup request is out
            eng.ttft, eng.tpot = LatencyCollector(), LatencyCollector()
            before = _replays(eng)
            chunks = _count_chunks(eng)
            _reset_counters()
            results, wall = _send_concurrent(base, prompts)
            counts = _read_counters()
            exact = _expected_walk(eng, before, chunks)
            steps = sum(_replays(eng).values()) - sum(before.values())
            ctx.setdefault("launches", {})[what] = counts
            bad = [r for r in results if r is None or r[0] != 200]
            if bad:
                raise AssertionError(f"{what}: failed responses {bad[:2]}")
            n_prompt = [r[1]["n_prompt"] for r in results]
            n_tok = [r[1]["n_tokens"] for r in results]
            stats = _http(base + "/stats")[1]
            ttft = eng.ttft.report()
            tpot = eng.tpot.report()
            log(f"{what}: {len(prompts)} concurrent /generate -> 200 in "
                f"{wall:.2f} s, prompt tokens {n_prompt}, tokens {n_tok}; "
                f"launches {counts}; {steps} graph replays, "
                f"{len(chunks)} continuation chunks")
            log(f"{what}: TTFT p50 {ttft['p50'] * 1e3:.1f} ms p99 "
                f"{ttft['p99'] * 1e3:.1f} ms; TPOT p50 "
                f"{tpot['p50'] * 1e3:.2f} ms p99 {tpot['p99'] * 1e3:.2f} ms "
                f"(engine instruments); /stats {json.dumps(stats)}")
            busy = _profile(torch, lambda: _send_concurrent(base, prompts),
                            walk)
            ctx.setdefault("serve_summary", {})[what] = {
                "ttft_ms": {"p50": ttft["p50"] * 1e3,
                            "p99": ttft["p99"] * 1e3},
                "tpot_ms": {"p50": tpot["p50"] * 1e3,
                            "p99": tpot["p99"] * 1e3},
                "traced_pass": busy,
                "step_gap_mean_ms": stats.get("step_gap_mean_ms"),
                "pipeline_flushes": eng.obs.flush_reasons(),
                "graph_pool_bytes": eng._graphs.bytes(),
                "kv_pool_bytes": eng.cache.pool_bytes}
            _check_counters(what, counts, expect)
            _check_walk(what, counts, exact)
            if openai:
                _openai_round(ctx, what, base, eng, prompts, expect)
            if then is not None:
                then(base, eng)
            log(f"{what}: recompiles after warmup {eng.obs.recompiles}, "
                f"executables {eng.n_executables} (warmed "
                f"{eng.obs.warmed_executables}), pipeline flushes "
                f"{eng.obs.flush_reasons()}")
            if eng.obs.recompiles or \
                    eng.n_executables != eng.obs.warmed_executables:
                raise AssertionError(f"{what}: {eng.obs.recompiles} "
                                     f"recompiles after warmup")
            if eng.cache.leaked_blocks:
                raise AssertionError(f"{what}: leaked KV blocks")
            return results
        finally:
            server.stop()
            service.close()
            del service
            gc.collect()
            torch.cuda.empty_cache()


def phase_serve(ctx):
    # no engine ConfigMap: the unit derives its engine shapes from the
    # env, as a pod without one does (buckets 128 and 512, no chunking)
    _serve(ctx, "serve", {
        "VLLM_CONFIG": os.path.join(REPO, "no-vllm-config.yaml"),
        "SHAI_RAGGED_ATTENTION": "0", "SHAI_KV_QUANT": ""},
        _serve_prompts(), {"flash_attention", "paged_decode_attention"},
        "B2 paged_decode_attention", openai=True)


def phase_serve_ragged(ctx):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vllm_config.yaml")
        with open(path, "w") as f:
            json.dump(SERVE_RAGGED_CONFIG, f)   # JSON is YAML too
        results = _serve(ctx, "serve_ragged", {
            "VLLM_CONFIG": path, "SHAI_RAGGED_ATTENTION": "1",
            "SHAI_KV_QUANT": "int8"}, _serve_prompts((1500, 3000)),
            {"flash_attention", "ragged_paged_attention"},
            "B3 ragged_paged_attention")
    chunked = [r[1]["n_prompt"] for r in results if r[1]["n_prompt"] > 512]
    if len(chunked) != 2:
        raise AssertionError(f"serve_ragged: {len(chunked)} prompts past the "
                             f"512 bucket, want 2")


def _fanout_round(ctx, base, eng) -> None:
    """One ``POST /v1/completions`` with ``n=4``, not streamed, on a prompt
    inside the 512 bucket: the group is admitted whole as one prefill with
    three copy-on-write forks, B3 exactly the layers times the fused
    replays, four choices, no leaked block."""
    cow0 = (eng.cache.cow_forks, eng.cache.cow_copies)
    before = _replays(eng)
    _reset_counters()
    status, out = _http(base + "/v1/completions", {
        "prompt": "fan me out: " + "tell me more " * 8, "max_tokens": 8,
        "temperature": 0, "n": 4})
    counts = _read_counters()
    exact = _expected_walk(eng, before, [])
    forks = eng.cache.cow_forks - cow0[0]
    copies = eng.cache.cow_copies - cow0[1]
    line = {"status": status, "choices": len(out.get("choices", [])),
            "usage": out.get("usage"), "cow_forks": forks,
            "cow_copies": copies, "launches": counts, "walk": exact,
            "leaked_blocks": eng.cache.leaked_blocks}
    log("serve_fused: n=4 round " + json.dumps(line))
    if status != 200 or line["choices"] != 4 or forks != 3:
        raise AssertionError(f"serve_fused: n=4 gave {status}, "
                             f"{line['choices']} choices, {forks} forks")
    _check_walk("serve_fused n=4", counts, exact)
    ctx["fanout"] = line


def phase_serve_fused(ctx):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vllm_config.yaml")
        with open(path, "w") as f:
            json.dump(SERVE_RAGGED_CONFIG, f)   # JSON is YAML too
        results = _serve(ctx, "serve_fused", {
            "VLLM_CONFIG": path, "SHAI_RAGGED_ATTENTION": "1",
            "SHAI_KV_QUANT": "int8", "SHAI_FUSED_STEP": "1",
            "SHAI_KV_COW": "1"}, _serve_prompts((1500, 3000)),
            {"flash_attention", "ragged_paged_attention"},
            "B3 ragged_paged_attention",
            then=lambda base, eng: _fanout_round(ctx, base, eng))
    chunked = [r[1]["n_prompt"] for r in results if r[1]["n_prompt"] > 512]
    if len(chunked) != 2:
        raise AssertionError(f"serve_fused: {len(chunked)} prompts past the "
                             f"512 bucket, want 2")
    summary = ctx["serve_summary"]
    log("serve_fused beside serve_ragged: " + json.dumps(
        {k: summary.get(k) for k in ("serve_ragged", "serve_fused")}))


def kernels_line(ctx):
    cuda_dir = "scalable_hw_agnostic_inference_tpu_torch/csrc"
    pallas = f"{TPU_PKG}/ops/pallas"
    # (name, ctx key of its timed row, source, TPU kernel, serve phase)
    spec = [
        ("flash_attention", "flash", f"{cuda_dir}/flash_attention.cu",
         f"{pallas}/flash_attention.py:132", "serve"),
        ("paged_decode_attention", "paged",
         f"{cuda_dir}/ragged_paged_attention.cu",
         f"{pallas}/paged_attention.py:101", "serve"),
        ("ragged_paged_attention", "ragged",
         f"{cuda_dir}/ragged_paged_attention.cu",
         f"{pallas}/ragged_paged_attention.py:121", "serve_ragged"),
    ]
    out = []
    for name, key, src, replaces, phase in spec:
        row = ctx[key]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": ctx["launches"][phase][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "launches_in": phase,
        })
    # B3's fused launches: the mixed-row launch timed in the ragged phase,
    # and its launches in serve_fused (every fused and chunk-only replay)
    mixed = ctx["ragged_mixed"]
    out[-1]["fused"] = {
        "launches": ctx["launches"]["serve_fused"][
            "ragged_paged_attention"],
        "launches_in": "serve_fused",
        **{k: mixed[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "decode_alone_ms", "chunk_alone_ms")}}
    return {"kernels": out}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import scalable_hw_agnostic_inference_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    ctx = {"timer": Timer(torch)}
    funcs = {name: globals()["phase_" + name] for name in PHASES}
    failed = []
    t_all = time.monotonic()
    for name in phases:
        t0 = time.monotonic()
        log(f"== {name}")
        try:
            funcs[name](ctx)
        except Exception:
            traceback.print_exc()
            sys.stderr.flush()
            failed.append(name)
        log(f"== {name}: {'FAILED' if name in failed else 'ok'} "
            f"({time.monotonic() - t0:.1f} s)")
    log(f"total {time.monotonic() - t_all:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if phases != list(PHASES):
        log("partial run: no result line")
        return 0
    log(f"card: {ctx['card']}")
    log(json.dumps(kernels_line(ctx)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
