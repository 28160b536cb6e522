#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100, end to end.

    python3 chip_smoke.py                  # every phase (needs one card)
    python3 chip_smoke.py --phases build,flash,paged

Phases:
  1. ``card``   the card's name and power limit (nvidia-smi);
  2. ``build``  build every kernel from ``csrc/*.cu`` with nvcc (sm_90a);
  3. ``flash``  hold B1 (flash attention) against its plain version at
                Llama-3-8B prefill shapes, and time kernel, plain version,
                bound and the SDPA yardstick;
  4. ``paged``  the same for B2 (paged decode attention) at decode shapes;
  5. ``engine`` the engine at Llama-3-8B widths with seeded random weights:
                greedy tokens against the argmax of the full-sequence
                scoring forward over prompt + generated tokens;
  6. ``serve``  serve ``llama-8b-geometry`` over HTTP (the unit a user runs)
                and answer 8 concurrent ``POST /generate``; the launch
                counters are zeroed just before and must have risen.

Any failed phase makes the script exit non-zero without the result lines.
A full run prints the card's name and power limit, then, second to last,
``{"kernels": [...]}`` (per kernel: route, source, the TPU kernel it
replaces, launches in the serving phase, max error, kernel/plain/bound/
library times) and, last, ``{"ok": true, "device": {...}}``. It exits non-zero at once when CUDA is
unavailable or the port's package is not beside it.
"""

from __future__ import annotations

import argparse
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

PHASES = ("card", "build", "flash", "paged", "engine", "serve")

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
# forward's logit for it is within this much of its maximum
TIE_TOL = 0.1

ENGINE_LAYERS = 32
ENGINE_NEW_TOKENS = 16
SERVE_REQUESTS = 8

REPO = os.path.dirname(os.path.abspath(__file__))
TPU_PKG = "scalable_hw_agnostic_inference_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing ------------------------------------------------------------------


class Timer:
    """Median device time of one call, from CUDA events around each call.
    A 256 MB write before every call evicts the 50 MB L2 (the real caller
    finds its operands cold) and keeps the device busy while the host
    enqueues the call, so host launch overhead stays out of the window."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


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
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line.lower():
            log(f"  ptxas: {line.strip()}")


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
    H, Hkv, D = 32, 8, 128
    # (B, T, S, lengths, causal, timed): Llama-3-8B prefill shapes; lengths
    # mix 1 and the full length; one T < S (continuation) case
    cases = [
        (1, 512, 512, [512], True, True),
        (4, 512, 512, [1, 100, 333, 512], True, True),
        (1, 2048, 2048, [2048], True, True),
        (4, 2048, 2048, [1, 700, 1500, 2048], True, True),
        (2, 512, 2048, [2048, 1000], True, True),
        (1, 512, 512, None, False, False),
    ]
    small = [(64, 2, 256, 256, 8, 2, [200, 0], True),
             (192, 1, 128, 128, 8, 2, [100], True),
             (256, 2, 256, 256, 8, 2, [256, 77], True)]
    worst = 0.0
    rows = []
    for B, T, S, lengths, causal, timed in cases:
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
            n_bytes, flops = _flash_work(B, T, S, H, Hkv, D, lengths, causal)
            bms, by = bound_ms(n_bytes, flops)
            line.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=lib)
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


def phase_paged(ctx):
    import torch
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        paged_attention as pa,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    timer = ctx["timer"]
    H, Hkv, D, bs, N = 32, 8, 128, 16, 1024
    # (B, M, lengths, timed): decode shapes, a pool of N shuffled blocks,
    # lengths from 1 to 2048 (= M * bs); one truncated context bucket
    cases = [
        (1, 128, [2048], True),
        (8, 128, [1, 17, 255, 512, 1000, 1500, 2047, 2048], True),
        (8, 64, [1, 16, 33, 300, 512, 777, 1000, 1024], False),
    ]
    small = [(64, 4, 4, 1, 32, [1, 40, 0, 511]),
             (192, 2, 8, 2, 8, [70, 3]),
             (256, 2, 16, 2, 8, [5, 128])]
    worst = 0.0
    rows = []
    for B, M, lengths, timed in cases:
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
            n_bytes, flops = _paged_work(B, H, Hkv, D, bs, M, lengths)
            bms, by = bound_ms(n_bytes, flops)
            line.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                        library_ms=None)
        rows.append(line)
        log("paged_decode_attention: " + json.dumps(line))
    for D_, B, H_, Hkv_, M, lengths in small:
        q, kp, vp, tables, lens = _paged_case(torch, gen, B, H_, Hkv_, D_,
                                              bs, B * M, M, lengths)
        out = pa.paged_decode_attention(q, kp, vp, tables, lens)
        f32 = (q.float(), kp.float(), vp.float(), tables)
        ref = pa.paged_decode_attention_reference(*f32, lens)
        dropped = pa.paged_decode_attention_reference(*f32, _cut(lens))
        err, share, d_share = _check_close(
            f"paged_decode_attention D={D_}", out, ref, dropped)
        worst = max(worst, err)
        if 0 in lengths and bool(out[lengths.index(0)].any()):
            raise AssertionError("paged_decode_attention: a length-0 row is "
                                 "not 0")
        log(f"paged_decode_attention: D={D_} G={H_ // Hkv_} "
            f"lengths={lengths} max |err| {err:.3e}, {share:.3f} of the "
            f"tolerance (dropped keys: {d_share:.2f})")
    # the summary row: the batch-8 decode step over a 128-block bucket
    ctx["paged"] = dict(rows[1], max_abs_err=worst)


def _counters():
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        flash_attention as fa,
        paged_attention as pa,
    )

    return fa.flash_attention, pa.paged_decode_attention


def _reset_counters():
    for fn in _counters():
        fn.launches = 0


def _read_counters():
    fa, pa = _counters()
    return {"flash_attention": fa.launches,
            "paged_decode_attention": pa.launches}


def phase_engine(ctx):
    import dataclasses

    import torch
    from scalable_hw_agnostic_inference_tpu_torch.engine.config import (
        EngineConfig,
    )
    from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (
        LLMEngine,
        SamplingParams,
    )
    from scalable_hw_agnostic_inference_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
        random_params,
    )

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              n_layers=ENGINE_LAYERS)
    log(f"engine: Llama-3-8B widths, {cfg.n_layers} of 32 layers, seeded "
        f"N(0, 0.02) weights")
    t0 = time.monotonic()
    model = LlamaForCausalLM.from_state_dict(
        cfg, random_params(cfg, seed=0, std=0.02, device="cuda"))
    ecfg = EngineConfig(max_model_len=1024, max_num_seqs=4, block_size=16,
                        context_encoding_buckets=(128, 512),
                        max_new_tokens=ENGINE_NEW_TOKENS)
    eng = LLMEngine(cfg, model, ecfg, device="cuda")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 37, 120, 300)]
    _reset_counters()
    t1 = time.monotonic()
    fins = eng.generate(prompts, SamplingParams(
        temperature=0.0, max_new_tokens=ENGINE_NEW_TOKENS))
    torch.cuda.synchronize()
    t_gen = time.monotonic() - t1
    counts = _read_counters()
    worst_deficit, exact, total = 0.0, 0, 0
    with torch.inference_mode():
        for p, f in zip(prompts, fins):
            if len(f.token_ids) != ENGINE_NEW_TOKENS:
                raise AssertionError(f"engine: {len(f.token_ids)} tokens, "
                                     f"want {ENGINE_NEW_TOKENS}")
            ids = torch.tensor([p + f.token_ids], device="cuda")
            logits = model(ids)[0, len(p) - 1: -1]    # predicts each token
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("engine: non-finite scoring logits")
            tok = torch.tensor(f.token_ids, device="cuda")
            deficit = (logits.max(-1).values
                       - logits.gather(1, tok[:, None])[:, 0])
            worst_deficit = max(worst_deficit, deficit.max().item())
            exact += int((logits.argmax(-1) == tok).sum())
            total += len(f.token_ids)
    log(f"engine: {len(prompts)} prompts x {ENGINE_NEW_TOKENS} greedy tokens "
        f"in {t_gen:.2f} s (setup {t1 - t0:.1f} s); {exact}/{total} equal the "
        f"scoring argmax, worst logit deficit {worst_deficit:.4f} "
        f"(tie tolerance {TIE_TOL}); launches {counts}; leaked blocks "
        f"{eng.cache.leaked_blocks}")
    if worst_deficit > TIE_TOL:
        raise AssertionError("engine tokens disagree with the scoring "
                             "forward beyond the tie tolerance")
    if eng.cache.leaked_blocks:
        raise AssertionError("engine leaked KV blocks")
    if not all(counts.values()):
        raise AssertionError(f"engine run skipped a kernel: {counts}")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()


def _http(url: str, payload=None, timeout: float = 300.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _send_concurrent(base: str):
    """``SERVE_REQUESTS`` concurrent greedy ``POST /generate`` of mixed
    prompt lengths (prefill buckets 128 and 512); returns the responses
    and the wall seconds."""
    results = [None] * SERVE_REQUESTS

    def one(i):
        results[i] = _http(base + "/generate", {
            "prompt": f"request {i}: " + "tell me more " * (3 * i + 1),
            "temperature": 0.0, "max_new_tokens": 16})

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(SERVE_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, time.monotonic() - t0


def _kernel_class(name: str) -> str:
    if "flash_kernel" in name:
        return "B1 flash_attention"
    if "paged_kernel" in name:
        return "B2 paged_decode_attention"
    if any(w in name.lower() for w in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    return "other (elementwise, norms, rope, sampling, scatter, copies)"


def _profile(torch, fn) -> None:
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
        return
    busy, end = 0.0, float("-inf")
    for a, b, _ in dev:     # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_class, by_name = {}, {}
    for a, b, e in dev:
        name = e.get("name", "") if e["cat"] == "kernel" else e["cat"]
        c = _kernel_class(name)
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


def phase_serve(ctx):
    import torch

    os.environ.update(DEVICE="cuda", MODEL_ID="llama-8b-geometry",
                      BATCH_SIZE=str(SERVE_REQUESTS), PORT="0",
                      # no engine ConfigMap: the unit derives its engine
                      # shapes from the env, as a pod without one does
                      VLLM_CONFIG=os.path.join(REPO, "no-vllm-config.yaml"))
    from scalable_hw_agnostic_inference_tpu_torch.serve.app import create_app
    from scalable_hw_agnostic_inference_tpu_torch.serve.httpd import Server
    from scalable_hw_agnostic_inference_tpu_torch.serve.units.vllm import (
        VllmService,
    )
    from scalable_hw_agnostic_inference_tpu_torch.utils.env import ServeConfig
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
                raise AssertionError(f"serve: not ready: {status} {body}")
            time.sleep(0.5)
        log(f"serve: llama-8b-geometry ready in {time.monotonic() - t0:.1f} s"
            f" (load + warmup)")
        # latency instruments count from here: the warmup request is out
        eng = service._engine
        eng.ttft, eng.tpot = LatencyCollector(), LatencyCollector()
        _reset_counters()
        results, wall = _send_concurrent(base)
        counts = _read_counters()
        ctx["serve_launches"] = counts
        bad = [r for r in results if r is None or r[0] != 200]
        if bad:
            raise AssertionError(f"serve: failed responses {bad[:2]}")
        n_tok = [r[1]["n_tokens"] for r in results]
        stats = _http(base + "/stats")[1]
        ttft = eng.ttft.report()
        tpot = eng.tpot.report()
        log(f"serve: {SERVE_REQUESTS} concurrent /generate -> 200 in "
            f"{wall:.2f} s, tokens {n_tok}; launches {counts}")
        log(f"serve: TTFT p50 {ttft['p50'] * 1e3:.1f} ms p99 "
            f"{ttft['p99'] * 1e3:.1f} ms; TPOT p50 {tpot['p50'] * 1e3:.2f} ms "
            f"p99 {tpot['p99'] * 1e3:.2f} ms (engine instruments); "
            f"/stats {json.dumps(stats)}")
        _profile(torch, lambda: _send_concurrent(base))
        if not all(counts.values()):
            raise AssertionError(f"serve: a kernel was never launched: "
                                 f"{counts}")
        if eng.cache.leaked_blocks:
            raise AssertionError("serve: leaked KV blocks")
    finally:
        server.stop()
        service.close()
        del service
        gc.collect()
        torch.cuda.empty_cache()


def kernels_line(ctx):
    cuda_dir = "scalable_hw_agnostic_inference_tpu_torch/csrc"
    spec = [
        ("flash_attention", "flash", f"{cuda_dir}/flash_attention.cu",
         f"{TPU_PKG}/ops/pallas/flash_attention.py:132"),
        ("paged_decode_attention", "paged", f"{cuda_dir}/paged_attention.cu",
         f"{TPU_PKG}/ops/pallas/paged_attention.py:101"),
    ]
    out = []
    for name, key, src, replaces in spec:
        row = ctx[key]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": ctx["serve_launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
        })
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
    funcs = {"card": phase_card, "build": phase_build, "flash": phase_flash,
             "paged": phase_paged, "engine": phase_engine,
             "serve": phase_serve}
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
