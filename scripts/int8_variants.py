#!/usr/bin/env python3
"""Time variants of the port's W8A16 kernel beside each other on one card.

    python3 scripts/int8_variants.py VARIANTS [ROWS]

``VARIANTS`` is a JSON object ``{name: {text: replacement, ...}}``: each
variant is ``scalable_hw_agnostic_inference_tpu_torch/csrc/int8_matmul.cu``
with those literal replacements (``{}`` is the source as it is), compiled
by ``nvcc`` into a library of its own in a temporary directory, all
variants at once. ``ROWS`` is a JSON list of rows-per-CTA values to try
beside the host plan's. Every variant is timed at Llama-3-8B's projection
shapes (q/o, k/v, gate/up, down, lm_head) and M in 1, 8, 64, with the L2
flushed before each call (median of 15, CUDA events), beside bf16
``F.linear`` and the bytes bound; a time is printed negative when the
variant's output is wrong (a variant that drops work on purpose, to see
what the rest costs). The last lines sum a decode step (32 layers and the
lm_head) per variant. Needs one card; imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "scalable_hw_agnostic_inference_tpu_torch/csrc/int8_matmul.cu"
SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
          (128256, 4096))
LAYER = [(4096, 4096)] * 2 + [(1024, 4096)] * 2 + [(14336, 4096)] * 2 \
    + [(4096, 14336)]


def build(variants, out: Path):
    """One library per variant, compiled in parallel; returns name ->
    ctypes function."""
    sys.path.insert(0, str(REPO))
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for name, subs in variants.items():
        src = SOURCE.read_text()
        for a, b in subs.items():
            if a not in src:
                raise SystemExit(f"{name}: {a!r} is not in the source")
            src = src.replace(a, b)
        (out / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.COMPILE_FLAGS, "-shared", "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line]
        print(f"{name}: nvcc exit {proc.returncode}; {regs}", flush=True)
        if proc.returncode:
            print(log[-3000:])
            continue
        fn = ctypes.CDLL(str(out / f"{name}.so")).shai_int8_matmul
        fn.argtypes = _build.ENTRY_POINTS["shai_int8_matmul"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("int8_variants: needs the card", file=sys.stderr)
        return 2
    variants = json.loads(argv[0]) if argv else {"source": {}}
    rows_try = set(json.loads(argv[1])) if len(argv) > 1 else set()
    sys.path.insert(0, str(REPO))
    from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import (
        int8_matmul as i8,
    )
    from scalable_hw_agnostic_inference_tpu_torch.ops.quant import (
        quantize_weight,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def timed(fn, reps=15):
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            flush.sum()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    with tempfile.TemporaryDirectory() as tmp:
        fns = build(variants, Path(tmp))
        gen = torch.Generator(device="cuda").manual_seed(0)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        res = {}
        for N, K in SHAPES:
            wq, sc = quantize_weight(
                torch.randn(N, K, generator=gen, device="cuda") * 0.02)
            wb = wq.to(torch.bfloat16)
            for M in (1, 8, 64):
                x = torch.randn(M, K, generator=gen, device="cuda").to(
                    torch.bfloat16)
                ref = i8.int8_matmul_reference(x, wq, sc)
                tol = 0.05 * float(ref.float().abs().max())
                row = {"linear": timed(
                    lambda: torch.nn.functional.linear(x, wb))}
                for name, fn in fns.items():
                    for rpc in sorted({i8.int8_plan(N, sms)} | rows_try):
                        y = torch.empty(M, N, dtype=torch.bfloat16,
                                        device="cuda")

                        def call(fn=fn, rpc=rpc, y=y):
                            return fn(x.data_ptr(), wq.data_ptr(),
                                      sc.data_ptr(), y.data_ptr(), M, N, K,
                                      rpc, 0, stream)

                        err = call()
                        torch.cuda.synchronize()
                        if err:
                            row[f"{name}/{rpc}"] = f"error {err}"
                            continue
                        ok = float((y.float() - ref.float()).abs().max()) \
                            <= tol
                        ms = timed(call)
                        row[f"{name}/{rpc}"] = ms if ok else -ms
                bound = (N * K + 4 * N + 2 * M * K + 2 * M * N) / 3.35e12 \
                    * 1e3
                print(json.dumps({"M": M, "N": N, "K": K, "bound": bound,
                                  **row}), flush=True)
                res[(M, N, K)] = row
        for M in (1, 8, 64):
            step = {}
            for key, v in res[(M, 4096, 4096)].items():
                try:
                    step[key] = 32 * sum(res[(M, n, k)][key]
                                         for n, k in LAYER) \
                        + res[(M, 128256, 4096)][key]
                except (KeyError, TypeError):
                    pass
            print(f"decode step M={M}: {json.dumps(step)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
