#!/usr/bin/env python3
"""Time variants of the port's W8A16 kernel (B4) beside each other on one
card.

    python3 scripts/int8_variants.py [VARIANTS] [ROWS] [CTAS]

``VARIANTS`` is a JSON object ``{name: {text: replacement, ...}}``, or the
path of a ``.json`` file holding one: each variant is
``scalable_hw_agnostic_inference_tpu_torch/csrc/int8_matmul.cu`` with those
literal replacements (``{}`` is the source as it is), compiled by ``nvcc``
into a library of its own in a temporary directory, all variants at once;
the compiler's warnings and each instantiation's registers are printed.
``ROWS`` is a JSON list of row counts M (default: 1, 8, 64 for the decode
instantiation, 512 and 2048 for the wide one); ``CTAS`` a JSON list of CTA
counts to try beside the host plan's (``null``; each capped at the call's
tile elements). Every variant is timed at Llama-3-8B's projection shapes
(q/o, k/v, gate/up, down, lm_head) with the host plan's CTAs
(``ops/cuda/int8_matmul.py`` ``int8_plan``) and each of ``CTAS``, the L2
flushed before each call (median of 15, CUDA events), beside bf16
``F.linear`` and the bound (bytes over 3.35 TB/s or 2 M N K over 989
TFLOP/s, the larger); a time is printed negative when the variant's output
is wrong (a variant that drops work on purpose, to see what the rest
costs). The last lines sum each M over a Llama-3-8B step (32 layers, and
the lm_head at decode widths) per variant. Needs one card; imports nothing
of the JAX package.
"""

from __future__ import annotations

import ctypes
import json
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
ROWS = (1, 8, 64, 512, 2048)


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
            [nvcc, *_build.COMPILE_FLAGS, "-I", str(SOURCE.parent),
             "-shared", "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line]
        notes = [line.strip() for line in log.splitlines()
                 if any(w in line for w in ("warning", "wgmma", "C75",
                                            "setmaxnreg", "spill stores"))]
        print(f"{name}: nvcc exit {proc.returncode}; {regs}; {notes}",
              flush=True)
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
    arg = argv[0] if argv else '{"source": {}}'
    variants = json.loads(Path(arg).read_text() if arg.endswith(".json")
                          else arg)
    rows = json.loads(argv[1]) if len(argv) > 1 else ROWS
    caps = json.loads(argv[2]) if len(argv) > 2 else [None]
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
        counters = torch.zeros(8 * sms, dtype=torch.int32, device="cuda")
        res = {}
        for N, K in SHAPES:
            wq, sc = quantize_weight(
                torch.randn(N, K, generator=gen, device="cuda") * 0.02)
            wb = wq.to(torch.bfloat16)
            for M in rows:
                x = torch.randn(M, K, generator=gen, device="cuda").to(
                    torch.bfloat16)
                ref = i8.int8_matmul_reference(x, wq, sc)
                tol = 0.05 * float(ref.float().abs().max())
                plan = i8.int8_plan(M, N, K, sms)
                tries = {cap: plan.ctas if cap is None
                         else min(cap, plan.elements) for cap in caps}
                part = torch.empty(plan.scratch_numel // plan.ctas
                                   * max(tries.values()),
                                   dtype=torch.float32, device="cuda")
                row = {"linear": timed(
                    lambda: torch.nn.functional.linear(x, wb))}
                for (name, fn), cap in ((v, c) for v in fns.items()
                                        for c in caps):
                    key = name if cap is None else f"{name}/{cap}"
                    y = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")

                    def call(fn=fn, y=y, ctas=tries[cap]):
                        return fn(x.data_ptr(), wq.data_ptr(), sc.data_ptr(),
                                  y.data_ptr(), part.data_ptr(),
                                  counters.data_ptr(), M, N, K, ctas,
                                  plan.row_tiles, 0, stream)

                    err = call()
                    torch.cuda.synchronize()
                    if err:
                        row[key] = f"error {err}"
                        continue
                    ok = float((y.float() - ref.float()).abs().max()) <= tol
                    ms = timed(call)
                    row[key] = ms if ok else -ms
                bound = max((N * K + 4 * N + 2 * M * K + 2 * M * N) / 3.35e12,
                            2 * M * N * K / 989e12) * 1e3
                print(json.dumps({"M": M, "N": N, "K": K, "ctas": plan.ctas,
                                  "bound": bound, **row}), flush=True)
                res[(M, N, K)] = row
            del wq, sc, wb
            torch.cuda.empty_cache()
        for M in rows:
            step = {}
            for key, v in res[(M, 4096, 4096)].items():
                try:
                    step[key] = 32 * sum(res[(M, n, k)][key]
                                         for n, k in LAYER)
                    if M <= i8.DECODE_MAX_ROWS:
                        step[key] += res[(M, 128256, 4096)][key]
                except (KeyError, TypeError):
                    pass
            print(f"step M={M}: {json.dumps(step)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
