#!/usr/bin/env python3
"""What the paged engine over an NCCL group of one costs beside the
unsharded engine on the same weights (``chip_smoke.py`` phase
``tp_engine`` (a)).

    python3 scripts/tp_group_overhead.py

Llama-3-8B at full width and depth, seeded N(0, 0.02) bf16 weights; the
tp_engine phase's requests and engine geometry (``chip_smoke.TPE_PROMPTS``,
``TPE_ENGINE``: 8 requests of 5 to 1,300 tokens, 8 greedy tokens each),
async decode, every decode key warmed (captured) first. For each engine:
the wall seconds of three ``generate`` rounds (host clock, ending in
``torch.cuda.synchronize()``), a ``torch.profiler`` table of the third
(self CPU time first), and the device ms of one replay of the largest
decode key (CUDA events over 20 replays). Needs one card; imports nothing
of the JAX package.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import TPE_ENGINE, TPE_PROMPTS  # noqa: E402
from scalable_hw_agnostic_inference_tpu_torch.engine import ranks  # noqa: E402
from scalable_hw_agnostic_inference_tpu_torch.engine.config import (  # noqa: E402
    EngineConfig,
)
from scalable_hw_agnostic_inference_tpu_torch.engine.engine import (  # noqa: E402
    LLMEngine,
    SamplingParams,
)
from scalable_hw_agnostic_inference_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig,
    LlamaForCausalLM,
    random_params,
)
from scalable_hw_agnostic_inference_tpu_torch.parallel.distributed import (  # noqa: E402
    init_group,
)

def measure(eng: LLMEngine, label: str, prompts) -> None:
    params = SamplingParams(temperature=0.0,
                            max_new_tokens=TPE_ENGINE["max_new_tokens"])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for rnd in range(3):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if rnd < 2:
            eng.generate(prompts, params)
            eng.finish_pending()
            torch.cuda.synchronize()
            print(f"{label}: generate {time.monotonic() - t0:.3f} s",
                  flush=True)
            continue
        with torch.profiler.profile(activities=acts) as prof:
            eng.generate(prompts, params)
            eng.finish_pending()
            torch.cuda.synchronize()
        print(f"{label}: profiled round", flush=True)
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=14), flush=True)
    graph = max(eng.graphs(), key=lambda g: g.inputs["tokens"].shape[0])
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    end.synchronize()
    print(f"{label}: replay of {graph.key} {start.elapsed_time(end) / 20:.3f}"
          f" ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tp_group_overhead: needs a card")
    print(torch.cuda.get_device_name(0), flush=True)
    os.environ["SHAI_ASYNC_DECODE"] = "1"
    cfg = LlamaConfig.llama3_8b()
    model = LlamaForCausalLM.from_state_dict(
        cfg, random_params(cfg, seed=0, std=0.02, device="cuda"))
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in TPE_PROMPTS]
    plain = LLMEngine(cfg, model, EngineConfig(**TPE_ENGINE), device="cuda")
    plain.warm_executables()
    measure(plain, "unsharded", prompts)
    del plain
    gc.collect()
    tmp = tempfile.mkdtemp(prefix="shai-tp1-")
    group = init_group(1, 0, os.path.join(tmp, "store"), "nccl", "cuda:0")
    try:
        eng = ranks.rank_engine(cfg, dict(model.state_dict()),
                                EngineConfig(**TPE_ENGINE), group, "cuda")
        eng.warm_executables()
        measure(eng, "nccl group of one", prompts)
        eng.close()
        del eng
        gc.collect()
        torch.cuda.synchronize()
    finally:
        group.close()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
