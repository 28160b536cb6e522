"""Engine-backed text generation unit: paged continuous batching behind
``POST /generate``.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/serve/units/vllm.py``
(``VllmService``: ``_resolve_ecfg``, ``load`` with the closed set warmed
before the loop starts, ``infer``, ``extra_stats``). ``load`` serves
the ``tiny`` tier (seeded random weights, the small engine shapes of the
reference's ``:177-196``; CPU only, its head_dim of 16 is not one the CUDA
kernels take) and the ``*-geometry`` tiers (full-size architecture, zero
weights, real engine shapes). Checkpoint loading, the
OpenAI routes, SSE, logprobs, images, the KV network and migration come in
later slices.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from ...core.device import resolve_device
from ...engine.config import EngineConfig
from ...models.generate import ByteTokenizer
from ...models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    geometry_params,
    random_params,
)
from ...ops.cuda.flash_attention import HEAD_DIMS
from ...utils.env import ServeConfig
from ..app import ModelService
from ..asgi import HTTPError

log = logging.getLogger(__name__)

#: zero-weight full-size tiers: boot with no checkpoint and no network, so
#: the serving stack runs at real shapes (outputs are meaningless)
GEOMETRY_MODELS = {
    "llama-1b-geometry": LlamaConfig.llama32_1b,
    "llama-3b-geometry": LlamaConfig.llama32_3b,
    "llama-8b-geometry": LlamaConfig.llama3_8b,
    "mistral-7b-geometry": LlamaConfig.mistral_7b,
}


class VllmService(ModelService):
    """Continuous batching across concurrent HTTP requests through the
    engine loop; ``concurrency`` widens the model lane to the slot count so
    requests reach the loop together and share decode steps."""

    task = "text-generation"
    infer_route = "/generate"

    def __init__(self, cfg: ServeConfig):
        super().__init__(cfg)
        # a bad ConfigMap must not crash construction: the error surfaces
        # from load() as a readiness failure instead of a crash loop
        self._ecfg_error: Optional[Exception] = None
        self._engine = None
        self.loop = None
        self.warm_seconds = 0.0
        try:
            self.ecfg = self._resolve_ecfg(cfg)
            self.concurrency = self.ecfg.max_num_seqs
        except Exception as e:
            self.ecfg = None
            self._ecfg_error = e
            self.concurrency = 1

    @staticmethod
    def _resolve_ecfg(cfg: ServeConfig) -> EngineConfig:
        if os.path.exists(cfg.vllm_config):
            ecfg = EngineConfig.from_yaml(cfg.vllm_config)
            if ecfg.ignored_keys:
                log.info("vllm_config: ignoring keys %s", ecfg.ignored_keys)
            return ecfg
        # the largest bucket must reach MAX_SEQ_LEN (block-aligned up) or
        # long prompts truncate below the advertised limit
        top = -(-cfg.max_seq_len // 16) * 16
        buckets = sorted({b for b in (128, 512, 2048) if b < top} | {top})
        return EngineConfig(
            model=cfg.model_id,
            max_model_len=-(-(cfg.max_seq_len + cfg.max_new_tokens) // 16) * 16,
            max_num_seqs=max(cfg.batch_size, 4),
            block_size=16,
            context_encoding_buckets=tuple(buckets),
            max_new_tokens=cfg.max_new_tokens,
            quantization=cfg.quantization or None,
        )

    def load(self) -> None:
        from ...engine.engine import LLMEngine, SamplingParams
        from ...engine.loop import EngineLoop

        if self._ecfg_error is not None:
            raise self._ecfg_error
        cfg, ecfg = self.cfg, self.ecfg
        device = resolve_device(cfg.device)
        model_id = ecfg.model or cfg.model_id
        if model_id in ("", "tiny"):
            mcfg = LlamaConfig.tiny()
            # tiny engine shapes: small blocks and buckets so CI exercises
            # paging (geometry tiers keep their real engine shapes)
            ecfg = EngineConfig(
                model="tiny", max_model_len=256,
                max_num_seqs=ecfg.max_num_seqs, block_size=16,
                context_encoding_buckets=(32, 64, 128),
                token_generation_buckets=ecfg.token_generation_buckets,
                tensor_parallel_size=ecfg.tensor_parallel_size,
                quantization=ecfg.quantization,
                enable_prefix_caching=ecfg.enable_prefix_caching,
                max_new_tokens=min(ecfg.max_new_tokens, 64),
                role=ecfg.role)
        elif model_id in GEOMETRY_MODELS:
            mcfg = GEOMETRY_MODELS[model_id]()
        else:
            raise ValueError(
                f"model {model_id!r}: this port serves the 'tiny' and "
                f"geometry tiers ({', '.join(GEOMETRY_MODELS)}); checkpoint "
                f"loading is not ported yet")
        if device.type == "cuda" and mcfg.head_dim not in HEAD_DIMS:
            raise ValueError(
                f"model {model_id or 'tiny'!r} has head_dim {mcfg.head_dim}; "
                f"the CUDA attention kernels take head_dim in {HEAD_DIMS}. "
                f"Serve a geometry tier ({', '.join(GEOMETRY_MODELS)}) on "
                f"cuda, or this model with DEVICE=cpu")
        if model_id in GEOMETRY_MODELS:
            state = geometry_params(mcfg, dtype=torch.bfloat16, device=device)
        else:
            state = random_params(mcfg, cfg.seed, dtype=torch.float32,
                                  device=device)
        self.ecfg = ecfg
        model = LlamaForCausalLM.from_state_dict(mcfg, state)
        self.tokenizer = ByteTokenizer()
        self.eos_id = ByteTokenizer.eos_id
        engine = LLMEngine(mcfg, model, ecfg, device=device)
        # build the CLOSED executable set (every prefill bucket and batch
        # size, the continuation keys, every decode key captured as a CUDA
        # graph) BEFORE the engine loop starts serving, so no request
        # after readiness builds one
        t0 = time.monotonic()
        n = engine.warm_executables()
        self.warm_seconds = time.monotonic() - t0
        log.info("engine: warmed %d executables in %.1f s (buckets=%s)", n,
                 self.warm_seconds, list(engine.buckets.buckets))
        self._engine = engine
        self._SamplingParams = SamplingParams
        self.loop = EngineLoop(engine).start()

    def close(self) -> None:
        if self.loop is not None:
            self.loop.stop()

    def ready_error(self) -> Optional[str]:
        if self.loop is not None and not self.loop.alive:
            return "engine loop is not running"
        return None

    def example_payload(self) -> Dict[str, Any]:
        return {"prompt": "the quick brown fox", "temperature": 0.0,
                "max_new_tokens": 8}

    def _sampling_from(self, payload: Dict[str, Any]):
        """Validated SamplingParams from a request payload (400 on bad
        values; an over-cap max_new_tokens is a client error, not a silent
        clamp)."""
        mnt = payload.get("max_new_tokens")
        try:
            mnt = self.ecfg.max_new_tokens if mnt is None else int(mnt)
            params = self._SamplingParams(
                temperature=float(payload.get("temperature", 1.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                max_new_tokens=mnt,
                eos_id=self.eos_id,
            )
            logprobs = int(payload.get("logprobs") or 0)
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"bad sampling parameter: {e}")
        if logprobs:
            raise HTTPError(400, "logprobs are not served by this port yet")
        if mnt < 1:
            raise HTTPError(400, "max_new_tokens must be >= 1")
        if mnt > self.ecfg.max_new_tokens:
            raise HTTPError(
                400,
                f"max_new_tokens={mnt} exceeds this deployment's engine cap "
                f"MAX_NEW_TOKENS={self.ecfg.max_new_tokens}")
        return params

    def infer(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        if "prompt" not in payload and "text" not in payload:
            raise HTTPError(400, "missing 'prompt'")
        if payload.get("image_b64"):
            raise HTTPError(400, "multimodal requests are not served by this "
                                 "port yet")
        prompt = str(payload.get("prompt", payload.get("text", "")))
        # the engine's chunked-prefill cap, not the largest bucket: longer
        # prompts chunk through the continuation prefill
        ids, n = self.tokenizer.encode(prompt, self._engine.max_prompt_len)
        ids = [int(i) for i in ids[:n]]
        params = self._sampling_from(payload)
        fin = self.loop.submit(ids, params).result(timeout=600.0)
        if fin.stop_reason == "rejected":
            raise HTTPError(503, "request rejected: prompt cannot fit the KV "
                                 "pool")
        return {
            "generated_text": self.tokenizer.decode(fin.token_ids),
            "n_tokens": len(fin.token_ids),
            "n_prompt": fin.n_prompt,
            "stop_reason": fin.stop_reason,
        }

    def extra_stats(self) -> Dict[str, float]:
        eng = self._engine
        out = {
            "queue_waiting": eng.n_waiting,
            "seqs_running": eng.n_running,
            "seqs_chunking": eng.n_chunking,
            "blocks_free": eng.cache.allocator.n_free,
            "blocks_total": self.ecfg.total_blocks,
            "executables": eng.n_executables,
        }
        if eng.ttft.count:
            rep = eng.ttft.report()
            out["ttft_p50_ms"] = round(rep["p50"] * 1e3, 2)
            out["ttft_p99_ms"] = round(rep["p99"] * 1e3, 2)
        if eng.tpot.count:
            out["tpot_p50_ms"] = round(eng.tpot.report()["p50"] * 1e3, 2)
        # async decode pipeline health: flushes (serialization events, one
        # flat key per reason) and the realized inter-step gap, near zero
        # when the lookahead hides the host work (SHAI_ASYNC_DECODE)
        out["pipeline_flushes"] = eng.obs.pipeline_flushes
        for reason, n in eng.obs.flush_reasons().items():
            out[f"pipeline_flush_{reason}"] = n
        gap = eng.obs.step_gap.snapshot()
        if gap["count"]:
            out["step_gap_mean_ms"] = round(
                gap["sum"] / gap["count"] * 1e3, 4)
        return out
