"""Engine configuration — the ``vllm_config.yaml`` ConfigMap contract.

Port of ``scalable_hw_agnostic_inference_tpu/engine/config.py``, field for
field: the same vLLM-style key names, defaults and validation, so a
deployment's YAML carries over. This slice's engine runs bf16, one device,
lock-step; it refuses the fields whose features come later (see
``engine.engine.LLMEngine``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model: str = ""                       # HF id or "tiny"
    max_model_len: int = 2048             # max prompt+generation per sequence
    max_num_seqs: int = 8                 # running-batch slots
    block_size: int = 16                  # KV block granularity (tokens)
    num_blocks: int = 0                   # 0 = auto from max_model_len*max_num_seqs
    context_encoding_buckets: Sequence[int] = (128, 512)   # prefill shapes
    # decode attention-window buckets: one decode shape per bucket,
    # dispatched on the longest running sequence (empty = max_model_len only)
    token_generation_buckets: Sequence[int] = ()
    is_continuous_batching: bool = True
    # max same-bucket prompts admitted as ONE batched prefill call (rounded
    # to a power of two per call shape); 1 = serial prefill
    max_prefill_batch: int = 4
    tensor_parallel_size: int = 1
    dtype: str = "bfloat16"
    # weight-only quantization: None/"" = bf16 weights, "int8" = per-channel
    quantization: Optional[str] = None
    enable_prefix_caching: bool = False
    # on-device sampling (reference: global_topk 64, dynamic)
    global_topk: int = 64
    max_new_tokens: int = 128
    seed: int = 0
    speculative_model: str = ""
    num_speculative_tokens: int = 0
    ngram_prompt_lookup_max: int = 4
    ngram_prompt_lookup_min: int = 1
    slo_ttft_ms: float = 0.0
    slo_tpot_ms: float = 0.0
    slo_error_rate: float = 0.0
    perf_projection: str = ""
    role: str = "both"

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.max_model_len % self.block_size:
            raise ValueError("max_model_len must be a multiple of block_size")
        if not self.context_encoding_buckets:
            raise ValueError("need at least one prefill bucket")
        bad = [b for b in self.context_encoding_buckets if b > self.max_model_len]
        if bad:
            raise ValueError(f"prefill buckets {bad} exceed max_model_len")
        misaligned = [b for b in self.context_encoding_buckets
                      if b % self.block_size]
        if misaligned:
            raise ValueError(
                f"prefill buckets {misaligned} not multiples of "
                f"block_size={self.block_size}")
        bad = [b for b in self.token_generation_buckets
               if b > self.max_model_len]
        if bad:
            raise ValueError(
                f"token_generation_buckets {bad} exceed max_model_len")
        misaligned = [b for b in self.token_generation_buckets
                      if b < 1 or b % self.block_size]
        if misaligned:
            raise ValueError(
                f"token_generation_buckets {misaligned} not positive "
                f"multiples of block_size={self.block_size}")
        if self.quantization not in (None, "", "int8"):
            raise ValueError(
                f"unsupported quantization {self.quantization!r} "
                f"(supported: int8)")
        if self.speculative_model not in ("", "[ngram]"):
            raise ValueError(
                f"unsupported speculative_model "
                f"{self.speculative_model!r} (supported: \"[ngram]\")")
        if self.num_speculative_tokens < 0:
            raise ValueError("num_speculative_tokens must be >= 0")
        if self.speculative_model and self.num_speculative_tokens:
            if not (1 <= self.ngram_prompt_lookup_min
                    <= self.ngram_prompt_lookup_max):
                raise ValueError(
                    f"need 1 <= ngram_prompt_lookup_min "
                    f"({self.ngram_prompt_lookup_min}) <= "
                    f"ngram_prompt_lookup_max "
                    f"({self.ngram_prompt_lookup_max})")
            if self.num_speculative_tokens >= self.max_model_len:
                raise ValueError(
                    "num_speculative_tokens must be < max_model_len")
        for knob in ("slo_ttft_ms", "slo_tpot_ms", "slo_error_rate"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0 (0 disables)")
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"unsupported role {self.role!r} "
                f"(supported: prefill, decode, both)")

    @property
    def speculative_enabled(self) -> bool:
        return bool(self.speculative_model) and self.num_speculative_tokens > 0

    @property
    def blocks_per_seq(self) -> int:
        return self.max_model_len // self.block_size

    @property
    def total_blocks(self) -> int:
        if self.num_blocks:
            return self.num_blocks
        return self.blocks_per_seq * self.max_num_seqs

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineConfig":
        """Accept vLLM key names; unknown keys are ignored with a record."""
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs, ignored = {}, []
        for k, v in d.items():
            if k in known:
                kwargs[k] = tuple(v) if isinstance(v, list) else v
            else:
                ignored.append(k)
        cfg = cls(**kwargs)
        object.__setattr__(cfg, "_ignored_keys", tuple(ignored))
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "EngineConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    @property
    def ignored_keys(self) -> tuple:
        return getattr(self, "_ignored_keys", ())
