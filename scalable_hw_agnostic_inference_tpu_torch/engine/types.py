"""Engine request/response dataclasses.

Port of ``scalable_hw_agnostic_inference_tpu/engine/types.py``, field for
field (``SamplingParams``, ``Request``, ``Finished``, ``_Running``). Fields
whose features come in later slices (soft prefix, cross states, logprobs,
QoS, migration, tracing, fan-out) keep their names and defaults; this
slice's engine refuses requests that set them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from .config import EngineConfig

#: top-N alternatives a request may ask for per sampled token (the OpenAI
#: ``logprobs`` cap; the reference's ``engine/runner.py`` K_LOGPROBS)
K_LOGPROBS = 5


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    max_new_tokens: int = 128
    eos_id: int = -1            # -1: never stop on a token
    logprobs: int = 0

    def clamp(self, ecfg: EngineConfig) -> "SamplingParams":
        # global_topk == 0 means "cap disabled": leave a user-set top_k alone
        if self.top_k and ecfg.global_topk:
            top_k = min(self.top_k, ecfg.global_topk)
        else:
            top_k = self.top_k or ecfg.global_topk
        return dataclasses.replace(
            self,
            max_new_tokens=min(self.max_new_tokens, ecfg.max_new_tokens),
            top_k=top_k,
            logprobs=min(max(int(self.logprobs), 0), K_LOGPROBS),
        )


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_ids: List[int]
    params: SamplingParams
    prefix: Optional[np.ndarray] = None
    cross_states: Optional[np.ndarray] = None
    cross_len: int = 0
    # tokens generated before a recompute-preemption (they re-enter the
    # cache as prompt suffix but remain part of the client-visible output)
    already_generated: List[int] = dataclasses.field(default_factory=list)
    orig_n_prompt: int = -1
    # streaming: called on the engine-loop thread once per token that will
    # appear in Finished.token_ids, in order
    on_token: Optional[Any] = None
    deadline_at: float = 0.0
    # submission time (monotonic) for TTFT accounting; survives preemption
    t_submit: float = 0.0
    t_admit: float = 0.0
    # true first-token time (monotonic); survives preemption
    t_first: float = 0.0
    already_lp: List = dataclasses.field(default_factory=list)
    priority: int = 1
    tenant: str = ""
    idem_key: str = ""
    kv_holders: List[str] = dataclasses.field(default_factory=list)
    traceparent: str = ""
    obs_extra: Dict[str, float] = dataclasses.field(default_factory=dict)
    parent_rid: int = -1

    def __post_init__(self):
        if self.orig_n_prompt < 0:
            self.orig_n_prompt = len(self.prompt_ids)

    @property
    def prefix_len(self) -> int:
        return 0 if self.prefix is None else int(self.prefix.shape[0])


@dataclasses.dataclass
class Finished:
    req_id: int
    token_ids: List[int]        # generated tokens, EOS excluded
    n_prompt: int
    # "eos" | "length" | "rejected" | "cancelled" | "timeout" | "migrated"
    stop_reason: str
    logprobs: Optional[List[Dict[str, Any]]] = None
    timing: Optional[Dict[str, float]] = None
    migration: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class _Running:
    req: Request
    slot: int
    generated: List[int]
    pending_token: int          # sampled but not yet written to the cache
    # chunked prefill: prompt position of the next chunk (None = encoded)
    prefill_cursor: Optional[int] = None
    t_first: float = 0.0        # first-token time (TPOT accounting)
    lps: List = dataclasses.field(default_factory=list)
