"""Speculative decoding: prompt-lookup drafting and acceptance bookkeeping.

Port of ``scalable_hw_agnostic_inference_tpu/engine/speculative.py``
(``SpecStats``, ``PromptLookupDrafter``, ``accept_drafts``), in numpy and
the standard library, field for field and rule for rule.

The engine commits one token per decode replay, so decode throughput is
one paged-attention walk per token. A drafter proposes up to
``num_speculative_tokens`` continuations, one verify step
(``runner.make_verify``, a captured graph per key) scores all of them and
the bonus position at once, ``k + 1`` query rows per sequence, and the
engine commits the longest prefix the model agrees with. The worst case is
one verify step per committed token; the best commits ``k + 1``.

The drafter is vLLM's ``speculative_model: "[ngram]"``: pure prompt lookup
(match the tail n-gram of prompt + generated against earlier context and
propose what followed it last time), no draft model and no weights, on the
host.

Acceptance is exact: at temperature 0 a draft survives iff it equals the
model's argmax at its position; at temperature > 0 the delta-proposal
rejection rule applies: accept draft ``d`` with probability
``p_target(d)`` (the n-gram proposal is a point mass), and on rejection
resample from the target distribution with ``d`` masked out (``oex``,
``ops.sampling.sample_excluding``). Either way every committed token is
distributed as vanilla decode's; drafts change only the speed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class SpecStats:
    """Cumulative speculative-decoding counters (one per engine).

    ``acceptance_rate`` is accepted / drafted; ``tokens_per_verify`` the
    realized commit rate per verify step (1.0 is vanilla decode's pace).
    """

    drafted: int = 0        # draft tokens submitted to verification
    accepted: int = 0       # draft tokens that survived verification
    committed: int = 0      # tokens committed by verify steps (bonus too)
    verify_steps: int = 0   # multi-token verify dispatches
    fallback_steps: int = 0  # steps that fell back to vanilla decode

    def record_verify(self, n_drafted: int, n_accepted: int,
                      n_processed: int) -> None:
        """One sequence's verification outcome: drafted and accepted count
        the verification result (the drafter's quality); ``n_processed``
        the tokens the commit walk reached (an EOS or length finish
        mid-run must not inflate ``tokens_per_verify``)."""
        self.drafted += n_drafted
        self.accepted += n_accepted
        self.committed += n_processed

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_verify(self) -> float:
        return self.committed / self.verify_steps if self.verify_steps else 0.0

    def as_dict(self) -> dict:
        return {
            "spec_drafted": self.drafted,
            "spec_accepted": self.accepted,
            "spec_committed": self.committed,
            "spec_verify_steps": self.verify_steps,
            "spec_fallback_steps": self.fallback_steps,
            "spec_acceptance_rate": round(self.acceptance_rate, 4),
            "spec_tokens_per_verify": round(self.tokens_per_verify, 4),
        }


class PromptLookupDrafter:
    """Model-free n-gram drafter (vLLM's ``[ngram]`` speculative model).

    ``draft(context)`` matches the last ``n`` tokens of the context (``n``
    from ``lookup_max`` down to ``lookup_min``) against every earlier
    position, most recent occurrence first, and proposes the up to ``k``
    tokens that followed that occurrence.
    """

    def __init__(self, k: int, lookup_max: int = 4, lookup_min: int = 1):
        if k < 1:
            raise ValueError("num_speculative_tokens must be >= 1")
        if not 1 <= lookup_min <= lookup_max:
            raise ValueError(
                f"need 1 <= ngram_prompt_lookup_min ({lookup_min}) <= "
                f"ngram_prompt_lookup_max ({lookup_max})")
        self.k = k
        self.lookup_max = lookup_max
        self.lookup_min = lookup_min

    def draft(self, context: Sequence[int]) -> List[int]:
        """Up to ``k`` continuation tokens for ``context``; ``[]`` when the
        history is too short or no earlier n-gram matches. A sliding-window
        compare in numpy: it runs per running slot per step, and its worst
        case (no match, vanilla fallback) must stay cheap."""
        ctx = list(context)
        L = len(ctx)
        if L < self.lookup_min + 1:
            return []
        arr = np.asarray(ctx, dtype=np.int64)
        # longest n-grams first: a longer match is a stronger predictor
        for n in range(min(self.lookup_max, L - 1), self.lookup_min - 1, -1):
            tail = arr[L - n:]
            # candidate starts 0 .. L-n-1: the match ends strictly before
            # the final position, so the continuation is non-empty
            windows = np.lib.stride_tricks.sliding_window_view(
                arr[:L - 1], n)
            hits = np.flatnonzero((windows == tail).all(axis=1))
            if hits.size:
                start = int(hits[-1])  # the most recent earlier occurrence
                return ctx[start + n:start + n + self.k]
        return []


def accept_drafts(draft: Sequence[int], o, oex, accept_p,
                  temperature: float, uniforms) -> tuple:
    """The acceptance walk for ONE sequence, on the host.

    ``o[i]`` is the model's sample at draft position ``i`` (the full target
    distribution), ``oex[i]`` a sample with ``draft[i]`` masked out,
    ``accept_p[i]`` the probability of ``draft[i]`` under the sampling
    distribution; ``uniforms`` the rejection draws (unused at temperature
    0, where acceptance is an exact argmax match).

    Returns ``(n_accepted, next_token)``: the committed tokens are
    ``pending + draft[:n_accepted]`` and ``next_token`` becomes the new
    pending token (the bonus sample when every draft was accepted).
    """
    nd = len(draft)
    for i in range(nd):
        if temperature <= 0.0:
            ok = int(draft[i]) == int(o[i])
        else:
            ok = float(uniforms[i]) < float(accept_p[i])
        if not ok:
            # at temperature 0 the argmax IS the corrected sample;
            # otherwise the sample from p with draft[i] removed
            nxt = int(o[i]) if temperature <= 0.0 else int(oex[i])
            return i, nxt
    return nd, int(o[nd])
