"""Per-token logprob capture (the OpenAI ``logprobs`` field).

Port of ``scalable_hw_agnostic_inference_tpu/engine/logprobs.py``
(``_lp_entry``, ``_record_admission_lps``). Decode steps carry their
readout as static outputs of the captured graph (``engine/graphs.py``);
the first token sampled at admission or on a prompt's last continuation
chunk takes it here, eagerly, from the prefill logits, and only when some
row asked for logprobs.
"""

from __future__ import annotations

from typing import Dict

import torch

from .runner import token_logprobs


def _lp_entry(n_top: int, tok: int, tok_lp, top_ids, top_lp) -> Dict:
    return {"token": int(tok), "logprob": float(tok_lp),
            "top_ids": [int(i) for i in top_ids[:n_top]],
            "top_logprobs": [float(v) for v in top_lp[:n_top]]}


def _record_admission_lps(eng, logits: torch.Tensor, toks, rows) -> None:
    """Logprob entries for freshly sampled first tokens: ``logits`` are
    the prefill's ``[K, V]`` next-token logits, ``toks`` the sampled ids
    by batch row, and ``rows`` maps batch row -> the seated ``_Running``."""
    with torch.inference_mode():
        ids, lps, tok_lp = token_logprobs(
            logits, torch.as_tensor(list(toks), dtype=torch.int32,
                                    device=logits.device))
        ids, lps, tok_lp = ids.cpu().numpy(), lps.cpu().numpy(), \
            tok_lp.cpu().numpy()
    for i, s in rows:
        n_top = s.req.params.logprobs
        if n_top:
            s.lps.append(_lp_entry(n_top, toks[i], tok_lp[i], ids[i],
                                   lps[i]))
