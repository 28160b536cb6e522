"""Dense-cache generation (the ``llama``, ``mistral`` and ``deepseek``
units) and the byte-level tokenizer of the offline and geometry tiers.

Port of ``scalable_hw_agnostic_inference_tpu/models/generate.py``
(``GenerateResult``, ``make_generate``, ``ByteTokenizer``). The reference
jits the whole generate (prefill, a ``lax.scan`` of decode steps, sampling
and EOS bookkeeping) once per (batch, prompt bucket, max new tokens). Here
it runs eagerly on the model's device with the same contract and the same
tokens:

- the prefill over the right-padded ``[B, Tp]`` prompt writes the
  :class:`~.llama.DenseCache`'s first ``Tp`` slots and attends causally
  up to each row's ``prompt_len`` (B1 on the card);
- each decode step writes one token a row at slot ``prompt_len + t`` and
  attends the prefix before it (B2 over the cache's pool view;
  ``models/llama.py`` says why this layout gives the reference's keys);
- sampling on the device (``ops.sampling.sample_logits``) from one
  ``torch.Generator`` seeded by the call's ``seed``, so sampled tokens are
  not a JAX pod's for the same seed (the reference folds
  ``PRNGKey(seed)`` per step); temperature 0 is the argmax on both;
- EOS and PAD exactly as the reference's ``step``: a row emits its tokens
  up to and including its first EOS, then PAD; ``n_generated`` counts
  what is not PAD.

The reference's last scan step runs a forward whose token it drops; here
the loop stops before it, and stops as soon as every row is done (one
host read a step): the remaining tokens are PAD either way.

On the card a decode step's forward is one CUDA graph (:class:`DecodeStep`,
the counterpart of the reference's single executable): eager, a step at
Llama-3-8B widths is some 2,600 launches and the host's dispatch, not the
card, sets its time. Each generate keeps one cache and one graph per
batch size, reused by its later calls (a slot past a row's length is
never read, so nothing is cleared); it takes one call at a time, as the
units' one-worker model lane gives it. The prefill and the sampling stay
eager. A replay adds to each kernel wrapper's counter the launches its
capture recorded, as the engine's decode graphs do (both are captured
by ``engine.graphs.capture_graph``). On the CPU the step runs eagerly.

Over tensor-parallel ranks (a model built with a ``group``,
``serve.multihost``) every rank runs the same generate on its shard: the
cache holds the rank's kv heads, a capturable group's (NCCL) all-reduces
and gathers are captured inside each decode step's graph, and a gloo
group's steps run eagerly on the card, as the engine's do. The gathered
or all-reduced logits carry the same bits on every rank, so the sampled
tokens, drawn from generators seeded alike, and each step's ``done``
read agree between the ranks, and they leave the loop together.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..engine.graphs import capture_graph, replay_counted
from ..ops.cuda import ragged_paged_attention as _rpa
from ..ops.sampling import sample_logits
from .llama import (
    DENSE_BLOCK,
    DenseCache,
    LlamaConfig,
    group_size,
    init_cache,
    rank_heads,
)


class DecodeStep:
    """One decode step of ``B`` rows over ``cache``: the forward of
    ``tok [B, 1]`` at positions ``pos [B]`` (written at slot ``pos``),
    returning the last logits ``[B, V]``. On the card the first call
    captures it as a CUDA graph on a stream of its own (its B2 split
    scratch reserved first, so that the capture allocates nothing it
    would later move) and every call replays it; on the CPU, and on the
    card over a group that cannot be captured (gloo), it runs eagerly."""

    def __init__(self, model, cfg: LlamaConfig, cache: DenseCache,
                 batch: int):
        dev = model.device
        self.model, self.cfg, self.cache = model, cfg, cache
        self.tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int64, device=dev)
        group = model.group
        #: the step is a CUDA graph (its group's collectives captured)
        self.cuda = dev.type == "cuda" and (group is None or
                                            group.capturable)
        self.logits: Optional[torch.Tensor] = None
        self.graph = None
        self.stream = None
        #: kernel launches one replay makes, per counted wrapper
        self.launches: Dict[str, int] = {}
        self._counted: Tuple = ()
        self.replays = 0

    def _eager(self) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(self.tok, self.pos[:, None], cache=self.cache,
                              write_pos=self.pos)[:, -1]

    def _first(self) -> torch.Tensor:
        """The first call on the card: the split scratch reserved on the
        step's own stream, then the step warmed and captured there
        (``engine.graphs.capture_graph``). Returns the warm run's
        logits."""
        dev = self.tok.device
        cfg = self.cfg
        self.stream = torch.cuda.Stream(dev)
        heads, kv_heads = rank_heads(cfg, group_size(self.model.group))
        numel, counters = _rpa.split_scratch_size(
            self.tok.shape[0], 1, heads, kv_heads, cfg.head_dim,
            DENSE_BLOCK, self.cache.tables.shape[1],
            _rpa.sm_count(dev.index))
        _rpa.reserve_split_scratch(dev, self.stream.cuda_stream, numel,
                                   counters)
        cap = capture_graph(self._eager, dev, self.stream)
        self.logits, self._counted = cap.outs, cap.counted
        self.launches = cap.launches
        self.graph = cap.graph
        return cap.warm

    def __call__(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        self.tok.copy_(tok.reshape(self.tok.shape))
        self.pos.copy_(pos)
        if not self.cuda:
            return self._eager()
        if self.graph is None:
            return self._first()
        replay_counted(self.graph, self._counted)
        self.replays += 1
        return self.logits


class GenerateResult(NamedTuple):
    tokens: torch.Tensor       # [B, max_new_tokens] int32, PAD after EOS
    n_generated: torch.Tensor  # [B] int32 (includes the EOS token if emitted)


def cache_dtype_for(device: torch.device) -> torch.dtype:
    """The cache's dtype: bf16 on the card (what B1 and B2 read), fp32 on
    the CPU: the reference's rule (bf16 on the TPU, fp32 elsewhere)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def make_generate(model, cfg: LlamaConfig, *, prompt_bucket: int,
                  max_new_tokens: int, eos_id: int = 2, pad_id: int = 0,
                  cache_dtype: Optional[torch.dtype] = None
                  ) -> Callable[..., GenerateResult]:
    """A ``generate(ids, prompt_len, seed=0, temperature=1.0, top_k=0,
    top_p=1.0)`` for one (prompt_bucket, max_new_tokens) shape on
    ``model`` (a :class:`~.llama.LlamaForCausalLM`, on its device; under
    a group, one rank's, with ``cfg`` the config it was built from).

    ``ids``: ``[B, prompt_bucket]`` right-padded prompts; ``prompt_len``:
    ``[B]`` true lengths (each at least 1). Sampling knobs are scalars or
    per-row tensors. ``cache_dtype`` defaults to :func:`cache_dtype_for`.
    """
    n_slots = prompt_bucket + max_new_tokens
    #: batch size -> (its cache, its decode step), kept across calls
    state: Dict[int, Tuple[DenseCache, DecodeStep]] = {}

    def step_for(B: int, dev: torch.device):
        if B not in state:
            cache = init_cache(cfg, B, n_slots,
                               dtype=cache_dtype or cache_dtype_for(dev),
                               device=dev, group=model.group)
            state[B] = cache, DecodeStep(model, cfg, cache, B)
        return state[B]

    def generate(ids, prompt_len, seed: int = 0, temperature=1.0, top_k=0,
                 top_p=1.0) -> GenerateResult:
        dev = model.device
        ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids)
                              else ids).to(dev, torch.int64)
        plen = torch.as_tensor(np.asarray(prompt_len)
                               if not torch.is_tensor(prompt_len)
                               else prompt_len).to(dev, torch.int64)
        B, Tp = ids.shape
        if Tp != prompt_bucket:
            raise ValueError(f"ids {tuple(ids.shape)}: this generate takes "
                             f"a {prompt_bucket}-token bucket")
        knobs = [torch.as_tensor(k, device=dev)
                 if torch.is_tensor(k) else k
                 for k in (temperature, top_k, top_p)]
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        tokens = torch.full((B, max_new_tokens), pad_id, dtype=torch.int32,
                            device=dev)
        cache, step = step_for(B, dev)
        with torch.inference_mode():
            positions = torch.arange(Tp, device=dev).expand(B, Tp)
            logits = model(ids, positions, cache=cache, lengths=plen)
            last = logits[torch.arange(B, device=dev), plen - 1]
            tok = sample_logits(last, gen, *knobs)
            done = torch.zeros(B, dtype=torch.bool, device=dev)
            for t in range(max_new_tokens):
                tokens[:, t] = torch.where(done, pad_id, tok)
                done = done | (tok == eos_id)
                if t == max_new_tokens - 1 or bool(done.all()):
                    break
                nxt = sample_logits(step(tok, plen + t), gen, *knobs)
                tok = torch.where(done, eos_id, nxt)
        n_gen = (tokens != pad_id).sum(dim=1).to(torch.int32)
        return GenerateResult(tokens, n_gen)

    generate.steps = state
    return generate


class ByteTokenizer:
    """ids: 0 = PAD, 1 = BOS, 2 = EOS, byte b -> 3 + b. Round-trips any
    UTF-8 text without a vocab file."""

    pad_id, bos_id, eos_id = 0, 1, 2
    vocab_size = 259

    def encode(self, text: str, max_len: int) -> tuple:
        raw = [self.bos_id] + [3 + b for b in text.encode("utf-8")][: max_len - 1]
        n = len(raw)
        ids = np.zeros((max_len,), np.int32)
        ids[:n] = raw
        return ids, n

    def decode(self, ids) -> str:
        # ids beyond the byte range (a model vocab may be larger) are dropped
        data = bytes(int(i) - 3 for i in ids if 3 <= int(i) < 3 + 256)
        return data.decode("utf-8", errors="replace")
