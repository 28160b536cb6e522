"""Continuous-batching engine: slots, scheduler and the lock-step loop.

Port of ``scalable_hw_agnostic_inference_tpu/engine/engine.py``, its
lock-step discipline (``SHAI_ASYNC_DECODE=0``, the reference's own oracle):
``add_request``, ``step``/``_step_sync``, ``_admit_phase``,
``_admit_batch`` (same-bucket prompts admitted as ONE prefill, padded to a
power of two), ``_decode_step`` with context and batch buckets,
``_commit_pending``/``_apply_sampled``, recompute preemption
(``_preempt_lowest``), ``cancel`` and ``generate``.

A fixed slot batch (``max_num_seqs``) is decoded by one call per step; at
most one prefill group is admitted per step; paged KV with optimistic
admission and recompute preemption when the pool runs dry (the preempted
sequence's generated tokens become prompt suffix on re-admission).

Later slices bring async decode, chunked prefill (a prompt past the largest
prefill bucket raises here), the prefix cache and KV tier, logprobs,
deadlines, QoS, speculative decoding and the multimodal paths.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.bucketing import BucketRegistry
from ..core.device import DeviceLike, resolve_device
from ..models.llama import LlamaConfig, LlamaForCausalLM
from ..ops.sampling import sample_logits
from ..utils.latency import LatencyCollector
from .cache import PagedKVCache
from .config import EngineConfig
from .runner import make_decode, make_prefill
from .types import Finished, Request, SamplingParams, _Running  # noqa: F401

log = logging.getLogger(__name__)


def _unsupported(ecfg: EngineConfig) -> List[str]:
    """EngineConfig features whose ports come in later slices."""
    out = []
    if ecfg.tensor_parallel_size != 1:
        out.append("tensor_parallel_size > 1")
    if ecfg.quantization:
        out.append("quantization")
    if ecfg.enable_prefix_caching:
        out.append("enable_prefix_caching")
    if ecfg.speculative_enabled:
        out.append("speculative decoding")
    if ecfg.role != "both":
        out.append("disaggregated roles")
    return out


class LLMEngine:
    """Drive with :meth:`add_request` + :meth:`step`, or offline
    :meth:`generate`. Single-threaded: one engine per pod, the serving
    layer serializes onto it (``engine.loop``). ``device`` defaults to the
    card; pass ``"cpu"`` to run the plain paths on the CPU."""

    def __init__(self, model_cfg: LlamaConfig, model: LlamaForCausalLM,
                 ecfg: EngineConfig, device: DeviceLike = None):
        bad = _unsupported(ecfg)
        if bad:
            raise ValueError(f"not ported yet: {', '.join(bad)}")
        if model_cfg.cross_attention_layers:
            raise ValueError("mllama configs are not ported yet")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model weights are on {model.device}, the "
                             f"engine runs on {self.device}")
        self.cfg = model_cfg
        self.ecfg = ecfg
        self.model = model
        kv_dtype = torch.bfloat16 if ecfg.dtype == "bfloat16" else torch.float32
        self.cache = PagedKVCache(
            model_cfg.n_layers, model_cfg.n_kv_heads, model_cfg.head_dim,
            ecfg.total_blocks, ecfg.block_size, ecfg.blocks_per_seq,
            dtype=kv_dtype, device=self.device)
        self.buckets = BucketRegistry(sorted(ecfg.context_encoding_buckets))
        self._prefill: Dict[Tuple[int, int], Any] = {}
        # decode calls keyed (ctx_bucket, batch_bucket): the attention window
        # is the smallest token_generation_bucket covering the longest
        # running sequence, the batch the smallest power of two covering
        # the active slots
        bs = ecfg.block_size
        tg = [min(-(-t // bs), ecfg.blocks_per_seq)
              for t in ecfg.token_generation_buckets]
        self._ctx_buckets = sorted(set(tg) | {ecfg.blocks_per_seq})
        self._decode_fns: Dict[Tuple[int, int], Any] = {}
        self.waiting: deque[Request] = deque()
        self.slots: List[Optional[_Running]] = [None] * ecfg.max_num_seqs
        # serving latency instruments: TTFT includes queue time; TPOT is the
        # per-token decode pace after the first token
        self.ttft = LatencyCollector()
        self.tpot = LatencyCollector()
        self._ids = itertools.count()
        self._step_count = 0
        self._gen = torch.Generator(device=self.device).manual_seed(ecfg.seed)
        self._done_this_step: List[Finished] = []

    # -- public API --------------------------------------------------------

    def add_request(self, prompt_ids: Sequence[int],
                    params: Optional[SamplingParams] = None,
                    on_token=None) -> int:
        params = (params or SamplingParams()).clamp(self.ecfg)
        if not prompt_ids:
            raise ValueError("empty prompt")
        if params.logprobs:
            raise ValueError("logprobs are not ported yet")
        if len(prompt_ids) > self.buckets.max:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds the largest "
                f"prefill bucket {self.buckets.max} (chunked prefill is not "
                f"ported yet)")
        rid = next(self._ids)
        self.waiting.append(Request(rid, list(prompt_ids), params,
                                    on_token=on_token,
                                    t_submit=time.monotonic()))
        return rid

    def cancel(self, req_id: int) -> Optional[Finished]:
        """Abort a request wherever it is (queue or decoding), reclaiming
        its slot and blocks. Returns the partial Finished (``"cancelled"``),
        or None for an unknown/finished id."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                del self.waiting[i]
                return Finished(req_id, list(r.already_generated),
                                r.orig_n_prompt, "cancelled")
        for s in self.slots:
            if s is not None and s.req.req_id == req_id:
                self._record_tpot(s)
                self._release_slot(s)
                return Finished(req_id, s.req.already_generated + s.generated,
                                s.req.orig_n_prompt, "cancelled")
        return None

    @property
    def max_prompt_len(self) -> int:
        """Longest prompt the engine accepts: the largest prefill bucket
        (chunked prefill, which reaches max_model_len, comes later)."""
        return self.buckets.max

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    @property
    def n_running(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self) -> List[Finished]:
        """Admit (at most one prefill group), then decode the running
        batch. Returns every request that finished during this step."""
        return self._step_sync()

    def _step_sync(self) -> List[Finished]:
        """Lock-step step: marshal -> dispatch -> readback -> bookkeeping,
        one blocking device round trip per decode step."""
        self._step_count += 1
        self._done_this_step = []
        self._admit_phase()
        if any(s is not None for s in self.slots):
            self._decode_step()
        return self._done_this_step

    def _admit_phase(self) -> None:
        self._admit_batch()

    def generate(self, prompts: Sequence[Sequence[int]],
                 params: Optional[SamplingParams] = None) -> List[Finished]:
        """Offline batch: submit all, run to completion, return in order."""
        ids = [self.add_request(p, params) for p in prompts]
        want = set(ids)
        done: Dict[int, Finished] = {}
        while want - set(done):
            for f in self.step():
                done[f.req_id] = f
        return [done[i] for i in ids]

    # -- internals ---------------------------------------------------------

    def _release_slot(self, s: _Running) -> None:
        self.cache.release(s.req.req_id)
        self.slots[s.slot] = None

    def _finish(self, fin: Finished) -> None:
        self._done_this_step.append(fin)

    def _mark_first_token(self, req: Request) -> float:
        """TTFT record point (first admission only — a preemption resume is
        not a new first token); returns the timestamp for TPOT."""
        now = time.monotonic()
        if not req.already_generated and req.t_submit:
            self.ttft.record(now - req.t_submit)
        if not req.t_first:
            req.t_first = now
        return now

    def _record_tpot(self, s: _Running) -> None:
        """Per-token decode pace: elapsed from token 1's sample to token
        n's commit spans n decode steps."""
        if s.t_first and s.generated:
            self.tpot.record((time.monotonic() - s.t_first)
                             / len(s.generated))

    def _start_slot(self, slot: int, req: Request, tok: int) -> None:
        """Seat a fully-prefilled request with its sampled first token."""
        self.slots[slot] = _Running(req, slot, [], pending_token=tok,
                                    t_first=self._mark_first_token(req))

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _need_blocks(self, n_tokens: int) -> int:
        """Optimistic admission cost: prompt blocks plus one decode block of
        headroom, capped at what one sequence can ever use."""
        return min(self.cache._blocks_needed(n_tokens + self.ecfg.block_size),
                   self.ecfg.blocks_per_seq)

    def _try_reserve(self, req: Request, n_tokens: int) -> bool:
        """True when the pool can hold ``n_tokens`` plus one decode block.
        When it can't AND nothing is running, the request is rejected and
        finished so the queue can't starve."""
        if self._need_blocks(n_tokens) <= self.cache.n_available:
            return True
        if not any(s is not None for s in self.slots):
            self.waiting.popleft()
            log.error("rejecting req %d: needs %d blocks, pool max %d",
                      req.req_id, self._need_blocks(n_tokens),
                      self.cache.allocator.n_free)
            self._finish(Finished(req.req_id, list(req.already_generated),
                                  req.orig_n_prompt, "rejected"))
        return False

    def _admit_batch(self) -> None:
        """Admit up to ``max_prefill_batch`` same-bucket prompts as ONE
        batched prefill call."""
        free = sum(s is None for s in self.slots)
        kmax = min(free, max(1, self.ecfg.max_prefill_batch),
                   self.ecfg.max_num_seqs)
        if not self.waiting or kmax < 1:
            return
        while kmax & (kmax - 1):  # largest power of two <= kmax
            kmax &= kmax - 1
        group: List[Request] = []
        bucket = -1
        while self.waiting and len(group) < kmax:
            req = self.waiting[0]
            if len(req.prompt_ids) > self.buckets.max:
                # a preemption resume (prompt + generated) can outgrow the
                # largest bucket; without chunked prefill keep the tail, as
                # the reference's single-sequence admission does
                req.prompt_ids = req.prompt_ids[-self.buckets.max:]
            b = self.buckets.bucket_for(len(req.prompt_ids))
            if bucket >= 0 and b != bucket:
                break  # different bucket: next step's batch
            n = len(req.prompt_ids)
            if group:
                if self._need_blocks(n) > self.cache.n_available:
                    break  # partial group admitted — retry next step
            elif not self._try_reserve(req, n):
                if self.waiting and self.waiting[0] is req:
                    break  # pool busy — retry next step
                continue   # rejected-and-finished; consider the next head
            bucket = b
            self.waiting.popleft()
            if not req.t_admit:
                req.t_admit = time.monotonic()
            self.cache.admit(req.req_id, n)
            group.append(req)
        if not group:
            return
        K = len(group)
        Kp = 1 << (K - 1).bit_length()  # call batch: power of two
        M = self.ecfg.blocks_per_seq
        ids = np.zeros((Kp, bucket), np.int32)
        n_text = np.ones((Kp,), np.int32)     # dummy rows: 1 masked token
        tables = np.zeros((Kp, M), np.int32)  # dummy rows: null block 0
        temp = np.ones((Kp,), np.float32)
        topk = np.zeros((Kp,), np.int32)
        topp = np.ones((Kp,), np.float32)
        for i, req in enumerate(group):
            ids[i, :len(req.prompt_ids)] = req.prompt_ids
            n_text[i] = len(req.prompt_ids)
            tables[i] = self.cache.seq(req.req_id).table(M)
            temp[i] = req.params.temperature
            topk[i] = req.params.top_k
            topp[i] = req.params.top_p
        fn = self._prefill_for(bucket, Kp)
        dev = self.device
        with torch.inference_mode():
            _, logits = fn(self.model, self.cache.kv,
                           torch.from_numpy(ids).to(dev),
                           torch.from_numpy(n_text).to(dev),
                           torch.from_numpy(tables).to(dev))
            toks = sample_logits(logits, self._gen,
                                 torch.from_numpy(temp).to(dev),
                                 torch.from_numpy(topk).to(dev),
                                 torch.from_numpy(topp).to(dev)).cpu()
        for i, req in enumerate(group):
            self._start_slot(self._free_slot(), req, int(toks[i]))

    def _prefill_for(self, bucket: int, n_seqs: int = 1):
        key = (bucket, n_seqs)
        if key not in self._prefill:
            self._prefill[key] = make_prefill(
                self.cfg, self.ecfg.block_size, self.ecfg.blocks_per_seq,
                bucket, n_seqs=n_seqs)
        return self._prefill[key]

    def _batch_bucket(self, n_active: int) -> int:
        """Smallest power-of-two batch covering ``n_active``."""
        b = 1
        while b < n_active:
            b *= 2
        return min(b, self.ecfg.max_num_seqs)

    def _decode_for(self, m_blocks: int, n_active: int = -1):
        """Decode call for the smallest (context, batch) buckets covering
        the running set."""
        m = next(b for b in self._ctx_buckets if b >= m_blocks)
        bb = (self.ecfg.max_num_seqs if n_active < 0
              else self._batch_bucket(n_active))
        key = (m, bb)
        if key not in self._decode_fns:
            self._decode_fns[key] = make_decode(
                self.cfg, self.ecfg.block_size, self.ecfg.blocks_per_seq,
                bb, ctx_blocks=m)
        return bb, self._decode_fns[key]

    def _preempt_lowest(self) -> None:
        """Recompute-preempt the most recently admitted sequence: its
        generated + pending tokens become prompt suffix on re-admission."""
        victim = max((s for s in self.slots if s is not None),
                     key=lambda s: s.req.req_id)
        log.warning("preempting seq %d (block pool exhausted)",
                    victim.req.req_id)
        self._release_slot(victim)
        committed = victim.generated + [victim.pending_token]
        p = victim.req.params
        if victim.req.on_token is not None and victim.pending_token != p.eos_id:
            # the pending token WILL be in the final output (as prompt
            # suffix): stream it now, exactly once per output token
            victim.req.on_token(victim.pending_token)
        emitted = victim.req.already_generated + committed
        if victim.pending_token == p.eos_id or len(committed) >= p.max_new_tokens:
            self._record_tpot(victim)
            if emitted and emitted[-1] == p.eos_id:
                emitted = emitted[:-1]
                reason = "eos"
            else:
                reason = "length"
            self._finish(Finished(victim.req.req_id, emitted,
                                  victim.req.orig_n_prompt, reason))
            return
        self._record_tpot(victim)
        params = dataclasses.replace(
            p, max_new_tokens=p.max_new_tokens - len(committed))
        self.waiting.appendleft(Request(
            victim.req.req_id, victim.req.prompt_ids + committed, params,
            already_generated=emitted,
            orig_n_prompt=victim.req.orig_n_prompt,
            on_token=victim.req.on_token,
            t_submit=victim.req.t_submit, t_admit=victim.req.t_admit,
            t_first=victim.req.t_first))

    def _grow_running(self) -> None:
        """Reserve one cache token per decoding slot for its pending token,
        recompute-preempting on pool exhaustion (never down to zero running
        sequences)."""
        for s in list(self.slots):
            if s is None or self.slots[s.slot] is not s:
                continue  # empty, or preempted by an earlier iteration
            while True:
                try:
                    self.cache.extend(s.req.req_id, 1)
                    break
                except MemoryError:
                    if sum(x is not None for x in self.slots) <= 1:
                        raise  # one seq must always fit: config error
                    self._preempt_lowest()
                    if self.slots[s.slot] is not s:
                        break  # s itself was preempted

    def _running_slots(self) -> List[_Running]:
        return [s for s in self.slots if s is not None]

    def _max_ctx_blocks(self, running) -> int:
        m_blocks = 1
        for s in running:
            m_blocks = max(m_blocks, self.cache._blocks_needed(
                self.cache.seq(s.req.req_id).n_tokens))
        return m_blocks

    def _decode_step(self) -> None:
        self._grow_running()
        running = self._running_slots()
        if not running:
            return
        Bb, decode = self._decode_for(self._max_ctx_blocks(running),
                                      len(running))
        M = self.ecfg.blocks_per_seq
        tables = np.zeros((Bb, M), np.int32)
        tokens = np.zeros((Bb,), np.int32)
        pos = np.zeros((Bb,), np.int32)
        temp = np.ones((Bb,), np.float32)
        topk = np.zeros((Bb,), np.int32)
        topp = np.ones((Bb,), np.float32)
        for i, s in enumerate(running):
            alloc = self.cache.seq(s.req.req_id)
            tables[i] = alloc.table(M)
            tokens[i] = s.pending_token
            pos[i] = alloc.n_tokens - 1
            temp[i] = s.req.params.temperature
            topk[i] = s.req.params.top_k
            topp[i] = s.req.params.top_p
        dev = self.device
        with torch.inference_mode():
            _, nxt = decode(self.model, self.cache.kv,
                            torch.from_numpy(tokens).to(dev),
                            torch.from_numpy(pos).to(dev),
                            torch.from_numpy(tables).to(dev), self._gen,
                            torch.from_numpy(temp).to(dev),
                            torch.from_numpy(topk).to(dev),
                            torch.from_numpy(topp).to(dev))
            nxt = nxt.cpu().numpy()
        self._commit_pending(running)
        self._apply_sampled(running, nxt)

    def _commit_pending(self, running) -> None:
        """Commit every running slot's pending token: append/stream it, run
        the EOS/length ladder, and finish + release what's done."""
        for s in running:
            if self.slots[s.slot] is not s:
                continue
            s.generated.append(s.pending_token)
            p = s.req.params
            hit_eos = s.pending_token == p.eos_id
            if hit_eos:
                s.generated.pop()  # exclude EOS from the emitted text
            elif s.req.on_token is not None:
                s.req.on_token(s.pending_token)
            full = len(s.generated) >= p.max_new_tokens
            total = self.cache.seq(s.req.req_id).n_tokens
            out_of_len = total >= self.ecfg.max_model_len
            if hit_eos or full or out_of_len:
                self._record_tpot(s)
                self._finish(Finished(
                    s.req.req_id, s.req.already_generated + s.generated,
                    s.req.orig_n_prompt, "eos" if hit_eos else "length"))
                self._release_slot(s)

    def _apply_sampled(self, running, nxt) -> None:
        """Mirror the sampled tokens into the surviving slots'
        ``pending_token``."""
        for i, s in enumerate(running):
            if self.slots[s.slot] is s:
                s.pending_token = int(nxt[i])
