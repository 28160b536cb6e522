"""Continuous-batching engine: slots, scheduler, and the async and
lock-step decode loops.

Port of ``scalable_hw_agnostic_inference_tpu/engine/engine.py``:
``add_request``, ``step`` with its two disciplines behind the
``SHAI_ASYNC_DECODE`` gate (``_resolve_async``, default on): the async
pipeline (``_step_async``, ``_steady_step``, ``_decode_dispatch``,
``_dispatch_async``, ``_retire_pipe``, ``_flush_pipeline``,
``finish_pending``) and the lock-step path (``_step_sync``,
``_decode_step``), the reference's own oracle; ``_admit_phase``,
``_admit_batch`` (same-bucket prompts admitted as ONE prefill, padded to a
power of two), chunked prefill (``_admit_long``, ``_continue_prefill``,
``_cont_for``/``_cont_key``/``_cont_args``; the non-fused, plain-text
branches), context and batch buckets (``_decode_for``, counting a rebuild
after warmup as the reference counts a recompile), ``_marshal_running``
(the text columns), ``_commit_pending``/``_apply_sampled`` with their
logprob entries, recompute preemption (``_preempt_lowest``, keyed on
``(priority, req_id)`` under ``SHAI_QOS``), ``cancel`` (the reference's
``_abort`` teardown, with its pipeline flush), deadlines
(``_expire_deadlines``, stop reason ``"timeout"``, the ``deadline``
flush), the weighted-fair dequeue under ``SHAI_QOS``
(``resilience.qos.schedule_rotate``), the step records, pad accounting and
latency histograms ``/metrics`` reads, ``n_executables`` and
``generate``; ``warm_executables`` lives in ``engine/warm.py``, the
logprob entries in ``engine/logprobs.py``.

A fixed slot batch (``max_num_seqs``) is decoded by one call per step; at
most one prefill group is admitted per step; paged KV with optimistic
admission and recompute preemption when the pool runs dry (the preempted
sequence's generated tokens become prompt suffix on re-admission).

Each decode key is one :class:`~.graphs.DecodeGraph`: a CUDA graph captured
when the key is first built (by ``warm_executables`` before readiness), or
the same function run eagerly on the CPU. Both disciplines replay the same
graphs, so they run the same device work; prefill and the continuation
chunks stay eager. Every graph computes the logprob readout; a step copies
it to the host only when a running request asked for logprobs, and the
first token's entry comes from the prefill logits, eagerly.

The async pipeline (the reference's ``engine.py:860-880``): step N+1 is
dispatched with step N's sampled tokens and positions fed back on the
device, BEFORE step N's tokens are read back; step N's host bookkeeping
(EOS and length checks, streaming) then runs while N+1 executes. Every
event that changes the batch composition or the control flow (a join, a
finish, a preemption, a cancel, pool pressure, a chunking slot) first
flushes the pipeline: the in-flight step is retired, the surviving slots'
host mirrors catch up, and a finished or cancelled slot's extra token is
discarded (never emitted; its reservation frees with the slot).
Token-exactness against lock-step holds by construction: the dispatch
composition, the batch-row packing and the draws of step k are all fixed
before step k-1's readback (a finishing slot rides exactly one extra
dispatch in both disciplines), and both draw their uniforms from the one
generator in the same order, so pipelining reorders host work only.

A prompt longer than the largest prefill bucket ``C`` chunks: its whole
block run is allocated at admission, the first ``C`` tokens go through the
bucketed prefill, and each later step encodes one more ``C``-token chunk
(``runner.make_prefill_cont``) while the decode batch keeps running; the
final chunk samples the first token and the slot joins the decode batch.
At most one sequence chunks at a time. Prompts are capped at
``_chunk_cap`` (whole chunks, one position left to generate) by keeping
their tail, as the reference does.

Five switches of the reference, read at construction:

- ``SHAI_ASYNC_DECODE`` (default on): ``0`` runs lock-step;
- ``SHAI_RAGGED_ATTENTION=1``: decode attends the full window through B3
  (one context entry instead of the ``token_generation_buckets`` ladder)
  and the continuation takes its start as data (one function per chunk
  bucket instead of one per start);
- ``SHAI_KV_QUANT=int8``: the pool holds int8 blocks and per-(block, kv
  head) f32 scales. An unknown value warns and leaves it off;
- ``SHAI_FUSED_STEP=1`` (with ragged attention only): decode and the
  continuation chunk share ONE executable per batch bucket
  (``runner.make_fused_step``, a captured graph each, plus one bb=1 graph
  for chunk-only calls). An intermediate chunk parks its window
  (``_continue_prefill``) and rides the next decode replay; a final chunk
  runs chunk-only and the host samples its raw logits as the laddered
  path does. Every path that would skip or reorder around that replay
  dispatches the parked window first (``_flush_chunk``: preemption, abort,
  the end of every step). The decode and ragged-continuation ladders
  collapse into the fused keys;
- ``SHAI_KV_COW=1``: an ``n > 1`` group queued whole (``add_request``'s
  ``parent_rid``, ``EngineLoop.submit_group``) is admitted as ONE prefill
  (``_admit_fanout``): its siblings fork the prompt blocks
  (``cache.fork_sequence``), and the first divergent decode write copies
  the shared tail block. The K rows sample their first token from the one
  logits row tiled to the ``Kp`` batch layout, drawing what a ``Kp``-row
  batched admission of K identical prompts draws. Cancel or deadline of
  any member aborts the group through the loop (``fanout_siblings``).

The operating layer's hooks (the reference's ``engine.py:300-320``,
``:802-807``, ``:1076-1241``, ``:1323``, ``:1906-2131``): the SLO engine,
the perf sentinel and the HBM ledger ride ``self.obs`` (built at
construction from ``SHAI_SLO_*``, ``SHAI_PERF_*`` and the card's
memory); every step feeds them host numbers only (its host seconds, the
tokens it committed, the allocator's host counters), with no device
tensor, no copy and no synchronize, so the replay path is unchanged. The
fault sites ``engine.step`` (step entry, both disciplines),
``engine.kv_reserve`` (``_try_reserve``) and ``engine.compile`` (each
executable-factory miss, before the function is built: so before its
eager warm call and before a graph capture opens) fire as the
reference's do. Prefill calls and decode replays run inside
``obs.trace.annotate`` ranges (``engine.prefill``, ``engine.decode``),
entered only while a profiler session is active. Every ``Finished``
carries its phase ``timing``, which the serving layer grafts onto the
request's trace, and each step record its ``finished_ids``.

Later slices bring the prefix cache and KV tier (and with them cached
admission through the fused step), speculative decoding and the
multimodal paths.
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
from ..obs import sentinel as obs_sentinel
from ..obs.hbm import HbmLedger
from ..obs.slo import SloEngine, SloTargets
from ..obs.steploop import StepTelemetry
from ..obs.trace import annotate
from ..ops.attention import mixed_phase_groups
from ..ops.cuda.ragged_paged_attention import (
    groups_scratch_size,
    sm_count,
    split_scratch_bytes,
    split_scratch_size,
)
from ..ops.sampling import sample_logits
from ..resilience import faults as _faults
from ..resilience import qos as _qos
from ..utils.env import env_bool, env_int, env_str
from ..utils.latency import LatencyCollector
from . import warm as _warm_mod
from .cache import PagedKVCache
from .config import EngineConfig
from .graphs import DecodeGraph, GraphPool
from .logprobs import _lp_entry, _record_admission_lps
from .resident import (
    RESIDENT,
    InflightStep,
    ResidentBatch,
    composition_sig,
    upload,
)
from .runner import (
    make_decode,
    make_fused_step,
    make_prefill,
    make_prefill_cont,
)
from .types import (  # noqa: F401
    K_LOGPROBS,
    Finished,
    Request,
    SamplingParams,
    _Running,
)

log = logging.getLogger(__name__)


def _resolve_async() -> bool:
    """``SHAI_ASYNC_DECODE`` gate, default ON: pipelined decode with
    device-resident batch state and one-step-lookahead dispatch. ``0`` runs
    the lock-step path, the oracle the differential tests compare
    against."""
    return env_bool("SHAI_ASYNC_DECODE", True)


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
        # int8 KV blocks (SHAI_KV_QUANT=int8, default off). Lenient parse: a
        # typo'd value warns and stays off rather than crash-looping a pod
        kvq = env_str("SHAI_KV_QUANT", "").strip().lower()
        if kvq not in ("", "0", "off", "none", "int8"):
            log.warning("SHAI_KV_QUANT=%r not recognized (supported: int8)"
                        " — KV quantization stays off", kvq)
            kvq = ""
        self._kv_quant = kvq == "int8"
        # ragged paged attention (SHAI_RAGGED_ATTENTION, default off)
        self._ragged = env_bool("SHAI_RAGGED_ATTENTION", False)
        self.cache = PagedKVCache(
            model_cfg.n_layers, model_cfg.n_kv_heads, model_cfg.head_dim,
            ecfg.total_blocks, ecfg.block_size, ecfg.blocks_per_seq,
            dtype=kv_dtype, device=self.device, quant=self._kv_quant)
        self.buckets = BucketRegistry(sorted(ecfg.context_encoding_buckets))
        # chunked-prefill prompt cap: whole bucket-sized chunks only, and at
        # least one position left to generate
        C = self.buckets.max
        self._chunk_cap = min(ecfg.max_model_len - 1,
                              (ecfg.max_model_len // C) * C)
        self._prefill: Dict[tuple, Any] = {}
        # decode calls keyed (ctx_bucket, batch_bucket): the attention window
        # is the smallest token_generation_bucket covering the longest
        # running sequence, the batch the smallest power of two covering
        # the active slots
        bs = ecfg.block_size
        tg = [min(-(-t // bs), ecfg.blocks_per_seq)
              for t in ecfg.token_generation_buckets]
        self._ctx_buckets = sorted(set(tg) | {ecfg.blocks_per_seq})
        if self._ragged:
            # B3 owns the full window with per-row cost: one context entry
            self._ctx_buckets = [ecfg.blocks_per_seq]
        self._decode_fns: Dict[Tuple[int, int], DecodeGraph] = {}
        # fused mixed-phase step (SHAI_FUSED_STEP, default off; ragged
        # only): one graph per batch bucket replaces the decode and ragged
        # continuation ladders, and one more bb=1 graph takes the
        # chunk-only calls (its decode inputs stay null)
        self._fused = env_bool("SHAI_FUSED_STEP", False) and self._ragged
        self._fused_fns: Dict[int, DecodeGraph] = {}
        self._fused_chunk: Optional[DecodeGraph] = None
        # the parked continuation window (ids [1, C], n_text, table [1, M],
        # start): rides the next decode replay; never outlives its step
        self._pending_chunk: Optional[tuple] = None
        # copy-on-write n > 1 fan-out (SHAI_KV_COW, default off)
        self._kv_cow = env_bool("SHAI_KV_COW", False)
        # fan-out bookkeeping: parent request id -> live sibling ids, and
        # each member's parent (cancel and deadline act on the group)
        self._fanout_groups: Dict[int, set] = {}
        self._rid_parent: Dict[int, int] = {}
        # the decode graphs' shared memory pool and capture stream, with
        # the split scratch reserved for the largest key of the closed set
        # before any capture (on the CPU: nothing to share)
        self._graphs = GraphPool(self.device)
        self._graphs.reserve(self._scratch_needs())
        self.obs = StepTelemetry(total_blocks=ecfg.total_blocks)
        self._warmed = False
        # multi-tenant QoS (SHAI_QOS, default off): the weighted-fair
        # dequeue and the priority-keyed preemption victim
        self._sched = (_qos.WeightedFairScheduler.from_env()
                       if _qos.qos_enabled() else None)
        self.obs.qos_sched = self._sched
        # per-tenant telemetry is gated: an untagged FIFO pod never pays
        # the telemetry lock in add_request and grows no tenant labels
        self._tenant_seen = self._sched is not None
        # conformance instruments (the reference's engine.py:300-320): SLO
        # burn rates, the perf sentinel (no projection unless one is
        # given: obs/sentinel.py) and the HBM ledger ride the telemetry
        self.obs.slo = SloEngine.maybe_from_env(SloTargets(
            ttft_ms=ecfg.slo_ttft_ms, tpot_ms=ecfg.slo_tpot_ms,
            error_rate=ecfg.slo_error_rate))
        self.obs.sentinel = obs_sentinel.PerfSentinel.from_env(
            default_key=(ecfg.perf_projection
                         or obs_sentinel.default_projection_key(
                             ecfg.model, quantized=ecfg.quantization == "int8",
                             tp=ecfg.tensor_parallel_size)))
        self._cuda_mem = self.device.type == "cuda"
        self.obs.hbm = HbmLedger(bytes_limit=(
            torch.cuda.get_device_properties(self.device).total_memory
            if self._cuda_mem else 0.0))
        # ledger cadence: every Nth step (default every step; the drift
        # windows count samples, so a wider cadence only slows them)
        self._hbm_every = max(1, env_int("SHAI_HBM_SAMPLE_EVERY", 1))
        self._static_pools: Optional[Dict[str, float]] = None
        self._tokens_this_step = 0
        self._n_exec_last = 0
        self._step_kind = "idle"
        # async decode pipeline (SHAI_ASYNC_DECODE, default on)
        self._async = _resolve_async()
        self._pipe: Optional[InflightStep] = None
        self._res = ResidentBatch()
        self._t_fetch = 0.0          # last decode-readback completion
        self._last_decode_step = -2  # step-gap continuity gate
        # host buffers each dispatch copies its sampled tokens into, two so
        # that the step in flight and the step retiring never share one;
        # pinned on the card, with the event after each copy
        cuda = self.device.type == "cuda"
        S = ecfg.max_num_seqs
        self._stage = [torch.zeros((S,), dtype=torch.int32,
                                   pin_memory=cuda) for _ in range(2)]
        # and the logprob readout (top_ids, top_lp, tok_lp) beside them,
        # copied only when a running request asked for logprobs
        self._stage_lp = [
            (torch.zeros((S, K_LOGPROBS), dtype=torch.int32, pin_memory=cuda),
             torch.zeros((S, K_LOGPROBS), dtype=torch.float32,
                         pin_memory=cuda),
             torch.zeros((S,), dtype=torch.float32, pin_memory=cuda))
            for _ in range(2)]
        self._stage_ev = [torch.cuda.Event() if cuda else None
                          for _ in range(2)]
        self._stage_i = 0
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
                    on_token=None, deadline_at: float = 0.0,
                    priority: int = _qos.PRIORITY_NORMAL,
                    tenant: str = "", parent_rid: int = -1,
                    traceparent: str = "", idem_key: str = "") -> int:
        """Queue a request. ``deadline_at``: an absolute
        ``time.monotonic()`` instant (0 = none) past which it finishes as
        ``"timeout"``; ``priority`` (0 high, 1 normal, 2 low, clamped) and
        ``tenant`` are its QoS tag, read under ``SHAI_QOS``.
        ``parent_rid``: the ``n > 1`` fan-out group it belongs to, named by
        its leader's id; ``-2`` makes this request the leader (its own id
        becomes the parent), ``-1`` none. ``traceparent`` and ``idem_key``
        ride the request (its W3C trace context and idempotency key)."""
        params = (params or SamplingParams()).clamp(self.ecfg)
        if not prompt_ids:
            raise ValueError("empty prompt")
        if len(prompt_ids) > self._chunk_cap:
            # past the chunkable cap: keep the tail
            prompt_ids = list(prompt_ids)[-self._chunk_cap:]
        rid = next(self._ids)
        if parent_rid == -2:
            parent_rid = rid
        if parent_rid >= 0:
            self._rid_parent[rid] = parent_rid
            self._fanout_groups.setdefault(parent_rid, set()).add(rid)
        priority = min(max(int(priority), _qos.PRIORITY_HIGH),
                       _qos.PRIORITY_LOW)
        tenant = _qos.sanitize_tenant(tenant)
        if tenant or priority != _qos.PRIORITY_NORMAL:
            self._tenant_seen = True
        if self._tenant_seen:
            self.obs.count_tenant_request(tenant, _qos.class_name(priority))
        self.waiting.append(Request(rid, list(prompt_ids), params,
                                    on_token=on_token,
                                    deadline_at=deadline_at,
                                    t_submit=time.monotonic(),
                                    priority=priority, tenant=tenant,
                                    traceparent=traceparent,
                                    idem_key=idem_key,
                                    parent_rid=parent_rid))
        return rid

    def fanout_siblings(self, rid: int) -> List[int]:
        """Live request ids of the fan-out group holding ``rid`` (``rid``
        itself included; ``[rid]`` outside any group). The engine loop
        cancels through this, so cancelling one choice of an ``n > 1``
        request aborts them all."""
        parent = self._rid_parent.get(rid)
        if parent is None:
            return [rid]
        return sorted(self._fanout_groups.get(parent, {rid}) | {rid})

    def _prune_fanout(self, rid: int) -> None:
        """Drop a finished or aborted member from its fan-out group."""
        parent = self._rid_parent.pop(rid, None)
        if parent is not None:
            group = self._fanout_groups.get(parent)
            if group is not None:
                group.discard(rid)
                if not group:
                    del self._fanout_groups[parent]

    def cancel(self, req_id: int) -> Optional[Finished]:
        """Abort a request wherever it is (queue, mid-prefill or decoding),
        reclaiming its slot and blocks. Returns the partial Finished
        (``"cancelled"``), or None for an unknown/finished id."""
        return self._abort(req_id, "cancelled")

    def _abort(self, req_id: int, reason: str) -> Optional[Finished]:
        """THE teardown for a request leaving early: remove it from the
        queue or its slot, release exactly its cache blocks, and return the
        partial Finished."""
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                del self.waiting[i]
                self._prune_fanout(req_id)
                return Finished(req_id, list(r.already_generated),
                                r.orig_n_prompt, reason,
                                logprobs=self._queued_lps(r),
                                timing=self._timing_of(r))
        abort_slot = next((s for s in self.slots
                           if s is not None and s.req.req_id == req_id),
                          None)
        if abort_slot is not None:
            # the in-flight lookahead step may have computed one extra
            # token for this slot: retire it so the host mirrors are
            # current before teardown; the extra token is discarded (never
            # emitted) and its reservation frees with the slot below; a
            # parked window writes before the blocks go
            self._flush_pipeline(reason)
            self._flush_chunk()
        for s in self.slots:
            if s is not None and s.req.req_id == req_id:
                self._record_tpot(s)
                self._release_slot(s)
                self._prune_fanout(req_id)
                return Finished(
                    req_id, s.req.already_generated + s.generated,
                    s.req.orig_n_prompt, reason,
                    logprobs=((s.req.already_lp + s.lps[:len(s.generated)])
                              if s.req.params.logprobs else None),
                    timing=self._timing_of(s.req, s.t_first))
        return None

    @staticmethod
    def _queued_lps(req: Request):
        """The logprob entries of a request finishing from the queue: the
        ones it had before a preemption (None when it asked for none)."""
        return list(req.already_lp) if req.params.logprobs else None

    def _expire_deadlines(self) -> None:
        """Finish every request whose deadline passed (queued, mid-chunk
        or decoding) with stop reason ``"timeout"``, releasing its slot
        and blocks the same step. Step-granular: a request is at most one
        engine step late. One linear pass over the queue, keeping arrival
        order, before the weighted-fair head selection."""
        now = time.monotonic()
        expired = [r for r in self.waiting if 0.0 < r.deadline_at <= now]
        if expired:
            kept = [r for r in self.waiting
                    if not 0.0 < r.deadline_at <= now]
            self.waiting.clear()
            self.waiting.extend(kept)
            for r in expired:
                log.warning("req %d exceeded its deadline (%d tokens "
                            "generated)", r.req_id, len(r.already_generated))
                self._finish(Finished(
                    r.req_id, list(r.already_generated), r.orig_n_prompt,
                    "timeout", logprobs=self._queued_lps(r),
                    timing=self._timing_of(r)))
        for rid in [s.req.req_id for s in self.slots
                    if s is not None and 0.0 < s.req.deadline_at <= now]:
            fin = self._abort(rid, "timeout")
            if fin is not None:
                log.warning("req %d exceeded its deadline (%d tokens "
                            "generated)", rid, len(fin.token_ids))
                self._finish(fin)

    def warm_executables(self) -> int:
        return _warm_mod.warm_executables(self)

    def _run_warm_calls(self) -> None:
        _warm_mod._run_warm_calls(self)

    @property
    def n_executables(self) -> int:
        """Built functions, as the reference counts executables: the
        chunk-only graph is a second capture of the bb=1 fused function."""
        return (len(self._prefill) + len(self._decode_fns)
                + len(self._fused_fns))

    @property
    def max_prompt_len(self) -> int:
        """Longest prompt the engine takes untruncated: the chunked-prefill
        cap, which ``add_request`` enforces by keeping a longer prompt's
        tail. The serving layer truncates its tokenizer output to this."""
        return self._chunk_cap

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    @property
    def n_running(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_chunking(self) -> int:
        return sum(s is not None and s.prefill_cursor is not None
                   for s in self.slots)

    def step(self) -> List[Finished]:
        """Admit (at most one prefill group), then decode the running
        batch. Returns every request that finished during this step.

        Two dispatch disciplines behind one contract (``SHAI_ASYNC_DECODE``):
        the async path pipelines decode dispatches one step ahead of the
        host readback; the lock-step path is the reference oracle. Both
        commit, stream and finish the same tokens on the same ``step()``
        call."""
        t0 = time.monotonic()
        self._tokens_this_step = 0
        self._step_kind = "idle"
        inj = _faults.get()
        if inj.active:
            # chaos sites: step latency/stall (watchdog and deadline
            # fodder) and step crash (the engine-loop-death path), on the
            # host before this step enqueues anything
            inj.sleep_at(_faults.ENGINE_STEP)
            inj.raise_at(_faults.ENGINE_STEP)
        done = self._step_async() if self._async else self._step_sync()
        self._record_step(time.monotonic() - t0)
        return done

    def _record_step(self, duration_s: float) -> None:
        """One step record (occupancy, KV pressure, finished ids, tenant
        gauges), then the conformance feeds: the perf sentinel's (tokens,
        host seconds) sample and one HBM ledger tick. Host numbers only."""
        tenants = None
        if self._tenant_seen:
            tenants = {}
            for r in self.waiting:
                tenants.setdefault(r.tenant, [0, 0])[0] += 1
            for s in self.slots:
                if s is not None:
                    tenants.setdefault(s.req.tenant, [0, 0])[1] += 1
        self.obs.record_step(
            kind=self._step_kind, duration_s=duration_s,
            n_running=self.n_running, n_waiting=self.n_waiting,
            n_chunking=self.n_chunking,
            blocks_free=self.cache.allocator.n_free,
            finished=len(self._done_this_step),
            finished_ids=[f.req_id for f in self._done_this_step],
            tenants=tenants,
            # a replay still in flight has not completed: the step's last
            # completed work is its readback (the watchdog's clock)
            completed_at=self._t_fetch if self._pipe is not None else None)
        # a step that built an executable is warmup, not throughput: it
        # stays out of the sentinel's window (as out of the step gap)
        compiled = self.n_executables != self._n_exec_last
        self._n_exec_last = self.n_executables
        sen = self.obs.sentinel
        if sen is not None and not compiled and sen.record_step(
                kind=self._step_kind, duration_s=duration_s,
                tokens=self._tokens_this_step):
            # healthy -> degraded: attach the numbers that say why
            gap = self.obs.step_gap.snapshot()
            sen.diagnose({
                "step_gap_mean_ms": round(
                    gap["sum"] / gap["count"] * 1e3, 4) if gap["count"]
                else 0.0,
                "pipeline_flushes": self.obs.pipeline_flushes,
                "preemptions": self.obs.preemptions,
                "ttft_count": self.obs.ttft.count,
                "n_running": self.n_running,
                "n_waiting": self.n_waiting,
            })
        self._sample_hbm()

    def _price_static_pools(self) -> Dict[str, float]:
        """The pools that change only when an executable is built: the
        weights, the KV pool, and the decode graphs' static batch inputs
        (where the port keeps the device-resident batch); in ``extra``,
        the CUDA graph pool and the split scratch, which the allocator
        holds outside every attributed pool."""
        graphs = (list(self._decode_fns.values())
                  + list(self._fused_fns.values())
                  + ([self._fused_chunk] if self._fused_chunk else []))
        return {
            "weights": float(sum(p.nbytes for p in self.model.parameters())),
            "kv_pool": float(self.cache.pool_bytes),
            "resident": float(sum(
                sum(t.nbytes for t in g.inputs.values()) + g.uniforms.nbytes
                for g in graphs)),
            "graph_pool_bytes": float(self._graphs.bytes() or 0),
            "split_scratch_bytes": float(
                split_scratch_bytes(self.device) if self._cuda_mem else 0),
        }

    def _sample_hbm(self) -> None:
        """One HBM ledger tick (the reference's ``engine.py:1131-1200``):
        attribute device bytes to named pools and feed the drift detector
        the UNEXPLAINED share (KV bytes no live sequence holds, plus
        device bytes outside every pool). On the card the bytes in use and
        the peak are the caching allocator's host-side counters, read
        every tick; an exception from them propagates."""
        led = self.obs.hbm
        if led is None or self._step_count % self._hbm_every:
            return
        if (self._static_pools is None
                or self._static_pools["n_exec"] != self.n_executables):
            self._static_pools = dict(self._price_static_pools(),
                                      n_exec=self.n_executables)
        st = self._static_pools
        kv_used = self.cache.used_bytes
        kv_leaked = self.cache.leaked_bytes
        # the in-flight lookahead's outputs are its graph's static outputs,
        # inside the graph pool: no device bytes of its own
        pools = {"weights": st["weights"], "kv_pool": st["kv_pool"],
                 "resident": st["resident"], "inflight": 0.0}
        bytes_in_use = peak = None
        if self._cuda_mem:
            bytes_in_use = torch.cuda.memory_allocated(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
        drift = kv_leaked
        if bytes_in_use is not None:
            drift += max(0.0, float(bytes_in_use) - sum(pools.values()))
        led.sample(
            pools=pools,
            composition=(self.n_running, self.n_waiting, self.n_chunking),
            bytes_in_use=bytes_in_use, peak_bytes=peak,
            # no counterpart of the largest free block in torch's counters
            largest_free=None, drift_value=drift,
            extra={"kv_used_bytes": kv_used, "kv_leaked_bytes": kv_leaked,
                   "graph_pool_bytes": st["graph_pool_bytes"],
                   "split_scratch_bytes": st["split_scratch_bytes"]})

    def _step_sync(self) -> List[Finished]:
        """Lock-step step: marshal -> dispatch -> readback -> bookkeeping,
        one blocking device round trip per decode step."""
        self._step_count += 1
        self._done_this_step = []
        # expire BEFORE admission: a queued request past its deadline must
        # not be admitted into a prefill nobody waits for
        self._expire_deadlines()
        self._admit_phase()
        if any(s is not None for s in self.slots):
            self._decode_step()
        # a parked window never outlives its step (a chunk-only step: no
        # decode replay took it)
        self._flush_chunk()
        return self._done_this_step

    # -- async pipelined decode (SHAI_ASYNC_DECODE, the default) -----------

    def _step_async(self) -> List[Finished]:
        self._step_count += 1
        self._done_this_step = []
        now = time.monotonic()
        deadline_due = (
            any(0.0 < r.deadline_at <= now for r in self.waiting)
            or any(s is not None and 0.0 < s.req.deadline_at <= now
                   for s in self.slots))
        chunking = any(s is not None and s.prefill_cursor is not None
                       for s in self.slots)
        # the steady (pure-decode) path needs no host-side inputs at all;
        # admission work, a chunking slot or a due deadline makes an event
        # step
        if (self._pipe is not None and not self.waiting and not chunking
                and not deadline_due):
            self._steady_step()
        else:
            if self._pipe is not None:
                self._flush_pipeline("deadline" if deadline_due else
                                     "admission" if self.waiting
                                     else "chunking")
            self._expire_deadlines()
            self._admit_phase()
            if any(s is not None for s in self.slots):
                self._decode_dispatch()
            self._flush_chunk()  # a parked window never outlives its step
        return self._done_this_step

    def _steady_step(self) -> None:
        """Pipelined decode step: dispatch N+1 on device feedback, then
        retire step N and do its host bookkeeping while N+1 runs."""
        prev = self._pipe
        running = self._running_slots()
        if not running:
            # the previous commit finished every slot; retire the trailing
            # dispatch (its tokens are the discarded extra) and go idle
            self._flush_pipeline("drained")
            return
        if composition_sig(running,
                           self._batch_bucket(len(running))) != prev.sig:
            # a join or finish changed the compacted batch view: the device
            # feedback is packed for the OLD rows, so re-marshal
            self._flush_pipeline("recompose")
            self._decode_dispatch()
            return
        # price the whole step's growth before touching the allocator: the
        # steady path never recompute-preempts around an in-flight
        # lookahead; pool pressure falls back to the event path's ladder
        need = sum(self.cache.blocks_to_extend(s.req.req_id, 1)
                   for s in running)
        if need > self.cache.n_available:
            self._flush_pipeline("kv_pressure")
            self._decode_dispatch()
            return
        self._step_kind = "decode"
        for s in running:
            self.cache.extend(s.req.req_id, 1)
        Bb, graph = self._decode_for(self._max_ctx_blocks(running),
                                     len(running))
        self._note_dispatch_pad(running, Bb)
        self._res.refresh(self, running, Bb, graph)  # tables if grown
        # a bucket change lands on another graph: the feedback is copied
        # into its inputs on the device either way
        self._dispatch_async(graph, running, Bb, prev.nxt, prev.pos_next)
        t_f = self._retire_pipe(prev)
        # the dispatch beat the readback: the recorded inter-step gap is
        # (clamped) zero, the device went straight into step N+1
        self.obs.step_gap.observe(max(0.0, self._pipe.t_dispatch - t_f))
        self._commit_pending(running)

    def _decode_dispatch(self) -> None:
        """Event-path decode: host-marshaled dispatch (mirrors are current)
        with the readback DEFERRED to the next step, which re-establishes
        the pipeline in the same call that handled the event."""
        self._grow_running()
        running = self._running_slots()
        if not running:
            return  # chunk-only step: every live slot is mid-prefill
        self._step_kind = "decode"
        n_exec = self.n_executables
        Bb, graph = self._decode_for(self._max_ctx_blocks(running),
                                     len(running))
        self._note_dispatch_pad(running, Bb)
        self._res.refresh(self, running, Bb, graph)
        tokens, pos = self._marshal_tokens(running, Bb)
        self._dispatch_async(graph, running, Bb, tokens, pos,
                             gap_ok=self.n_executables == n_exec)
        self._commit_pending(running)

    def _dispatch_async(self, graph: DecodeGraph, running, Bb: int, tokens,
                        pos, gap_ok: bool = True) -> None:
        """Enqueue one feedback-decode replay and record it in flight.
        ``tokens``/``pos``: host arrays (event path) or the previous step's
        device outputs (steady path). ``gap_ok=False`` suppresses the
        step-gap observation (the caller built a new executable this step:
        warmup, not a dispatch gap)."""
        cold = self._pipe is None
        want_lp = any(s.req.params.logprobs for s in running)
        with torch.inference_mode():
            if isinstance(tokens, np.ndarray):
                upload(graph.inputs["tokens"], tokens)
                upload(graph.inputs["pos"], pos)
            else:
                graph.feed(tokens, pos)
            graph.draw(self._gen)
            self._load_window(graph)
            t_d = time.monotonic()
            with annotate("engine.decode"):
                graph.replay()
            host, lp_host, event = self._stage_tokens(graph, Bb, want_lp)
        if cold and gap_ok and self._t_fetch \
                and self._last_decode_step == self._step_count - 1:
            # flush or cold step: the dispatch had to wait for the
            # readback, and this gap is the serialization cost of the event
            self.obs.step_gap.observe(max(0.0, t_d - self._t_fetch))
        self._last_decode_step = self._step_count
        self._pipe = InflightStep(
            sig=composition_sig(running, Bb), running=list(running),
            nxt=graph.nxt, pos_next=graph.pos_next, host=host,
            lp_host=lp_host, event=event, t_dispatch=t_d)

    def _stage_tokens(self, graph: DecodeGraph, Bb: int, want_lp: bool):
        """Copy a dispatch's sampled tokens (and, when ``want_lp``, its
        logprob readout) into the next of the two sets of host buffers,
        without blocking: the next replay overwrites the graph's outputs.
        Returns the token buffer, the readout buffers (None unless
        ``want_lp``) and the event after the copies (None on the CPU)."""
        i, self._stage_i = self._stage_i, self._stage_i ^ 1
        event = self._stage_ev[i]
        host = self._stage[i][:Bb]
        host.copy_(graph.nxt, non_blocking=event is not None)
        lp_host = None
        if want_lp:
            lp_host = tuple(buf[:Bb] for buf in self._stage_lp[i])
            for buf, out in zip(lp_host, (graph.top_ids, graph.top_lp,
                                          graph.tok_lp)):
                buf.copy_(out, non_blocking=event is not None)
        if event is not None:
            event.record()
        return host, lp_host, event

    def _retire_pipe(self, pipe: InflightStep) -> float:
        """Host half of a dispatched step: fetch the sampled tokens (the
        only blocking device wait in the async loop, on this step's copy
        alone) and mirror them into ``pending_token``. Slots that finished
        or were cancelled since the dispatch are skipped: their extra token
        is exactly the discarded lookahead. Returns the fetch stamp."""
        nxt, top_ids, top_lp, tok_lp = pipe.fetch()
        t_f = time.monotonic()
        self._t_fetch = t_f
        self._apply_sampled(pipe.running, nxt, top_ids, top_lp, tok_lp)
        return t_f

    def _flush_pipeline(self, reason: str) -> None:
        """Retire the in-flight lookahead (a no-op when none): the explicit
        pipeline flush every composition or control-flow event pays,
        counted per reason."""
        pipe, self._pipe = self._pipe, None
        if pipe is None:
            return
        self._retire_pipe(pipe)
        self.obs.count_flush(reason)

    def finish_pending(self) -> None:
        """Retire any in-flight lookahead step: the engine loop calls this
        when the engine goes idle, so host mirrors do not sit one step
        stale across an idle gap."""
        self._flush_pipeline("idle")
        # idle breaks step-gap continuity: the step counter does not tick
        # while the loop waits for work, so the first dispatch of the next
        # burst must not book the idle wall time as a dispatch gap
        self._last_decode_step = -2

    def _admit_phase(self) -> None:
        """One continuation chunk, then admission. Short prompts are
        admitted while a long one chunks; only a second long prompt waits
        for the active chunker."""
        chunking = [s for s in self.slots
                    if s is not None and s.prefill_cursor is not None]
        if chunking:
            self._continue_prefill(chunking[0])
        # class-aware dequeue BEFORE the ladder branches on the head: the
        # branch taken must be the one for the request fairness selected
        # (a no-op with SHAI_QOS off or a single-class queue)
        if self._sched is not None:
            _qos.schedule_rotate(self.waiting, self._sched)
        if (self._kv_cow and self.waiting
                and self.waiting[0].parent_rid >= 0
                and self._admit_fanout()):
            pass                    # CoW fan-out: one prefill, K forks
        elif (self.waiting
                and len(self.waiting[0].prompt_ids) > self.buckets.max):
            if not chunking:
                self._admit_long()
        else:
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
        self._prune_fanout(fin.req_id)
        if self.obs.slo is not None:
            self.obs.slo.record_outcome(fin.stop_reason)

    def _mark_first_token(self, req: Request) -> float:
        """TTFT record point (first admission only — a preemption resume is
        not a new first token); returns the timestamp for TPOT."""
        now = time.monotonic()
        if not req.already_generated and req.t_submit:
            ttft = now - req.t_submit
            self.ttft.record(ttft)
            self.obs.ttft.observe(ttft)
            if self._tenant_seen:
                self.obs.note_tenant_ttft(req.tenant, ttft)
            if self.obs.slo is not None:
                self.obs.slo.record_ttft(ttft)
        if not req.t_first:
            req.t_first = now
        return now

    def _record_tpot(self, s: _Running) -> None:
        """Per-token decode pace: elapsed from token 1's sample to token
        n's commit spans n decode steps."""
        if s.t_first and s.generated:
            tpot = (time.monotonic() - s.t_first) / len(s.generated)
            self.tpot.record(tpot)
            self.obs.tpot.observe(tpot)
            if self.obs.slo is not None:
                self.obs.slo.record_tpot(tpot)

    def _note_admitted(self, req: Request) -> None:
        """Queue-wait record point at the first admission only (a
        preemption resume keeps its original ``t_admit``)."""
        if not req.t_admit:
            req.t_admit = time.monotonic()
            if req.t_submit:
                self.obs.queue_wait.observe(req.t_admit - req.t_submit)

    def _timing_of(self, req: Request, t_first: float = 0.0
                   ) -> Dict[str, float]:
        """Per-phase timeline of a Finished (the reference's
        ``_timing_of``): monotonic stamps and the queue, prefill and decode
        durations. A missing stamp falls forward to now, collapsing the
        phases that never ran to zero."""
        now = time.monotonic()
        t_sub = req.t_submit or now
        t_adm = min(req.t_admit or now, now)
        # the request's own stamp first: a preemption resume's slot
        # t_first is the resumed segment's
        t_f = min(req.t_first or t_first or now, now)
        t_adm = max(t_sub, t_adm)
        t_f = max(t_adm, t_f)
        out = {
            "t_submit": t_sub, "t_admit": t_adm, "t_first": t_f,
            "t_done": now,
            "queue_s": round(max(0.0, t_adm - t_sub), 6),
            "prefill_s": round(max(0.0, t_f - t_adm), 6),
            "decode_s": round(max(0.0, now - t_f), 6),
            "total_s": round(max(0.0, now - t_sub), 6),
        }
        if req.obs_extra:
            out.update(req.obs_extra)
        return out

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
        need = self._need_blocks(n_tokens)
        # chaos site: an injected reservation failure reads as a dry pool,
        # taking exactly the wait-or-reject ladder a real one takes
        available = (-1 if _faults.get().should_fail(_faults.KV_RESERVE)
                     else self.cache.n_available)
        if need <= available:
            return True
        if not any(s is not None for s in self.slots):
            self.waiting.popleft()
            log.error("rejecting req %d: needs %d blocks, pool max %d",
                      req.req_id, need, self.cache.allocator.n_free)
            self._finish(Finished(req.req_id, list(req.already_generated),
                                  req.orig_n_prompt, "rejected",
                                  logprobs=self._queued_lps(req),
                                  timing=self._timing_of(req)))
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
                break  # a long prompt: _admit_long takes it at the head
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
            self._note_admitted(req)
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
        with torch.inference_mode(), annotate("engine.prefill"):
            _, logits = fn(self.model, self.cache.kv,
                           torch.from_numpy(ids).to(dev),
                           torch.from_numpy(n_text).to(dev),
                           torch.from_numpy(tables).to(dev))
            toks = sample_logits(logits, self._gen,
                                 torch.from_numpy(temp).to(dev),
                                 torch.from_numpy(topk).to(dev),
                                 torch.from_numpy(topp).to(dev)).cpu()
        real = sum(len(r.prompt_ids) for r in group)
        self.obs.count_pad(real, Kp * bucket - real, phase="prefill")
        lp_rows = []
        for i, req in enumerate(group):
            slot = self._free_slot()
            self._start_slot(slot, req, int(toks[i]))
            if req.params.logprobs:
                lp_rows.append((i, self.slots[slot]))
        if lp_rows:
            _record_admission_lps(self, logits, [int(t) for t in toks],
                                  lp_rows)

    def _admit_fanout(self) -> bool:
        """Admit an ``n > 1`` fan-out group (``SHAI_KV_COW``) as ONE
        prefill: the leader's prompt prefills once, each sibling forks its
        blocks copy-on-write, and the K rows sample their first token from
        the one logits row tiled to the ``Kp`` batch layout, drawing
        ``[Kp, V]`` uniforms as a ``Kp``-row batched admission of K
        identical prompts does. All or nothing: returns False with nothing
        consumed when the group is not queued whole at the head, its
        prompts differ (a preempted sibling carries generated tokens), its
        prompt would chunk, or its slots or blocks (one prompt's blocks
        plus a copy block per member) are not free; the members then admit
        on their own."""
        head = self.waiting[0]
        parent = self._rid_parent.get(head.req_id)
        if parent is None:
            return False
        group = [r for r in self.waiting
                 if self._rid_parent.get(r.req_id) == parent]
        if len(group) < 2 or group[0] is not head:
            return False
        n = len(head.prompt_ids)
        if n > self.buckets.max:
            return False
        if any(r.prompt_ids != head.prompt_ids or r.already_generated
               for r in group):
            return False
        K = len(group)
        if sum(s is None for s in self.slots) < K:
            return False
        if self._need_blocks(n) + K > self.cache.n_available:
            return False
        bucket = self.buckets.bucket_for(n)
        if self._warmed and (bucket, 1) not in self._prefill:
            return False  # a build after readiness is the cold-graph bug
        alloc = self.cache.admit(head.req_id, n)
        # past the all-or-nothing point: dequeue the whole group, by
        # identity (the fair dequeue may have interleaved other requests)
        members = {id(r) for r in group}
        kept = [r for r in self.waiting if id(r) not in members]
        self.waiting.clear()
        self.waiting.extend(kept)
        for r in group:
            self._note_admitted(r)
        for r in group[1:]:
            self.cache.fork_sequence(head.req_id, r.req_id)
        Kp = 1 << (K - 1).bit_length()
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :n] = head.prompt_ids
        temp = np.ones((Kp,), np.float32)
        topk = np.zeros((Kp,), np.int32)
        topp = np.ones((Kp,), np.float32)
        for i, r in enumerate(group):
            temp[i] = r.params.temperature
            topk[i] = r.params.top_k
            topp[i] = r.params.top_p
        dev = self.device
        fn = self._prefill_for(bucket, 1)
        with torch.inference_mode(), annotate("engine.prefill"):
            _, logits = fn(
                self.model, self.cache.kv, torch.from_numpy(ids).to(dev),
                torch.tensor([n], dtype=torch.int32, device=dev),
                self._table_of(head))
            self.cache.register_prefix(head.prompt_ids, alloc.blocks)
            tiled = logits[:1].expand(Kp, -1).contiguous()
            toks = sample_logits(tiled, self._gen,
                                 torch.from_numpy(temp).to(dev),
                                 torch.from_numpy(topk).to(dev),
                                 torch.from_numpy(topp).to(dev)).cpu()
        self.obs.count_pad(n, bucket - n, phase="prefill")
        lp_rows = []
        for i, r in enumerate(group):
            slot = self._free_slot()
            self._start_slot(slot, r, int(toks[i]))
            if r.params.logprobs:
                lp_rows.append((i, self.slots[slot]))
        if lp_rows:
            _record_admission_lps(self, tiled, [int(t) for t in toks],
                                  lp_rows)
        return True

    def _admit_long(self) -> None:
        """Admit a prompt longer than the largest prefill bucket: allocate
        its whole block run, encode the first chunk now, and leave a cursor
        for :meth:`_continue_prefill` to advance one chunk per step."""
        if not self.waiting:
            return
        slot = self._free_slot()
        if slot is None:
            return
        req = self.waiting[0]
        if len(req.prompt_ids) > self._chunk_cap:
            # a preemption resume (prompt + generated) may pass the cap:
            # keep the tail, as add_request does
            req.prompt_ids = req.prompt_ids[-self._chunk_cap:]
        n_total = len(req.prompt_ids)
        C = self.buckets.max
        if n_total <= C:
            self._admit_batch()  # the cut brought it back inside a bucket
            return
        if not self._try_reserve(req, n_total):
            return
        self.waiting.popleft()
        self._note_admitted(req)
        self.cache.admit(req.req_id, n_total)
        dev = self.device
        ids = torch.tensor([req.prompt_ids[:C]], dtype=torch.int32,
                           device=dev)
        fn = self._prefill_for(C, 1)
        with torch.inference_mode(), annotate("engine.prefill"):
            fn(self.model, self.cache.kv, ids,
               torch.tensor([C], dtype=torch.int32, device=dev),
               self._table_of(req))
        self.slots[slot] = _Running(req, slot, [], pending_token=-1,
                                    prefill_cursor=C)

    def _continue_prefill(self, s: _Running) -> None:
        """Encode the next chunk of a mid-prefill slot; on the final chunk,
        sample the first token and join the decode batch."""
        req = s.req
        start = s.prefill_cursor
        C = self.buckets.max
        chunk = req.prompt_ids[start:start + C]
        n = len(chunk)
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = chunk
        final = start + n >= len(req.prompt_ids)
        dev = self.device
        if self._fused:
            window = (ids, n, self.cache.seq(req.req_id).table(
                self.ecfg.blocks_per_seq)[None], start)
            self._flush_chunk()  # never two windows parked
            if not final:
                # an intermediate chunk rides this step's decode replay;
                # its logits are dropped, as the laddered path drops them
                self._pending_chunk = window
                self.obs.count_pad(n, C - n, phase="chunk")
                s.prefill_cursor = start + C
                return
        with torch.inference_mode():
            if self._fused:
                # the final chunk's token joins THIS step's decode batch,
                # so it cannot ride that replay: chunk-only
                logits = self._fused_chunk_call(window)
            else:
                fn = self._cont_for(start // self.ecfg.block_size)
                with annotate("engine.prefill"):
                    _, logits = fn(self.model, self.cache.kv,
                                   torch.from_numpy(ids).to(dev),
                                   torch.tensor([n], dtype=torch.int32,
                                                device=dev),
                                   self._table_of(req),
                                   *self._cont_args(start))
            if final:
                p = req.params
                tok = sample_logits(logits, self._gen, p.temperature,
                                    p.top_k, p.top_p)
        self.obs.count_pad(n, C - n, phase="chunk")
        if final:
            s.pending_token = int(tok[0])
            s.prefill_cursor = None
            s.t_first = self._mark_first_token(req)
            if req.params.logprobs:
                _record_admission_lps(self, logits, [s.pending_token],
                                      [(0, s)])
        else:
            s.prefill_cursor = start + C

    def _table_of(self, req: Request) -> torch.Tensor:
        """``[1, blocks_per_seq]`` block table of an admitted request."""
        t = self.cache.seq(req.req_id).table(self.ecfg.blocks_per_seq)
        return torch.from_numpy(t[None]).to(self.device)

    def _cont_for(self, start_blocks: int):
        """The continuation function for a chunk at ``start_blocks``: one
        per start on the static ladder, one per chunk bucket when ragged."""
        bucket = self.buckets.max
        key = self._cont_key(start_blocks, bucket)
        if key not in self._prefill:
            # chaos site: executable-factory compile failure
            _faults.get().raise_at(_faults.COMPILE)
            if self._warmed:
                # a build after warmup: a shape escaped the closed set
                self.obs.count_recompile("prefill_cont")
            self._prefill[key] = make_prefill_cont(
                self.cfg, self.ecfg.block_size, self.ecfg.blocks_per_seq,
                bucket, 0 if self._ragged else start_blocks,
                kv_quant=self._kv_quant, ragged=self._ragged)
        return self._prefill[key]

    def _cont_key(self, start_blocks: int, bucket: int) -> tuple:
        if self._ragged:
            return ("rcont", bucket)
        return ("cont", start_blocks, bucket)

    def _cont_args(self, start: int) -> list:
        """Trailing arguments of a continuation call beyond ``(model, kv,
        ids, n_text, block_tables)``: the ragged variant takes the start as
        data."""
        if self._ragged:
            return [torch.tensor([start], dtype=torch.int32,
                                 device=self.device)]
        return []

    def _prefill_for(self, bucket: int, n_seqs: int = 1):
        key = (bucket, n_seqs)
        if key not in self._prefill:
            # chaos site: executable-factory compile failure
            _faults.get().raise_at(_faults.COMPILE)
            if self._warmed:
                self.obs.count_recompile("prefill")
            self._prefill[key] = make_prefill(
                self.cfg, self.ecfg.block_size, self.ecfg.blocks_per_seq,
                bucket, n_seqs=n_seqs, kv_quant=self._kv_quant)
        return self._prefill[key]

    def _batch_bucket(self, n_active: int) -> int:
        """Smallest power-of-two batch covering ``n_active``."""
        b = 1
        while b < n_active:
            b *= 2
        return min(b, self.ecfg.max_num_seqs)

    def _batch_buckets(self) -> List[int]:
        """Every batch bucket a decode dispatch can take: the powers of two
        below ``max_num_seqs``, and ``max_num_seqs``."""
        out, bb = [], 1
        while bb < self.ecfg.max_num_seqs:
            out.append(bb)
            bb *= 2
        return out + [self.ecfg.max_num_seqs]

    def _scratch_needs(self) -> List[Tuple[int, int]]:
        """The split scratch each decode key of the closed set takes on
        the card (B2 and B3 read the bucket's first ``m`` table entries);
        under the fused step, each fused key's mixed-row launch (its decode
        rows split, the chunk's group not)."""
        if self.device.type != "cuda":
            return []
        cfg, n_sms = self.cfg, sm_count(self.device.index)
        if self._fused:
            return [groups_scratch_size(
                mixed_phase_groups(bb, self.buckets.max), cfg.n_heads,
                cfg.n_kv_heads, cfg.head_dim, self.ecfg.block_size,
                self.ecfg.blocks_per_seq, n_sms)
                for bb in self._batch_buckets()]
        return [split_scratch_size(bb, 1, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, self.ecfg.block_size, m,
                                   n_sms)
                for m in self._ctx_buckets for bb in self._batch_buckets()]

    def _decode_for(self, m_blocks: int, n_active: int = -1):
        """Decode graph for the smallest (context, batch) buckets covering
        the running set, captured when its key is first built; under the
        fused step, the fused graph of the batch bucket (the window rides
        it, loaded by ``_load_window`` before each replay)."""
        if self._fused:
            return self._fused_for(n_active)
        m = next(b for b in self._ctx_buckets if b >= m_blocks)
        bb = (self.ecfg.max_num_seqs if n_active < 0
              else self._batch_bucket(n_active))
        key = (m, bb)
        if key not in self._decode_fns:
            # chaos site: fires before the function is built, so before
            # its eager call and before the capture opens (a raise inside
            # a capture would leave the stream capturing)
            _faults.get().raise_at(_faults.COMPILE)
            if self._warmed:
                self.obs.count_recompile("decode")
            # the feedback variant serves both disciplines: lock-step fills
            # tokens and positions from the host, async feeds them back
            graph = DecodeGraph(
                key, make_decode(self.cfg, self.ecfg.block_size,
                                 self.ecfg.blocks_per_seq, bb, ctx_blocks=m,
                                 ragged=self._ragged, kv_quant=self._kv_quant,
                                 feedback=True),
                self.model, self.cache.kv, bb, self.ecfg.blocks_per_seq,
                self.cfg.vocab_size, device=self.device, pool=self._graphs)
            graph.capture()
            self._decode_fns[key] = graph
        return bb, self._decode_fns[key]

    # -- fused mixed-phase step (SHAI_FUSED_STEP) --------------------------

    def _fused_graph(self, key, bb: int) -> DecodeGraph:
        # chaos site, before the function is built and the capture opens
        _faults.get().raise_at(_faults.COMPILE)
        if self._warmed:
            self.obs.count_recompile("fused")
        graph = DecodeGraph(
            key, make_fused_step(self.cfg, self.ecfg.block_size,
                                 self.ecfg.blocks_per_seq, bb,
                                 self.buckets.max, kv_quant=self._kv_quant),
            self.model, self.cache.kv, bb, self.ecfg.blocks_per_seq,
            self.cfg.vocab_size, device=self.device, pool=self._graphs,
            chunk=self.buckets.max)
        graph.capture()
        return graph

    def _fused_for(self, n_active: int = -1):
        """The fused graph for the smallest batch bucket covering the
        running set (the reference's ``_fused_for`` and
        ``_fused_decode_for``): the decode rows plus one chunk window, ONE
        replay. One entry per batch bucket: ragged has no context ladder,
        and the window is pinned to the largest prefill bucket."""
        bb = (self.ecfg.max_num_seqs if n_active < 0
              else self._batch_bucket(n_active))
        if bb not in self._fused_fns:
            self._fused_fns[bb] = self._fused_graph(bb, bb)
        return bb, self._fused_fns[bb]

    def _chunk_graph(self) -> DecodeGraph:
        """The chunk-only graph: the bb=1 fused step captured once more,
        its decode row left null (zero table: its write lands in reserved
        block 0) and never drawn for, so a chunk-only call leaves the
        engine's draws and every decode graph's inputs and outputs as they
        were."""
        if self._fused_chunk is None:
            self._fused_chunk = self._fused_graph(("chunk", 1), 1)
        return self._fused_chunk

    def _take_chunk_args(self):
        """Consume the parked window (None: the null window)."""
        window, self._pending_chunk = self._pending_chunk, None
        return window

    def _load_window(self, graph: DecodeGraph) -> None:
        """Before a decode replay: a fused graph takes the parked window,
        or the null one (the reference's ``_null_chunk_args``: a graph's
        static inputs hold it until a window is loaded)."""
        if self._fused:
            graph.load_window(self._take_chunk_args())

    def _fused_chunk_call(self, window) -> torch.Tensor:
        """Chunk-only replay: ``window`` through the chunk-only graph, its
        decode row null. For final chunks, whose token joins the same
        step's decode batch, and for parked windows no replay took.
        Returns the chunk's raw logits ``[1, V]`` (the graph's static
        output, valid until its next replay)."""
        graph = self._chunk_graph()
        with torch.inference_mode():
            graph.load_window(window)
            with annotate("engine.prefill"):
                graph.replay()
        return graph.c_logits

    def _flush_chunk(self) -> None:
        """Dispatch the parked window now (a no-op when none): every path
        that skips the decode replay or reorders KV writes around it."""
        if self._pending_chunk is not None:
            self._fused_chunk_call(self._take_chunk_args())

    def _preempt_lowest(self) -> None:
        """Recompute-preempt the lowest-priority, most recently admitted
        sequence: its generated + pending tokens become prompt suffix on
        re-admission. Priority weighs in ONLY under ``SHAI_QOS``: with QoS
        off the key is the most recent ``req_id`` alone, so an
        unauthenticated ``X-SHAI-Priority`` header is no anti-preemption
        lever on a FIFO pod."""
        # the victim's pending token is streamed and committed below, so
        # the host mirrors must be current; a parked window writes before
        # its blocks can be released (the laddered order)
        self._flush_pipeline("preempt")
        self._flush_chunk()
        victims = [s for s in self.slots if s is not None]
        if self._sched is not None:
            victim = max(victims,
                         key=lambda s: (s.req.priority, s.req.req_id))
        else:
            victim = max(victims, key=lambda s: s.req.req_id)
        log.warning("preempting seq %d (block pool exhausted)",
                    victim.req.req_id)
        self.obs.count_preemption()
        self._release_slot(victim)
        if victim.prefill_cursor is not None:
            # mid-prefill: nothing generated; the prompt re-queues as it is
            # and re-chunks from the start
            self.waiting.appendleft(victim.req)
            return
        committed = victim.generated + [victim.pending_token]
        p = victim.req.params
        if victim.req.on_token is not None and victim.pending_token != p.eos_id:
            # the pending token WILL be in the final output (as prompt
            # suffix): stream it now, exactly once per output token
            victim.req.on_token(victim.pending_token)
        emitted = victim.req.already_generated + committed
        if victim.pending_token == p.eos_id or len(committed) >= p.max_new_tokens:
            self._record_tpot(victim)
            lps = (victim.req.already_lp + victim.lps) if p.logprobs else None
            if emitted and emitted[-1] == p.eos_id:
                emitted = emitted[:-1]
                if lps:
                    lps = lps[:-1]
                reason = "eos"
            else:
                reason = "length"
            self._finish(Finished(victim.req.req_id, emitted,
                                  victim.req.orig_n_prompt, reason,
                                  logprobs=lps,
                                  timing=self._timing_of(victim.req,
                                                         victim.t_first)))
            return
        self._record_tpot(victim)
        params = dataclasses.replace(
            p, max_new_tokens=p.max_new_tokens - len(committed))
        self.waiting.appendleft(Request(
            victim.req.req_id, victim.req.prompt_ids + committed, params,
            already_generated=emitted,
            orig_n_prompt=victim.req.orig_n_prompt,
            on_token=victim.req.on_token,
            deadline_at=victim.req.deadline_at,
            t_submit=victim.req.t_submit, t_admit=victim.req.t_admit,
            t_first=victim.req.t_first,
            # the reference re-queues without the QoS tag (the resumed
            # request is normal priority, untagged); kept, so that the two
            # engines schedule a preempted queue alike
            already_lp=(victim.req.already_lp + victim.lps
                        if p.logprobs else [])))

    def _grow_running(self) -> None:
        """Reserve one cache token per decoding slot for its pending token,
        recompute-preempting on pool exhaustion (never down to zero running
        sequences)."""
        for s in list(self.slots):
            if s is None or s.prefill_cursor is not None:
                continue  # mid-prefill slots neither grow nor decode yet
            if self.slots[s.slot] is not s:
                continue  # preempted by an earlier iteration
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

    def _note_dispatch_pad(self, running, Bb: int) -> None:
        """Pad-waste accounting for one decode dispatch: ``real`` is the
        context tokens the rows hold, the pad the slots the call walks
        beyond them (batch pad rows, and the context window past each
        row's live tokens: the bucket for every row, or each row's own
        blocks when ragged)."""
        bs = self.ecfg.block_size
        real = walked = 0
        if self._ragged:
            for s in running:
                n = self.cache.seq(s.req.req_id).n_tokens
                real += n
                walked += self.cache._blocks_needed(n) * bs
            walked += (Bb - len(running)) * bs  # pad rows walk one block
        else:
            m_blocks = 1
            for s in running:
                n = self.cache.seq(s.req.req_id).n_tokens
                real += n
                m_blocks = max(m_blocks, self.cache._blocks_needed(n))
            m = next(b for b in self._ctx_buckets if b >= m_blocks)
            walked = Bb * m * bs
        self.obs.count_pad(real, walked - real, phase="decode")

    def _running_slots(self) -> List[_Running]:
        return [s for s in self.slots
                if s is not None and s.prefill_cursor is None]

    def _max_ctx_blocks(self, running) -> int:
        m_blocks = 1
        for s in running:
            m_blocks = max(m_blocks, self.cache._blocks_needed(
                self.cache.seq(s.req.req_id).n_tokens))
        return m_blocks

    def _marshal_running(self, running, Bb: int) -> Dict[str, np.ndarray]:
        """Compact the active slots into the first ``len(running)`` batch
        rows (the pool is slot-agnostic: block tables are data); padding
        rows carry null tables and write harmlessly into reserved block 0.
        The text columns of the reference's marshal; callers add their own
        token and position arrays."""
        M = self.ecfg.blocks_per_seq
        a = {"tables": np.zeros((Bb, M), np.int32),
             "temp": np.ones((Bb,), np.float32),
             "topk": np.zeros((Bb,), np.int32),
             "topp": np.ones((Bb,), np.float32)}
        for i, s in enumerate(running):
            a["tables"][i] = self.cache.seq(s.req.req_id).table(M)
            a["temp"][i] = s.req.params.temperature
            a["topk"][i] = s.req.params.top_k
            a["topp"][i] = s.req.params.top_p
        return a

    def _marshal_tokens(self, running, Bb: int):
        """Host ``(tokens, pos)`` of a dispatch: each row's pending token
        and the cache index it is written at."""
        tokens = np.zeros((Bb,), np.int32)
        pos = np.zeros((Bb,), np.int32)
        for i, s in enumerate(running):
            tokens[i] = s.pending_token
            pos[i] = self.cache.seq(s.req.req_id).n_tokens - 1
        return tokens, pos

    def _decode_step(self) -> None:
        """Lock-step decode: grow, marshal everything from the host, replay
        and read the tokens back before the bookkeeping."""
        self._grow_running()
        running = self._running_slots()
        if not running:
            return
        self._step_kind = "decode"
        n_exec = self.n_executables
        Bb, graph = self._decode_for(self._max_ctx_blocks(running),
                                     len(running))
        self._note_dispatch_pad(running, Bb)
        a = self._marshal_running(running, Bb)
        tokens, pos = self._marshal_tokens(running, Bb)
        with torch.inference_mode():
            for name in RESIDENT:
                upload(graph.inputs[name], a[name])
            upload(graph.inputs["tokens"], tokens)
            upload(graph.inputs["pos"], pos)
            graph.draw(self._gen)
            self._load_window(graph)
            t_d = time.monotonic()
            with annotate("engine.decode"):
                graph.replay()
            if self._t_fetch and self.n_executables == n_exec \
                    and self._last_decode_step == self._step_count - 1:
                # the lock-step inter-step gap: the host work (marshal,
                # bookkeeping) the device idled behind between two
                # dispatches (a first-use build is warmup, not a gap)
                self.obs.step_gap.observe(max(0.0, t_d - self._t_fetch))
            self._last_decode_step = self._step_count
            nxt = graph.nxt.cpu().numpy()
            lp = (None, None, None)
            if any(s.req.params.logprobs for s in running):
                lp = tuple(t.cpu().numpy() for t in (
                    graph.top_ids, graph.top_lp, graph.tok_lp))
        self._t_fetch = time.monotonic()
        self._commit_pending(running)
        self._apply_sampled(running, nxt, *lp)

    def _commit_pending(self, running) -> None:
        """Commit every running slot's pending token: append/stream it, run
        the EOS/length ladder, and finish + release what's done."""
        for s in running:
            if self.slots[s.slot] is not s:
                continue
            s.generated.append(s.pending_token)
            self._tokens_this_step += 1  # the perf sentinel's feed
            p = s.req.params
            hit_eos = s.pending_token == p.eos_id
            if hit_eos:
                s.generated.pop()  # exclude EOS from the emitted text
                if p.logprobs and s.lps:
                    s.lps.pop()    # its logprob entry goes with it
            elif s.req.on_token is not None:
                s.req.on_token(s.pending_token)
            full = len(s.generated) >= p.max_new_tokens
            total = self.cache.seq(s.req.req_id).n_tokens
            out_of_len = total >= self.ecfg.max_model_len
            if hit_eos or full or out_of_len:
                self._record_tpot(s)
                self._finish(Finished(
                    s.req.req_id, s.req.already_generated + s.generated,
                    s.req.orig_n_prompt, "eos" if hit_eos else "length",
                    logprobs=((s.req.already_lp + s.lps)
                              if p.logprobs else None),
                    timing=self._timing_of(s.req, s.t_first)))
                self._release_slot(s)

    def _apply_sampled(self, running, nxt, top_ids, top_lp, tok_lp) -> None:
        """Mirror a decode step's sampled tokens into the surviving slots'
        ``pending_token``, with a logprob entry for each slot that asked.
        In the async path this runs one step late; a slot finished or
        cancelled since the dispatch is skipped, its token and its entry
        dropped."""
        for i, s in enumerate(running):
            if self.slots[s.slot] is not s:
                continue
            s.pending_token = int(nxt[i])
            p = s.req.params
            if p.logprobs:
                s.lps.append(_lp_entry(p.logprobs, nxt[i], tok_lp[i],
                                       top_ids[i], top_lp[i]))
