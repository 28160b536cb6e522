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
``generate``, and the boot HBM gate (``:79-92``: ``core.budget.
causal_lm_budget(...).check()`` before any allocation, on the card or
under ``SHAI_ENFORCE_HBM=1``); ``warm_executables`` lives in
``engine/warm.py``, the logprob entries in ``engine/logprobs.py``.

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

The prefix cache (``enable_prefix_caching``) and the host KV tier
(``SHAI_KVTIER``, the reference's ``engine.py:128-175``): every admission
path registers its prompt's full blocks (``cache.register_prefix``), and
the admission ladder has a cached rung (``_admit_cached``, ``:1547``): the
head request's leading full blocks found in the device cache, extended by
the host tier's run (restored in place into the pool, after a ``kvtier``
pipeline flush), give a warm start from the closed set
(``_cached_starts``: every prefill bucket and every multiple of the
largest), and ONE continuation over the uncached remainder
(``("cont", start, chunk_bucket)`` through B1, ``("rcont",
chunk_bucket)`` through B3, or the chunk-only fused graph) admits it.
``_cont_cold`` refuses a key outside the warmed set after warmup; an int8
pool under the fused step falls through to plain admission. A preemption
victim's full blocks are published to the cache (``offload_preempt``),
so pool pressure demotes them. The role (``SHAI_ROLE`` over
``EngineConfig.role``): a ``prefill`` engine banks each finished prompt's
full-block run in the tier before release (``demote_prompt_run``), for a
decode pod to pull over ``GET /kv/blocks``.

The fleet KV fabric and live migration (the reference's
``engine.py:332-351,455-470,507-676,1511-1589``): with
``SHAI_KVFABRIC``/``SHAI_KVFABRIC_PEERS`` armed and a tier attached, the
cached rung gains a third step (``_fabric_probe``): when neither the
device cache nor the tier offers a warm start, the head request's run is
pulled from a fleet holder (the request's ``kv_holders``, else the
pod-local directory) into the tier, and the ordinary tier restore admits
it; with the fabric off the ladder is unchanged. ``snapshot_sequence``
banks a request's full-block run (prompt and generated, or the chunks
encoded so far) in the tier and describes its resumable state as a
manifest; ``migrate_out`` flushes the pipeline (reason ``migrate``) and a
parked window, streams the pending token once, and finishes the request
as ``"migrated"`` with the manifest attached (or as ``eos``/``length``
when the pending token ends it). ``add_request`` takes a resumed
request's ``already_generated``, ``already_lp`` and ``orig_n_prompt``
(the preemption-resume semantics) and its ``kv_holders``.

Speculative decoding (``speculative_model: "[ngram]"`` with
``num_speculative_tokens`` k, the reference's ``engine.py:200-216,
2120-2140,2239-2295,2346-2490``): a host-side prompt-lookup drafter
(``engine/speculative.py``) proposes up to k tokens per running slot, and
one verify graph per (context bucket, batch bucket) key scores the
pending token and the draft at ``k + 1`` rows per sequence
(``runner.make_verify``) in the slot batch's resident view. The host walks
the acceptance (``accept_drafts``, its rejection uniforms from a stream of
its own seeded ``seed + 0x5EC``), commits the agreed prefix and the
correction or bonus token, and gives the rejected reservation back
(``cache.shrink``). A step where no slot drafted replays the decode graph.
Every step is an event step while a drafter is set (the ``spec`` flush),
and the fused step stays off.

mllama (the reference's ``cross_seq_len`` engine, ``engine.py:69-131,
249-274,388-417,856,1006-1008,1154-1167,1368,1485-1487``): a model with
cross-attention layers takes ``cross_seq_len`` (Lv, the vision states of a
full image) and owns per-slot cross-KV buffers ``[max_num_seqs, Lv, Hkv,
Dh]`` per cross layer, written in place at admission (``engine/cross.py``)
and read by every prefill, continuation chunk, decode and verify graph.
The KV pool is sized over the self-attention layers alone. A request's
``cross_states [Lv, dim]`` and ``cross_len`` (its valid states) are
projected once when it is admitted, alone (``_admit_one``) or as the head
of a chunked prompt; text-only rows gate the cross layers off
(``has_image`` 0) and attend ``Lv`` zero keys. Ragged attention, the fused
step and the prefix cache stay off on such an engine, as the reference's
do; speculative decoding runs through verify's cross tail. A multimodal
request is not migrated (``migrate_out`` returns None).

Tensor parallelism (the reference's ``mesh``, ``engine.py:93-99``; the
port runs one process a rank): ``LLMEngine(..., group=g)`` is one rank of
a ``parallel.distributed.DistGroup`` of ``tensor_parallel_size`` ranks,
over that rank's model (``models.llama``'s rank-local modules on its
shard). It builds ``EngineShardings`` (an indivisible head count raises
here), a pool of the rank's kv heads, and the runner's functions, which
call the model's collectives. The decode, verify and fused keys are
captured with their collectives inside over a capturable group (NCCL), and
run eagerly over gloo. As in the reference a sharded pool keeps the host
KV tier off (a prefill role then warns that its handoffs carry no KV),
and the engine migrates nothing; mllama under a group is refused
(A7.2b). Every rank runs the whole engine, scheduler included; rank 0's
takes the requests and ``engine.ranks.StepMirror`` (``mirror``) sends its
calls to the other ranks before they run, with rank 0's clock for each
step's deadlines.

The soft-prefix VLM (LLaVA; the reference's ``:416-432,843-844,
1339-1384``): ``add_request(prefix=[P, dim])`` caps the text at the
largest bucket less P (the tail kept), and the step ladder admits such a
request alone, first, through ``_admit_one``: one prefill keyed
``("prefix", bucket, P)`` with the prefix in the first P positions, its
first token sampled from that prefill's logits. Its blocks are never
registered in the prefix cache or demoted to the host tier (preemption
re-queues the prefix with the prompt and its output so far), the batch
admission and the copy-on-write fan-out stop at it, and it decodes in the
ordinary batch: the cache holds ``P +`` its tokens, so its positions come
from the cache as every row's do.
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
from ..core.budget import HbmBudget, causal_lm_budget, detect_hbm_gib
from ..core.device import DeviceLike, resolve_device
from ..kvnet import directory as _kvdir
from ..kvnet import resolve_role
from ..kvnet.client import KvNetStats
from ..kvnet.migrate import MigrateStats
from ..kvtier.pool import maybe_host_tier
from ..models.llama import (
    MLLAMA_RANKS,
    LlamaConfig,
    LlamaForCausalLM,
    group_size,
)
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
from . import cross as _cross_mod
from .config import EngineConfig
from .graphs import DecodeGraph, GraphPool
from .logprobs import _lp_entry, _record_admission_lps
from .resident import (
    InflightStep,
    ResidentBatch,
    composition_sig,
    upload,
)
from .runner import (
    EngineShardings,
    make_cross_kv,
    make_cross_slot_write,
    make_decode,
    make_fused_step,
    make_prefill,
    make_prefill_cont,
    make_verify,
)
from .speculative import PromptLookupDrafter, SpecStats, accept_drafts
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


#: the reference's warning when a prefill-role engine has no host tier
#: to bank its handoffs in (a tensor-parallel engine never has one)
NO_TIER_PREFILL = (
    "role=prefill but no host KV tier is configured (need "
    "enable_prefix_caching + SHAI_KVTIER=1, unsharded pool) — handoffs "
    "will advertise kv_ready=false and decode peers will recompute")


def _check_ranks(ecfg: EngineConfig, group, model_cfg: LlamaConfig,
                 model: LlamaForCausalLM) -> None:
    """A tensor-parallel engine runs on one rank of ``group``
    (``parallel.distributed.DistGroup``), over that rank's model."""
    if ecfg.tensor_parallel_size != group_size(group):
        raise ValueError(
            f"tensor_parallel_size={ecfg.tensor_parallel_size} but the "
            f"engine's group has {group_size(group)} rank(s): run one "
            f"engine per rank of a parallel.distributed group of that size "
            f"(engine.ranks.launch_engine)")
    if group is not None and model_cfg.cross_attention_layers:
        raise ValueError(MLLAMA_RANKS)
    if model.group is not group:
        raise ValueError("the model's group is not the engine's: build the "
                         "rank's model over the same group")


class LLMEngine:
    """Drive with :meth:`add_request` + :meth:`step`, or offline
    :meth:`generate`. Single-threaded: one engine per pod, the serving
    layer serializes onto it (``engine.loop``). ``device`` defaults to the
    card; pass ``"cpu"`` to run the plain paths on the CPU.

    ``group``: one rank of a tensor-parallel group
    (``parallel.distributed.DistGroup`` of ``tensor_parallel_size``
    ranks), with ``model`` that rank's model (its shard of the weights,
    built over the same group). Every rank runs its own engine; rank 0's
    takes the requests and the others mirror its calls (``engine.ranks``,
    which attaches :attr:`mirror` and launches the ranks)."""

    def __init__(self, model_cfg: LlamaConfig, model: LlamaForCausalLM,
                 ecfg: EngineConfig, device: DeviceLike = None,
                 cross_seq_len: int = 0, group=None):
        _check_ranks(ecfg, group, model_cfg, model)
        self.group = group
        # the tensor-parallel plan (the reference's engine.py:93-99): the
        # rank's head counts; an indivisible count raises here
        self.shardings: Optional[EngineShardings] = (
            None if group is None
            else EngineShardings(model_cfg, group.size))
        #: rank 0's calls mirrored on every rank (engine.ranks.StepMirror);
        #: None on a one-device engine
        self.mirror = None
        # the deadline clock of the current step (a mirrored follower
        # reads rank 0's)
        self._now = 0.0
        # mllama: Lv, static per checkpoint (tiles x (patches + 1))
        self.cross_seq_len = cross_seq_len
        n_cross = len(model_cfg.cross_attention_layers)
        if n_cross and not cross_seq_len:
            raise ValueError("mllama config needs cross_seq_len (Lv)")
        self.device = resolve_device(device)
        # the boot HBM gate (the reference's engine.py:79-92): on the card
        # an over-budget geometry refuses to boot here, with the breakdown,
        # before the KV pool or any other allocation, instead of failing in
        # warmup. CPU runs skip unless SHAI_ENFORCE_HBM=1 opts in
        self.hbm_budget: Optional[HbmBudget] = None
        if (self.device.type == "cuda"
                or env_bool("SHAI_ENFORCE_HBM", False)):
            self.hbm_budget = causal_lm_budget(
                model_cfg, ecfg, cross_seq_len=cross_seq_len,
                hbm_gib_per_chip=detect_hbm_gib(self.device)).check()
        if model.device != self.device:
            raise ValueError(f"model weights are on {model.device}, the "
                             f"engine runs on {self.device}")
        if model.quantized != (ecfg.quantization == "int8"):
            raise ValueError(
                f"quantization={ecfg.quantization!r} but the model's weights "
                f"are {'int8' if model.quantized else 'not quantized'}: "
                f"quantize them at boot (ops.quant.quantize_state_dict)")
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
        # ragged paged attention (SHAI_RAGGED_ATTENTION, default off); text
        # engines only: the ragged continuation has no cross tail
        self._ragged = env_bool("SHAI_RAGGED_ATTENTION", False) \
            and not n_cross
        # the prefix cache serves plain text only: an mllama request's KV
        # depends on its image, not on its tokens alone
        prefix_caching = ecfg.enable_prefix_caching and not n_cross
        # host KV tier (SHAI_KVTIER): eviction and preemption demote blocks
        # to a bounded host-RAM pool, admission misses fall through to it;
        # it rides the prefix cache (the same chain hashes), unsharded pools
        # only: a TP pool's restore would need the per-rank placement the
        # tier does not carry (the reference's engine.py:139)
        tier = None
        if prefix_caching and self.shardings is not None \
                and env_bool("SHAI_KVTIER", False):
            log.warning("SHAI_KVTIER is set but the pool is sharded over "
                        "%d ranks: the host KV tier stays off",
                        self.shardings.tp)
        if prefix_caching and self.shardings is None:
            tier = maybe_host_tier(
                n_layers=model_cfg.n_layers, block_size=ecfg.block_size,
                n_kv_heads=model_cfg.n_kv_heads,
                head_dim=model_cfg.head_dim,
                dtype=("int8" if self._kv_quant else
                       "bfloat16" if kv_dtype == torch.bfloat16
                       else "float32"),
                quant=self._kv_quant)
        # disaggregated serving role (kvnet): SHAI_ROLE wins over
        # ecfg.role; a prefill engine banks each finished prompt's run in
        # the tier, so without one it warns and hands off nothing
        self.role = resolve_role(ecfg.role)
        self._prefill_role = self.role == "prefill"
        if self._prefill_role and tier is None:
            log.warning(NO_TIER_PREFILL)
        # the rank's head counts (the whole model's without a group)
        self._heads = ((model_cfg.n_heads, model_cfg.n_kv_heads)
                       if self.shardings is None else
                       (self.shardings.n_heads, self.shardings.n_kv_heads))
        # cross layers own no pool entry: the pool spans the self-attention
        # layers alone; under a group it holds the rank's kv heads (the
        # reference's kv_layer split on dim 2, an int8 pool's scales on 1)
        self.cache = PagedKVCache(
            model_cfg.n_layers - n_cross, self._heads[1],
            model_cfg.head_dim, ecfg.total_blocks, ecfg.block_size,
            ecfg.blocks_per_seq, dtype=kv_dtype, device=self.device,
            quant=self._kv_quant, enable_prefix_caching=prefix_caching,
            tier=tier)
        # mllama: the per-slot cross-KV buffers (the encoder cache), each
        # slot's has_image gate and valid state count
        S = ecfg.max_num_seqs
        #: the ``cross_len`` of a row without an image (text-only, freed or
        #: padding): every one of the Lv zero states live, under a zero gate
        self.cross_text_len = max(cross_seq_len, 1)
        self._cross_kv: Optional[List[Dict[str, torch.Tensor]]] = None
        self._has_image = np.zeros((S,), np.float32)
        self._cross_len = np.full((S,), self.cross_text_len, np.int32)
        self._cross_zero_cache: Dict[int, list] = {}
        if n_cross:
            shape = (S, cross_seq_len, model_cfg.n_kv_heads,
                     model_cfg.head_dim)
            self._cross_kv = [
                {"k": torch.zeros(shape, dtype=kv_dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=kv_dtype, device=self.device)}
                for _ in range(n_cross)]
            self._cross_embed = make_cross_kv(model_cfg)
            self._cross_write = make_cross_slot_write(model_cfg)
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
        # speculative decoding: a host-side prompt-lookup drafter and one
        # verify graph per (ctx bucket, batch bucket), decode's grid, k+1
        # positions per sequence
        self._verify_fns: Dict[Tuple[int, int], DecodeGraph] = {}
        self._drafter: Optional[PromptLookupDrafter] = None
        self.spec: Optional[SpecStats] = None
        if ecfg.speculative_enabled:
            self._drafter = PromptLookupDrafter(
                ecfg.num_speculative_tokens,
                ecfg.ngram_prompt_lookup_max, ecfg.ngram_prompt_lookup_min)
            self.spec = SpecStats()
            # the rejection uniforms (temperature > 0 acceptance): on the
            # host, a stream of their own, seeded as the reference's
            self._spec_rng = np.random.default_rng(ecfg.seed + 0x5EC)
        self._last_rollback_tokens = 0
        # fused mixed-phase step (SHAI_FUSED_STEP, default off; ragged
        # only): one graph per batch bucket replaces the decode and ragged
        # continuation ladders, and one more bb=1 graph takes the
        # chunk-only calls (its decode inputs stay null). It stays out of
        # speculative engines: verify owns multi-token dispatch there
        self._fused = (env_bool("SHAI_FUSED_STEP", False) and self._ragged
                       and not ecfg.speculative_enabled)
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
        self._graphs = GraphPool(
            self.device, capture=group is None or group.capturable)
        self._graphs.reserve(self._scratch_needs())
        self.obs = StepTelemetry(total_blocks=ecfg.total_blocks)
        if group is not None:
            # which rank this is, and whether its decode keys replay as
            # captured graphs or run eagerly (a gloo group's collectives
            # cannot be captured)
            self.obs.tp = {"size": group.size, "rank": group.rank,
                           "backend": group.backend,
                           "graphs": ("captured"
                                      if self._graphs.capture_graphs
                                      else "eager")}
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
        # the host tier's counters and the kvnet transport's ride the same
        # telemetry seam (/stats, /metrics, the admission gate); the
        # serving layer's puller and /kv/blocks share this one stats object
        self.obs.kvtier = self.cache.tier
        if self.cache.tier is not None:
            self.obs.kvnet = KvNetStats()
        # the fleet KV fabric's peer probe: env-gated and tier-bound;
        # fabric off leaves it None and the admission ladder unchanged
        self._kvfabric = None
        if self.cache.tier is not None and _kvdir.fabric_enabled():
            self._kvfabric = _kvdir.FabricProbe(
                self.cache.tier, kvnet_stats=self.obs.kvnet)
            self.obs.kvfabric = self._kvfabric.stats
        # live-migration counters on every engine: even a tier-less pod
        # ships manifest-only migrations and resumes them by recompute
        self.obs.migrate = MigrateStats()
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
                    traceparent: str = "", idem_key: str = "",
                    already_generated: Optional[Sequence[int]] = None,
                    already_lp: Optional[list] = None,
                    orig_n_prompt: int = -1,
                    kv_holders: Optional[Sequence[str]] = None,
                    cross_states: Optional[np.ndarray] = None,
                    cross_len: int = 0, prefix=None) -> int:
        """Queue a request. ``deadline_at``: an absolute
        ``time.monotonic()`` instant (0 = none) past which it finishes as
        ``"timeout"``; ``priority`` (0 high, 1 normal, 2 low, clamped) and
        ``tenant`` are its QoS tag, read under ``SHAI_QOS``.
        ``parent_rid``: the ``n > 1`` fan-out group it belongs to, named by
        its leader's id; ``-2`` makes this request the leader (its own id
        becomes the parent), ``-1`` none. ``traceparent`` and ``idem_key``
        ride the request (its W3C trace context and idempotency key).
        A request migrated in from a peer carries its output so far
        (``already_generated``, ``already_lp``: the prompt holds them as
        its suffix) and its original prompt length, the semantics of a
        preemption resume; ``kv_holders`` is a fleet slice of pods that
        may hold its prompt's KV run (the fabric's probe tries them).
        ``cross_states`` ``[cross_seq_len, dim]``: an mllama request's
        vision states, of which the first ``cross_len`` are valid (0: all);
        ``prefix`` ``[P, dim]`` (numpy or a tensor): a soft-prefix VLM
        request's image tokens, which take the first P positions of its
        one prefill (its text is then capped at the largest bucket less P,
        the tail kept). None for both is a text-only request."""
        params = (params or SamplingParams()).clamp(self.ecfg)
        if not prompt_ids:
            raise ValueError("empty prompt")
        if cross_states is not None:
            if self._cross_kv is None:
                raise ValueError("model has no cross-attention layers")
            if tuple(cross_states.shape) != (self.cross_seq_len,
                                             self.cfg.dim):
                raise ValueError(
                    f"cross_states must be [{self.cross_seq_len}, "
                    f"{self.cfg.dim}], got {tuple(cross_states.shape)}")
            if not 0 <= cross_len <= self.cross_seq_len:
                raise ValueError(f"cross_len={cross_len} out of [0, "
                                 f"{self.cross_seq_len}]")
        if prefix is not None and self._cross_kv is not None:
            raise ValueError(
                "mllama models condition on cross_states, not a soft prefix")
        n_prefix = 0 if prefix is None else int(prefix.shape[0])
        if n_prefix >= self.buckets.max:
            raise ValueError(
                f"prefix of {n_prefix} tokens exceeds the largest prefill "
                f"bucket {self.buckets.max}")
        if prefix is not None and tuple(prefix.shape) != (n_prefix,
                                                          self.cfg.dim):
            raise ValueError(f"prefix must be [P, {self.cfg.dim}], got "
                             f"{tuple(prefix.shape)}")
        # a soft-prefix request is bucket-bound (its prefix sits inside the
        # one prefill call); text and cross prompts chunk up to the cap
        max_prompt = (self.buckets.max - n_prefix if n_prefix
                      else self._chunk_cap)
        if len(prompt_ids) > max_prompt:
            prompt_ids = list(prompt_ids)[-max_prompt:]  # keep the tail
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
                                    prefix=prefix,
                                    cross_states=cross_states,
                                    cross_len=cross_len,
                                    on_token=on_token,
                                    deadline_at=deadline_at,
                                    t_submit=time.monotonic(),
                                    priority=priority, tenant=tenant,
                                    traceparent=traceparent,
                                    idem_key=idem_key,
                                    parent_rid=parent_rid,
                                    already_generated=list(
                                        already_generated or []),
                                    already_lp=list(already_lp or []),
                                    orig_n_prompt=orig_n_prompt,
                                    kv_holders=[str(u) for u in
                                                (kv_holders or [])]))
        if self.mirror is not None:
            # every rank queues it, with the same id (its stream and
            # callbacks stay rank 0's)
            self.mirror.record("add", rid, dict(
                prompt_ids=list(prompt_ids), params=params,
                deadline_at=deadline_at, priority=priority, tenant=tenant,
                parent_rid=parent_rid, already_generated=already_generated,
                already_lp=already_lp, orig_n_prompt=orig_n_prompt,
                prefix=None if prefix is None else np.asarray(
                    prefix.cpu() if isinstance(prefix, torch.Tensor)
                    else prefix)))
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
        if self.mirror is not None:
            self.mirror.record("cancel", req_id)
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

    # -- live migration (kvnet.migrate) ------------------------------------

    def _manifest_of(self, req: Request, resume_prompt, emitted,
                     remaining: int, lps, hashes) -> Dict[str, Any]:
        """The resumable state a peer re-admits from, as plain ints,
        floats and strings (it crosses pods as JSON), key for key the
        reference's. ``rng_step`` is informational: greedy is
        draw-free, and a sampled resume draws from the peer's own
        generator."""
        p = req.params
        now = time.monotonic()
        man: Dict[str, Any] = {
            "v": 1,
            "prompt_ids": [int(t) for t in resume_prompt],
            "generated": [int(t) for t in emitted],
            "n_prompt": int(req.orig_n_prompt),
            "params": {
                "temperature": float(p.temperature),
                "top_k": int(p.top_k), "top_p": float(p.top_p),
                "max_new_tokens": int(remaining),
                "eos_id": int(p.eos_id), "logprobs": int(p.logprobs),
            },
            "priority": int(req.priority), "tenant": req.tenant,
            "deadline_ms": (max(0.0, (req.deadline_at - now) * 1000.0)
                            if req.deadline_at else 0.0),
            "rng_step": int(self._step_count),
            "hashes": [int(h) for h in hashes],
        }
        if req.idem_key:
            # the peer's resume admits under the same key, so a duplicated
            # resume replay dedupes there
            man["idem_key"] = req.idem_key
        if p.logprobs and lps is not None:
            man["lps"] = list(lps)
        return man

    def snapshot_sequence(self, req_id: int) -> Optional[Dict[str, Any]]:
        """A request's resumable state: prompt and generated token ids,
        the remaining sampling budget, the QoS identity, the deadline's
        remainder, and the chain hashes of the full-block KV run this call
        BANKS in the host tier (``cache.demote_token_run``: the prompt's
        and the generated blocks, or a chunking slot's encoded chunks).
        Loop thread only; the caller has retired the in-flight lookahead
        and dispatched a parked window (``migrate_out`` does). The
        pending token's KV is never written (its write lands with the
        next dispatch), so the run covers prompt + generated only."""
        for r in self.waiting:
            if r.req_id == req_id:
                # queued: no KV yet, a pure prompt replay (the cold rung)
                return self._manifest_of(
                    r, r.prompt_ids, r.already_generated,
                    r.params.max_new_tokens, self._queued_lps(r), [])
        for s in self.slots:
            if s is None or s.req.req_id != req_id:
                continue
            req, p = s.req, s.req.params
            if s.prefill_cursor is not None:
                # mid-chunk: nothing generated in this segment; bank the
                # chunks encoded so far, which the peer's warm admission
                # skips
                _, hashes = self.cache.demote_token_run(
                    req_id, req.prompt_ids[:s.prefill_cursor])
                return self._manifest_of(
                    req, req.prompt_ids, req.already_generated,
                    p.max_new_tokens, self._queued_lps(req), hashes)
            committed = s.generated + [s.pending_token]
            _, hashes = self.cache.demote_token_run(
                req_id, req.prompt_ids + s.generated)
            lps = None
            if p.logprobs:
                lps = req.already_lp + s.lps[:len(committed)]
            return self._manifest_of(
                req, req.prompt_ids + committed,
                req.already_generated + committed,
                p.max_new_tokens - len(committed), lps, hashes)
        return None

    def migrate_out(self, req_id: int) -> Optional[Finished]:
        """Finish a request with stop reason ``"migrated"`` and its
        :meth:`snapshot_sequence` manifest attached: the serving layer
        ships the manifest and the banked run to a peer, where the request
        continues. A pending token that already ends the request finishes
        it as ``eos``/``length`` instead. Loop thread only; None for an
        unknown or finished id, and for a multimodal request, whose soft
        prefix or vision states do not travel in the manifest (the drain
        lets it finish here). A tensor-parallel engine migrates nothing:
        the run it would bank needs the host tier, which a sharded pool
        does not carry."""
        if self.group is not None:
            return None
        if any(r.multimodal and r.req_id == req_id
               for r in self.waiting) or any(
                   s is not None and s.req.req_id == req_id
                   and s.req.multimodal for s in self.slots):
            return None
        for i, r in enumerate(self.waiting):
            if r.req_id == req_id:
                man = self.snapshot_sequence(req_id)
                del self.waiting[i]
                self._prune_fanout(req_id)
                r.obs_extra["t_migrate_cut"] = time.monotonic()
                return Finished(
                    req_id, list(r.already_generated), r.orig_n_prompt,
                    "migrated", logprobs=self._queued_lps(r),
                    timing=self._timing_of(r), migration=man)
        s = next((s for s in self.slots
                  if s is not None and s.req.req_id == req_id), None)
        if s is None:
            return None
        # the in-flight lookahead may hold an extra token for this slot:
        # retire it so the snapshot reads current host mirrors (the extra
        # token is the discarded lookahead, the _abort contract); a parked
        # window writes its chunk before the run is banked
        self._flush_pipeline("migrate", req=s.req)
        self._flush_chunk()
        req, p = s.req, s.req.params
        req.obs_extra["t_migrate_cut"] = time.monotonic()
        if s.prefill_cursor is None:
            committed = s.generated + [s.pending_token]
            if (s.pending_token == p.eos_id
                    or len(committed) >= p.max_new_tokens):
                # the pending token already ends the request: finish it
                # here (_preempt_lowest's close-out), nothing to resume
                if req.on_token is not None and s.pending_token != p.eos_id:
                    req.on_token(s.pending_token)
                emitted = req.already_generated + committed
                lps = (req.already_lp + s.lps) if p.logprobs else None
                if emitted and emitted[-1] == p.eos_id:
                    emitted = emitted[:-1]
                    if lps:
                        lps = lps[:-1]
                    reason = "eos"
                else:
                    reason = "length"
                self._record_tpot(s)
                self._release_slot(s)
                self._prune_fanout(req_id)
                return Finished(req_id, emitted, req.orig_n_prompt, reason,
                                logprobs=lps,
                                timing=self._timing_of(req, s.t_first))
            if req.on_token is not None:
                # the pending token WILL be in the final output (the peer
                # resumes past it): stream it now, exactly once
                req.on_token(s.pending_token)
        man = self.snapshot_sequence(req_id)
        self._record_tpot(s)
        chunking = s.prefill_cursor is not None
        emitted = req.already_generated + (
            [] if chunking else s.generated + [s.pending_token])
        lps = None
        if p.logprobs:
            lps = req.already_lp + (
                [] if chunking else s.lps[:len(s.generated) + 1])
        self._release_slot(s)
        self._prune_fanout(req_id)
        return Finished(req_id, emitted, req.orig_n_prompt, "migrated",
                        logprobs=lps, timing=self._timing_of(req, s.t_first),
                        migration=man)

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
        now = self._now
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

    def close(self) -> None:
        """Rank 0 of a tensor-parallel group: end the follower ranks, after
        a last digest check (``engine.ranks``); a no-op on one device."""
        if self.mirror is not None:
            self.mirror.close(self)

    def warm_executables(self, prefix_lens: Sequence[int] = (0,)) -> int:
        if self.mirror is not None:
            self.mirror.record("warm", tuple(prefix_lens))
        return _warm_mod.warm_executables(self, prefix_lens)

    def _run_warm_calls(self) -> None:
        _warm_mod._run_warm_calls(self)

    @property
    def n_executables(self) -> int:
        """Built functions, as the reference counts executables: the
        chunk-only graph is a second capture of the bb=1 fused function."""
        return (len(self._prefill) + len(self._decode_fns)
                + len(self._verify_fns) + len(self._fused_fns))

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
        if inj.active and (self.mirror is None or self.mirror.leader):
            # chaos sites: step latency/stall (watchdog and deadline
            # fodder) and step crash (the engine-loop-death path), on the
            # host before this step enqueues anything, and before rank 0
            # tells the other ranks to run it: a step it crashes is run by
            # no rank
            inj.sleep_at(_faults.ENGINE_STEP)
            inj.raise_at(_faults.ENGINE_STEP)
        # the clock every deadline of this step is judged by: rank 0's,
        # on every rank of a mirrored group
        self._now = t0 if self.mirror is None else self.mirror.step_clock(t0)
        done = self._step_async() if self._async else self._step_sync()
        self._record_step(time.monotonic() - t0)
        if self.mirror is not None:
            self.mirror.after_step(self, done)
        return done

    def _record_step(self, duration_s: float) -> None:
        """One step record (occupancy, KV pressure, the speculative
        rollback since the last record and the spec counters, finished
        ids, tenant gauges), then the conformance feeds: the perf
        sentinel's (tokens, host seconds) sample and one HBM ledger tick.
        Host numbers only."""
        tenants = None
        if self._tenant_seen:
            tenants = {}
            for r in self.waiting:
                tenants.setdefault(r.tenant, [0, 0])[0] += 1
            for s in self.slots:
                if s is not None:
                    tenants.setdefault(s.req.tenant, [0, 0])[1] += 1
        rb = self.cache.rollback_tokens
        self.obs.record_step(
            kind=self._step_kind, duration_s=duration_s,
            n_running=self.n_running, n_waiting=self.n_waiting,
            n_chunking=self.n_chunking,
            blocks_free=self.cache.allocator.n_free,
            blocks_evictable=(self.cache.n_evictable
                              if self.cache.prefix_caching else 0),
            finished=len(self._done_this_step),
            rollback_tokens=rb - self._last_rollback_tokens,
            spec=self.spec.as_dict() if self.spec is not None else None,
            finished_ids=[f.req_id for f in self._done_this_step],
            tenants=tenants,
            # a replay still in flight has not completed: the step's last
            # completed work is its readback (the watchdog's clock)
            completed_at=self._t_fetch if self._pipe is not None else None)
        self._last_rollback_tokens = rb
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

    def graphs(self) -> List[DecodeGraph]:
        """Every graph of the engine: the decode keys, the verify keys, and
        under the fused step the fused keys and the chunk-only graph."""
        return (list(self._decode_fns.values())
                + list(self._verify_fns.values())
                + list(self._fused_fns.values())
                + ([self._fused_chunk] if self._fused_chunk else []))

    def _price_static_pools(self) -> Dict[str, float]:
        """The pools that change only when an executable is built: the
        weights, the KV pool, and the decode graphs' static batch inputs
        (where the port keeps the device-resident batch); in ``extra``,
        the CUDA graph pool and the split scratch, which the allocator
        holds outside every attributed pool."""
        out = {
            "weights": float(sum(p.nbytes for p in self.model.parameters())),
            "kv_pool": float(self.cache.pool_bytes),
            "resident": float(sum(
                sum(t.nbytes for t in g.inputs.values())
                + sum(u.nbytes for u in g.draws) for g in self.graphs())),
            "graph_pool_bytes": float(self._graphs.bytes() or 0),
            "split_scratch_bytes": float(
                split_scratch_bytes(self.device) if self._cuda_mem else 0),
        }
        if self._cross_kv is not None:
            out["cross_kv"] = float(sum(
                t.nbytes for buf in self._cross_kv for t in buf.values()))
        return out

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
        if "cross_kv" in st:
            # mllama: the per-slot cross-KV buffers, priced once
            pools["cross_kv"] = st["cross_kv"]
        bytes_in_use = peak = None
        if self._cuda_mem:
            bytes_in_use = torch.cuda.memory_allocated(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
        drift = kv_leaked
        if bytes_in_use is not None:
            drift += max(0.0, float(bytes_in_use) - sum(pools.values()))
        # the host tier's bytes ride the snapshot (shai_hbm_host_kv_bytes)
        # but stay out of the attributed device sum
        host_pools = None
        if self.cache.tier is not None:
            host_pools = {"host_kv": self.cache.tier.used_bytes}
        led.sample(
            pools=pools,
            composition=(self.n_running, self.n_waiting, self.n_chunking),
            bytes_in_use=bytes_in_use, peak_bytes=peak,
            # no counterpart of the largest free block in torch's counters
            largest_free=None, drift_value=drift, host_pools=host_pools,
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
        now = self._now
        deadline_due = (
            any(0.0 < r.deadline_at <= now for r in self.waiting)
            or any(s is not None and 0.0 < s.req.deadline_at <= now
                   for s in self.slots))
        chunking = any(s is not None and s.prefill_cursor is not None
                       for s in self.slots)
        # the steady (pure-decode) path needs no host-side inputs at all;
        # admission work, a chunking slot, a due deadline or a drafter
        # wanting the pending token makes an event step
        if (self._pipe is not None and not self.waiting and not chunking
                and not deadline_due and self._drafter is None):
            self._steady_step()
        else:
            if self._pipe is not None:
                self._flush_pipeline("deadline" if deadline_due else
                                     "admission" if self.waiting else
                                     "chunking" if chunking else "spec")
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
        the pipeline in the same call that handled the event. With a
        drafter, a verify step takes its place when some slot drafted."""
        if self._drafter is not None and self._spec_step():
            self._step_kind = "spec"
            return
        self._grow_running(lambda s: 1)
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

    def _flush_pipeline(self, reason: str,
                        req: Optional[Request] = None) -> None:
        """Retire the in-flight lookahead (a no-op when none): the explicit
        pipeline flush every composition or control-flow event pays,
        counted per reason; ``req``, the request it is attributable to,
        counts it on its trace's decode span."""
        pipe, self._pipe = self._pipe, None
        if pipe is None:
            return
        self._retire_pipe(pipe)
        self.obs.count_flush(reason)
        if req is not None:
            req.obs_extra["pipeline_flushes"] = \
                req.obs_extra.get("pipeline_flushes", 0.0) + 1.0

    def finish_pending(self) -> None:
        """Retire any in-flight lookahead step: the engine loop calls this
        when the engine goes idle, so host mirrors do not sit one step
        stale across an idle gap."""
        if self.mirror is not None and self._pipe is not None:
            self.mirror.record("finish_pending")
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
        if self.waiting and self.waiting[0].prefix is not None:
            self._admit_one()       # soft prefix: bucket-bound, alone
        elif (self._kv_cow and self.waiting
                and self.waiting[0].parent_rid >= 0
                and self._admit_fanout()):
            pass                    # CoW fan-out: one prefill, K forks
        elif (self.cache.prefix_caching and self.waiting
              and self._admit_cached()):
            pass                    # cached-prefix admission handled it
        elif (self.waiting
                and len(self.waiting[0].prompt_ids) > self.buckets.max):
            if not chunking:
                self._admit_long()  # chunked prefill (text or cross)
        elif self.waiting and self.waiting[0].cross_states is not None:
            self._admit_one()       # a short multimodal prompt: alone
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
        # a freed slot gates its cross layers off until it is admitted
        self._has_image[s.slot] = 0.0
        self._cross_len[s.slot] = self.cross_text_len

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
            if req.multimodal:
                break  # multimodal: _admit_one takes it at the head
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
                           torch.from_numpy(tables).to(dev),
                           *_cross_mod.text_cross_args(self, Kp))
            toks = sample_logits(logits, self._gen,
                                 torch.from_numpy(temp).to(dev),
                                 torch.from_numpy(topk).to(dev),
                                 torch.from_numpy(topp).to(dev)).cpu()
        real = sum(len(r.prompt_ids) for r in group)
        self.obs.count_pad(real, Kp * bucket - real, phase="prefill")
        for req in group:
            self.cache.register_prefix(req.prompt_ids,
                                       self.cache.seq(req.req_id).blocks)
        lp_rows = []
        for i, req in enumerate(group):
            slot = self._free_slot()
            self._start_slot(slot, req, int(toks[i]))
            if req.params.logprobs:
                lp_rows.append((i, self.slots[slot]))
        if lp_rows:
            _record_admission_lps(self, logits, [int(t) for t in toks],
                                  lp_rows)

    def _admit_one(self) -> None:
        """Admit the head request alone (the reference's ``_admit_one``,
        ``:1339-1384``): a soft-prefix request, whose P image tokens take
        the first positions of one prefill at the bucket of ``P +`` its
        text, or an mllama request whose prompt fits the largest bucket,
        its vision states projected into the slot's buffers first. One
        prefill samples the first token."""
        if not self.waiting:
            return
        slot = self._free_slot()
        if slot is None:
            return
        req = self.waiting[0]
        P = req.prefix_len
        max_text = self.buckets.max - P
        if len(req.prompt_ids) > max_text:
            # a preemption resume may pass the largest bucket: keep the
            # tail, as add_request does
            req.prompt_ids = req.prompt_ids[-max_text:]
        n_text = len(req.prompt_ids)
        n = P + n_text      # the cache's tokens
        if not self._try_reserve(req, n):
            return
        self.waiting.popleft()
        self._note_admitted(req)
        bucket = self.buckets.bucket_for(n)
        self.cache.admit(req.req_id, n)
        ids = np.zeros((1, bucket - P), np.int32)
        ids[0, :n_text] = req.prompt_ids
        dev = self.device
        p = req.params
        fn = self._prefill_for(bucket, 1, prefix_len=P)
        with torch.inference_mode():
            cross = _cross_mod._set_slot_cross(self, slot, req)
            extra = {}
            if P:
                prefix = req.prefix
                if isinstance(prefix, np.ndarray):
                    prefix = torch.from_numpy(np.array(prefix, np.float32))
                extra["prefix"] = prefix.to(dev)[None]
            with annotate("engine.prefill"):
                _, logits = fn(self.model, self.cache.kv,
                               torch.from_numpy(ids).to(dev),
                               torch.tensor([n_text], dtype=torch.int32,
                                            device=dev),
                               self._table_of(req), *cross, **extra)
            tok = int(sample_logits(logits, self._gen, p.temperature,
                                    p.top_k, p.top_p)[0])
        self.obs.count_pad(n, bucket - n, phase="prefill")
        # no register_prefix: a vision-conditioned prompt's blocks must not
        # content-address by its tokens alone
        self._start_slot(slot, req, tok)
        if p.logprobs:
            _record_admission_lps(self, logits, [tok],
                                  [(0, self.slots[slot])])

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
               or r.multimodal for r in group):
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
                self._table_of(head), *_cross_mod.text_cross_args(self, 1))
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
            # the cut brought it back inside a bucket
            if req.cross_states is not None:
                self._admit_one()
            else:
                self._admit_batch()
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
            # an mllama engine seats the vision states (or the text-only
            # gate) in the slot's buffers once; every chunk and decode
            # step reads them there
            cross = ([] if self._cross_kv is None
                     else list(_cross_mod._set_slot_cross(self, slot, req)))
            fn(self.model, self.cache.kv, ids,
               torch.tensor([C], dtype=torch.int32, device=dev),
               self._table_of(req), *cross)
        # the first chunk's full blocks are final: publish them now, so an
        # identical long prompt (or this one resuming) shares them early
        self.cache.register_prefix(req.prompt_ids[:C],
                                   self.cache.seq(req.req_id).blocks)
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
                # its logits are dropped, as the laddered path drops them;
                # registration and the cursor keep the laddered timing
                self._pending_chunk = window
                self.obs.count_pad(n, C - n, phase="chunk")
                self.cache.register_prefix(
                    req.prompt_ids[:start + n],
                    self.cache.seq(req.req_id).blocks)
                s.prefill_cursor = start + C
                return
        with torch.inference_mode():
            if self._fused:
                # the final chunk's token joins THIS step's decode batch,
                # so it cannot ride that replay: chunk-only
                logits = self._fused_chunk_call(window)
            else:
                fn = self._cont_for(start // self.ecfg.block_size)
                cross = ([] if self._cross_kv is None else
                         list(_cross_mod._slot_cross_args(self, s.slot)))
                with annotate("engine.prefill"):
                    _, logits = fn(self.model, self.cache.kv,
                                   torch.from_numpy(ids).to(dev),
                                   torch.tensor([n], dtype=torch.int32,
                                                device=dev),
                                   self._table_of(req),
                                   *self._cont_args(start), *cross)
            if final:
                p = req.params
                tok = sample_logits(logits, self._gen, p.temperature,
                                    p.top_k, p.top_p)
        self.obs.count_pad(n, C - n, phase="chunk")
        # each chunk's full blocks are final: publish them per chunk
        self.cache.register_prefix(req.prompt_ids[:start + n],
                                   self.cache.seq(req.req_id).blocks)
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

    def _cont_for(self, start_blocks: int, bucket: Optional[int] = None):
        """The continuation function for a ``bucket``-token chunk (the
        largest prefill bucket by default) at ``start_blocks``: one per
        (start, bucket) on the static ladder, one per chunk bucket when
        ragged."""
        bucket = self.buckets.max if bucket is None else bucket
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
        """The warm-set key a continuation call resolves to: the cold
        guard of cached admission checks THIS, so the ragged (start-free)
        keys gate correctly."""
        if self._ragged:
            return ("rcont", bucket)
        return ("cont", start_blocks, bucket)

    def _cached_chunk_bucket(self, remainder: int) -> int:
        """The window a cached admission's continuation takes: the fused
        step's chunk window is pinned to the largest prefill bucket; the
        laddered engine takes the smallest bucket covering the
        remainder."""
        if self._fused:
            return self.buckets.max
        return self.buckets.bucket_for(remainder)

    def _cont_cold(self, sb: int, chunk_bucket: int) -> bool:
        """After warmup, True when the continuation a cached admission
        would call was never built (a build after readiness is the
        cold-graph bug); the fused step calls the chunk-only graph."""
        if not self._warmed:
            return False
        if self._fused:
            return self._fused_chunk is None
        return self._cont_key(sb, chunk_bucket) not in self._prefill

    def _cached_starts(self) -> List[int]:
        """THE closed set of continuation starts (tokens) the warm ladder
        and cached admission both price from: every prefill bucket and
        every multiple of the largest bucket."""
        C = self.buckets.max
        starts = set(self.buckets.buckets)
        s = C
        while s + 1 < self.ecfg.max_model_len:
            starts.add(s)
            s += C
        return sorted(starts)

    def _cached_start_for(self, n_total: int, cached_tokens: int) -> int:
        """Largest warm start covered by the cached prefix whose remainder
        fits ONE chunk of the largest bucket; 0 = no benefit."""
        C = self.buckets.max
        best = 0
        for s in self._cached_starts():
            if (s <= cached_tokens and s < n_total
                    and n_total - s <= C and s > best):
                best = s
        return best

    def _fabric_probe(self, req: Request, hashes: List[int],
                      from_block: int) -> int:
        """The admission ladder's peer-probe rung: pull the prompt's
        leading run from a fleet holder into the host tier, so the
        ordinary tier restore admits it. Priced before any network work:
        no holders costs nothing, the budget is capped at the recompute
        time it could save (the sentinel's projected rate), and a deadline
        with less headroom than those savings skips the rung. Runs on the
        loop thread, as the reference's does. Returns the blocks fetched
        (0 = recompute); never raises."""
        fab = self._kvfabric
        if fab is None or from_block >= len(hashes):
            return 0
        want = hashes[from_block:]
        holders = list(req.kv_holders) or fab.holders_for(want[0])
        if not holders:
            return 0
        budget = fab.client.timeout_s
        rate = float(getattr(self.obs.sentinel, "projected_per_s", 0.0)
                     or 0.0)
        if rate > 0.0:
            savings = len(want) * self.ecfg.block_size / rate
            budget = min(budget, savings)
            if req.deadline_at and req.deadline_at - time.monotonic() \
                    < savings:
                return 0  # priced out: the headroom belongs to recompute
        elif req.deadline_at:
            budget = min(budget, req.deadline_at - time.monotonic())
        t0 = time.monotonic()
        got = fab.probe(want, holders, budget,
                        traceparent=req.traceparent or None)
        req.obs_extra["t_fabric"] = t0
        req.obs_extra["fabric_probe_s"] = round(time.monotonic() - t0, 6)
        req.obs_extra["fabric_blocks"] = float(got)
        return got

    def _admit_cached(self) -> bool:
        """Admit the head request on its cached prefix (the reference's
        ``_admit_cached``): share the device-cached blocks, restore what
        the host tier adds, and run ONE continuation over the uncached
        remainder, then register the prompt. Returns False, with nothing
        consumed, when the cache offers no usable warm start; the caller
        falls through to the plain admission paths."""
        req = self.waiting[0]
        n_total = len(req.prompt_ids)
        bs = self.ecfg.block_size
        if n_total <= bs:
            return False  # no full block to share
        if self._fused and self._kv_quant:
            # an int8 pool re-quantizes a written block over everything in
            # it: the fused C-token window writes pad past the remainder
            # that the laddered chunk bucket never touches, so the tail
            # block's scale would differ from the oracle's; plain
            # admission prefills from scratch and stays exact
            return False
        slot = self._free_slot()
        if slot is None:
            # probe nothing while blocked on a slot: per-step probes would
            # churn both LRUs and inflate the tier's hit counters
            return False
        hashes = self.cache.prefix_hashes(req.prompt_ids)
        cached = self.cache.cached_prefix(req.prompt_ids, hashes=hashes)
        # host-tier fall-through: blocks the device cache evicted (or a
        # preemption demoted) may still be host-resident
        n_tier = self.cache.tier_prefix_len(hashes, len(cached))
        start = self._cached_start_for(n_total,
                                       (len(cached) + n_tier) * bs)
        if start == 0 and self._kvfabric is not None:
            # third rung (the KV fabric): device and tier came up cold, a
            # fleet holder may have the run; the probe publishes into the
            # tier, whose restore below admits it unchanged
            if self._fabric_probe(req, hashes, len(cached)) > 0:
                n_tier = self.cache.tier_prefix_len(hashes, len(cached))
                start = self._cached_start_for(
                    n_total, (len(cached) + n_tier) * bs)
        if start == 0:
            return False
        chunk_bucket = self._cached_chunk_bucket(n_total - start)
        sb = start // bs
        if start + chunk_bucket > self.ecfg.max_model_len:
            return False  # the continuation would overrun blocks_per_seq
        if self._cont_cold(sb, chunk_bucket):
            return False
        take = max(0, sb - len(cached))
        need_new = self._need_blocks(n_total) - sb
        # conservative: pinning the reused blocks removes up to sb blocks
        # from the evictable supply, and the restore takes `take` more
        if need_new + take > self.cache.n_available - sb:
            return False  # the plain paths own wait-or-reject
        if take:
            # the restore writes the pool: retire the in-flight lookahead
            # first (a no-op in lock-step), and restore eagerly, outside
            # every capture, before the continuation call
            self._flush_pipeline("kvtier", req=req)
            t0 = time.monotonic()
            n_before = len(cached)
            cached = cached + self.cache.restore_prefix(
                hashes, len(cached), take, pin=cached)
            req.obs_extra["t_kv_restore"] = t0
            req.obs_extra["kv_restore_s"] = round(time.monotonic() - t0, 6)
            req.obs_extra["kv_restore_blocks"] = float(len(cached)
                                                       - n_before)
            if len(cached) < sb:
                # tier shortfall (raced host eviction, transfer failure):
                # re-derive the warm start from the blocks that DID land;
                # recompute covers the rest
                start = self._cached_start_for(n_total, len(cached) * bs)
                if start == 0:
                    return False
                chunk_bucket = self._cached_chunk_bucket(n_total - start)
                sb = start // bs
                if start + chunk_bucket > self.ecfg.max_model_len:
                    return False
                if self._cont_cold(sb, chunk_bucket):
                    return False
        self.waiting.popleft()
        try:
            alloc = self.cache.admit(req.req_id, n_total,
                                     reuse_blocks=cached[:sb])
        except MemoryError:
            self.waiting.appendleft(req)
            return False  # the plain paths own wait-or-reject
        self._note_admitted(req)
        # the prompt past the warm start is recomputed, not restored
        req.obs_extra["recompute_tokens"] = float(n_total - start)
        n = n_total - start
        ids = np.zeros((1, chunk_bucket), np.int32)
        ids[0, :n] = req.prompt_ids[start:]
        dev = self.device
        p = req.params
        with torch.inference_mode():
            if self._fused:
                # a parked window must not reorder behind this admission's
                # own (it may be due to write blocks this one reads)
                self._flush_chunk()
                logits = self._fused_chunk_call(
                    (ids, n, alloc.table(self.ecfg.blocks_per_seq)[None],
                     start))
            else:
                fn = self._cont_for(sb, chunk_bucket)
                with annotate("engine.prefill"):
                    _, logits = fn(self.model, self.cache.kv,
                                   torch.from_numpy(ids).to(dev),
                                   torch.tensor([n], dtype=torch.int32,
                                                device=dev),
                                   self._table_of(req),
                                   *self._cont_args(start))
            tok = int(sample_logits(logits, self._gen, p.temperature,
                                    p.top_k, p.top_p)[0])
        self.obs.count_pad(n, chunk_bucket - n, phase="prefill")
        self.cache.register_prefix(req.prompt_ids, alloc.blocks)
        self._start_slot(slot, req, tok)
        if p.logprobs:
            _record_admission_lps(self, logits, [tok],
                                  [(0, self.slots[slot])])
        return True

    def _cont_args(self, start: int) -> list:
        """Trailing arguments of a continuation call beyond ``(model, kv,
        ids, n_text, block_tables)``: the ragged variant takes the start as
        data."""
        if self._ragged:
            return [torch.tensor([start], dtype=torch.int32,
                                 device=self.device)]
        return []

    def _prefill_for(self, bucket: int, n_seqs: int = 1, prefix_len: int = 0):
        """The prefill of ``bucket`` at batch ``n_seqs``, keyed ``(bucket,
        n_seqs)``; a soft-prefix prefill (one sequence) is keyed
        ``("prefix", bucket, prefix_len)`` (the reference's ``(bucket,
        prefix_len, 1)``, ``:1987-1996``)."""
        key = ("prefix", bucket, prefix_len) if prefix_len else (bucket,
                                                                 n_seqs)
        if key not in self._prefill:
            # chaos site: executable-factory compile failure
            _faults.get().raise_at(_faults.COMPILE)
            if self._warmed:
                self.obs.count_recompile("prefill")
            self._prefill[key] = make_prefill(
                self.cfg, self.ecfg.block_size, self.ecfg.blocks_per_seq,
                bucket, n_seqs=n_seqs, kv_quant=self._kv_quant,
                prefix_len=prefix_len)
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
        """The split scratch each decode and verify key of the closed set
        takes on the card (B2 and B3 read the bucket's first ``m`` table
        entries);
        under the fused step, each fused key's mixed-row launch (its decode
        rows split, the chunk's group not)."""
        if self.device.type != "cuda":
            return []
        cfg, n_sms = self.cfg, sm_count(self.device.index)
        H, Hkv = self._heads
        if self._fused:
            return [groups_scratch_size(
                mixed_phase_groups(bb, self.buckets.max), H,
                Hkv, cfg.head_dim, self.ecfg.block_size,
                self.ecfg.blocks_per_seq, n_sms)
                for bb in self._batch_buckets()]
        # a verify key walks Bb * (k + 1) rows over the repeated tables
        rows = [1] + ([self.ecfg.num_speculative_tokens + 1]
                      if self.ecfg.speculative_enabled else [])
        return [split_scratch_size(bb * r, 1, H, Hkv, cfg.head_dim,
                                   self.ecfg.block_size, m, n_sms)
                for m in self._ctx_buckets for bb in self._batch_buckets()
                for r in rows]

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
                self.cfg.vocab_size, device=self.device, pool=self._graphs,
                cross_kv=self._cross_kv, cross_text_len=self.cross_text_len)
            graph.capture()
            self._decode_fns[key] = graph
        return bb, self._decode_fns[key]

    def _verify_for(self, m_blocks: int, n_active: int = -1):
        """The verify graph for the smallest (context, batch) buckets
        covering the running set (decode's dispatch rule, ``k + 1`` scored
        positions per sequence), captured when its key is first built."""
        m = next(b for b in self._ctx_buckets if b >= m_blocks)
        bb = (self.ecfg.max_num_seqs if n_active < 0
              else self._batch_bucket(n_active))
        key = (m, bb)
        if key not in self._verify_fns:
            # chaos site, before the function is built and the capture
            # opens
            _faults.get().raise_at(_faults.COMPILE)
            if self._warmed:
                self.obs.count_recompile("verify")
            k = self.ecfg.num_speculative_tokens
            graph = DecodeGraph(
                ("verify", m, bb),
                make_verify(self.cfg, self.ecfg.block_size,
                            self.ecfg.blocks_per_seq, bb, k, ctx_blocks=m,
                            ragged=self._ragged, kv_quant=self._kv_quant),
                self.model, self.cache.kv, bb, self.ecfg.blocks_per_seq,
                self.cfg.vocab_size, device=self.device, pool=self._graphs,
                verify_k=k, cross_kv=self._cross_kv,
                cross_text_len=self.cross_text_len)
            graph.capture()
            self._verify_fns[key] = graph
        return bb, self._verify_fns[key]

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
        if self.cache.tier is not None and not victim.req.multimodal:
            # demotion, not deletion: publish the victim's full blocks
            # before release, so re-admission reuses them while they
            # survive and pool pressure demotes them to the tier. KV exists
            # for prompt + generated (the pending token's write lands with
            # the next dispatch, which the victim never runs); the flush
            # above retired the in-flight step that wrote the last of it
            kv_tokens = (victim.req.prompt_ids[:victim.prefill_cursor]
                         if victim.prefill_cursor is not None
                         else victim.req.prompt_ids + victim.generated)
            self.cache.offload_preempt(kv_tokens, victim.req.req_id)
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
            prefix=victim.req.prefix,
            cross_states=victim.req.cross_states,
            cross_len=victim.req.cross_len,
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

    def _grow_running(self, n_ext_for) -> None:
        """Reserve ``n_ext_for(slot)`` cache tokens for every decoding slot
        (1 for decode's pending token; 1 + its draft for verify),
        recompute-preempting on pool exhaustion (never down to zero running
        sequences): the reservation step of both dispatch paths."""
        for s in list(self.slots):
            if s is None or s.prefill_cursor is not None:
                continue  # mid-prefill slots neither grow nor decode yet
            if self.slots[s.slot] is not s:
                continue  # preempted by an earlier iteration
            n_ext = n_ext_for(s)
            while True:
                try:
                    self.cache.extend(s.req.req_id, n_ext)
                    break
                except MemoryError:
                    if sum(x is not None for x in self.slots) <= 1:
                        raise  # one seq must always fit: config error
                    self._preempt_lowest()
                    if self.slots[s.slot] is not s:
                        break  # s itself was preempted

    def _note_dispatch_pad(self, running, Bb: int,
                           rows_per_seq: int = 1) -> None:
        """Pad-waste accounting for one decode or verify dispatch: ``real``
        is the context tokens the rows hold, the pad the slots the call
        walks beyond them (batch pad rows, and the context window past
        each row's live tokens: the bucket for every row, or each row's own
        blocks when ragged). ``rows_per_seq``: verify flattens ``k + 1``
        query rows per sequence, each walking the window, so both sides
        scale (phase ``verify``)."""
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
        self.obs.count_pad(real * rows_per_seq, (walked - real) * rows_per_seq,
                           phase="verify" if rows_per_seq > 1 else "decode")

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
        if self._cross_kv is not None:
            # each row's slot in the cross buffers, its gate and its valid
            # vision states; padding rows read slot 0 under a zero gate
            a.update(slot_idx=np.zeros((Bb,), np.int32),
                     has_image=np.zeros((Bb,), np.float32),
                     cross_len=np.full((Bb,), self.cross_text_len, np.int32))
        for i, s in enumerate(running):
            a["tables"][i] = self.cache.seq(s.req.req_id).table(M)
            a["temp"][i] = s.req.params.temperature
            a["topk"][i] = s.req.params.top_k
            a["topp"][i] = s.req.params.top_p
            if self._cross_kv is not None:
                a["slot_idx"][i] = s.slot
                a["has_image"][i] = self._has_image[s.slot]
                a["cross_len"][i] = self._cross_len[s.slot]
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
        and read the tokens back before the bookkeeping; with a drafter, a
        verify step when some slot drafted."""
        if self._drafter is not None and self._spec_step():
            self._step_kind = "spec"
            return
        self._grow_running(lambda s: 1)
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
            for name in a:
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

    def _spec_step(self) -> bool:
        """One speculative step (the reference's ``engine.py:2346``): draft
        per running slot, verify every draft and the bonus position in one
        replay, commit the longest prefix the model agrees with, and roll
        the rest of the reservation back.

        Returns False, without touching the cache, when no slot drafted:
        the caller falls through to the decode replay (no ``k + 1``
        overcompute). Reads back ``o``, ``oex`` and ``accept_p`` at once
        (every verify step is an event step), the logprob arrays only when
        a running request asked for them."""
        k = self.ecfg.num_speculative_tokens
        running = self._running_slots()
        if not running:
            return False
        drafts: Dict[int, List[int]] = {}
        for s in running:
            p = s.req.params
            # a draft leaves room for its own commit: inside the request's
            # token budget and the model length (the reservation below must
            # never trip the max_model_len guard)
            cap = min(k, p.max_new_tokens - len(s.generated) - 1,
                      self.ecfg.max_model_len
                      - self.cache.seq(s.req.req_id).n_tokens - 1)
            if cap <= 0:
                drafts[s.slot] = []
                continue
            ctx = s.req.prompt_ids + s.generated + [s.pending_token]
            drafts[s.slot] = self._drafter.draft(ctx)[:cap]
        if not any(drafts.values()):
            self.spec.fallback_steps += 1
            return False
        # reserve the pending token and the draft per slot before the
        # replay; pool pressure preempts as in decode, and may take a slot
        # away: the running set is read again
        self._grow_running(lambda s: 1 + len(drafts.get(s.slot, ())))
        running = self._running_slots()
        if not running:
            return True  # everything was preempted; the step is done
        n_exec = self.n_executables
        Bb, graph = self._verify_for(self._max_ctx_blocks(running),
                                     len(running))
        self._note_dispatch_pad(running, Bb, rows_per_seq=k + 1)
        # the batch view is decode's resident one; only the tokens and
        # positions are marshaled per step
        self._res.refresh(self, running, Bb, graph)
        tokens = np.zeros((Bb, k + 1), np.int32)
        pos0 = np.zeros((Bb,), np.int32)
        n_drafted = [len(drafts.get(s.slot, ())) for s in running]
        for i, s in enumerate(running):
            d = drafts.get(s.slot, [])
            tokens[i, 0] = s.pending_token
            tokens[i, 1:1 + len(d)] = d
            pos0[i] = self.cache.seq(s.req.req_id).n_tokens - (1 + len(d))
        want_lp = any(s.req.params.logprobs for s in running)
        with torch.inference_mode():
            upload(graph.inputs["tokens"], tokens)
            upload(graph.inputs["pos"], pos0)
            graph.draw(self._gen)
            t_d = time.monotonic()
            with annotate("engine.verify"):
                graph.replay()
            if self._t_fetch and self.n_executables == n_exec \
                    and self._last_decode_step == self._step_count - 1:
                self.obs.step_gap.observe(max(0.0, t_d - self._t_fetch))
            self._last_decode_step = self._step_count
            o, oex, accept_p = (t.cpu().numpy() for t in (
                graph.o, graph.oex, graph.accept_p))
            if want_lp:
                o_lp, d_lp, oex_lp, top_ids, top_lp = (
                    t.cpu().numpy() for t in (graph.o_lp, graph.d_lp,
                                              graph.oex_lp, graph.top_ids,
                                              graph.top_lp))
        self._t_fetch = time.monotonic()
        self.spec.verify_steps += 1
        for i, s in enumerate(running):
            if self.slots[s.slot] is not s:
                continue
            d = drafts.get(s.slot, [])
            nd = n_drafted[i]
            p = s.req.params
            j, next_tok = accept_drafts(
                d, o[i], oex[i], accept_p[i], p.temperature,
                self._spec_rng.random(nd) if p.temperature > 0.0
                else np.zeros(nd))
            # give back what verification rejected: the reservation shrinks
            # to exactly the committed tokens
            self.cache.shrink(s.req.req_id, nd - j)
            committed = [s.pending_token] + [int(t) for t in d[:j]]
            n_processed = 0  # tokens the commit walk reaches: an EOS or
            # length finish mid-run must not inflate tokens_per_verify
            finished = False
            for m, c in enumerate(committed):
                n_processed += 1
                self._tokens_this_step += 1  # the perf sentinel's feed
                s.generated.append(c)
                hit_eos = c == p.eos_id
                if hit_eos:
                    s.generated.pop()  # exclude EOS from the emitted text
                    if p.logprobs and s.lps:
                        s.lps.pop()    # its logprob entry goes with it
                elif s.req.on_token is not None:
                    s.req.on_token(c)
                full = len(s.generated) >= p.max_new_tokens
                out_of_len = pos0[i] + m + 1 >= self.ecfg.max_model_len
                if hit_eos or full or out_of_len:
                    self._record_tpot(s)
                    self._finish(Finished(
                        s.req.req_id, s.req.already_generated + s.generated,
                        s.req.orig_n_prompt, "eos" if hit_eos else "length",
                        logprobs=((s.req.already_lp + s.lps)
                                  if p.logprobs else None),
                        timing=self._timing_of(s.req, s.t_first)))
                    self._release_slot(s)
                    finished = True
                    break
                if p.logprobs:
                    # the entry of this token's successor, where vanilla
                    # records it (at sample time): the next accepted draft,
                    # or the verify sample that ends the chain
                    if m < j:
                        s.lps.append(_lp_entry(
                            p.logprobs, committed[m + 1], d_lp[i, m],
                            top_ids[i, m], top_lp[i, m]))
                    else:
                        tok_lp = (o_lp[i, j] if (j == nd
                                                 or p.temperature <= 0.0)
                                  else oex_lp[i, j])
                        s.lps.append(_lp_entry(
                            p.logprobs, next_tok, tok_lp, top_ids[i, j],
                            top_lp[i, j]))
            self.spec.record_verify(nd, j, n_processed)
            if not finished:
                s.pending_token = next_tok
        return True

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
                if self._prefill_role:
                    # prefill-role handoff: bank the prompt's KV in the
                    # host tier BEFORE release, so a peer decode pod can
                    # pull it the moment the serving layer returns the
                    # handoff (failures degrade to recompute on the peer)
                    self.cache.demote_prompt_run(s.req.req_id,
                                                 s.req.prompt_ids)
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
