"""The paged engine over tensor-parallel ranks: the step mirror and the
launcher.

The reference serves tensor parallelism from one controller: one
``LLMEngine`` drives every device of the mesh, and XLA runs each rank's
part of every executable (``engine/engine.py:93-99``). The port runs one
process per rank (``parallel.distributed``), each with its own
:class:`~.engine.LLMEngine` over its shard of the weights and its slice of
the KV pool, and the ranks must enter the same computations in the same
order, or their collectives pair up wrongly. This module keeps them in
step, under the contract the reference states for several controllers
(``serve/multihost.py:12-24``): every rank runs the same engine, its
scheduler included, and a decision that hangs on wall time or on an event
only the leader sees is made by rank 0 and mirrored, never recomputed per
rank.

:class:`StepMirror` is that mirror. Only rank 0's engine takes requests;
each call on it that changes what the ranks compute is broadcast to the
other ranks before it runs, in call order, over the group's gloo control
group (host objects: no device collective, so async decode keeps its
one-step lookahead): a request added (its prompt, ``SamplingParams``,
deadline, QoS tag, fan-out parent and soft prefix; the id it got is
checked on every rank), a cancel, ``warm_executables``, the idle
``finish_pending`` of an in-flight step, and each ``step()`` with rank 0's
clock at its start, against which every rank judges the step's deadlines.
The followers (:func:`follow`) apply the calls in order. Sampling stays in
step by construction: every rank seeds its generators from
``EngineConfig.seed`` and draws in the same order, and the gathered or
reduced logits carry the same bits on every rank.

Every :data:`CHECK_EVERY` steps, and when rank 0 closes the engine, the ranks
compare a digest of their host state (the requests running and queued,
their tokens, every sequence's block table, every finished request's
tokens): ranks that disagree raise :class:`RankDivergence` together,
rather than decode apart.

:func:`launch_engine` starts ranks 1..tp-1 as follower processes of rank
0's, each loading its shard (``shard_state_dict`` over ``tp_rules``, the
kv heads widened first when tp exceeds them), and returns rank 0's engine;
``engine.close()`` ends them. :func:`rank_engine` builds one rank's engine
where the caller already holds the group (``parallel.distributed.
spawn_ranks``, the tests).
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
import torch.multiprocessing as tmp

from ..core.device import DeviceLike, resolve_device
from ..models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    replicate_kv_heads,
    tp_rules,
)
from ..parallel.distributed import DistGroup, end_rank, init_group
from ..ops.quant import _is_quant_node, quantize_rows, weight_scale
from ..parallel.sharding import shard_state_dict, stream_shard
from .config import EngineConfig
from .engine import LLMEngine
from .types import Finished

log = logging.getLogger(__name__)

#: steps between two digest checks (a gather of one short string over the
#: control group: little beside a step)
CHECK_EVERY = 4


class RankDivergence(RuntimeError):
    """The ranks' host states differ: they would no longer run the same
    computations."""


class StepMirror:
    """Rank ``group.rank``'s side of the mirror (module note): rank 0
    broadcasts its calls (:meth:`record`, :meth:`step_clock`), the others
    receive them (:meth:`receive`); every rank checks the digest."""

    def __init__(self, group: DistGroup):
        self.group = group
        self.leader = group.rank == 0
        #: steps run, digest checks passed
        self.steps = 0
        self.checks = 0
        #: rank 0's clock for the follower's current step
        self.now = 0.0
        self._finished = hashlib.blake2b(digest_size=16)
        #: the follower processes :func:`launch_engine` started (rank 0)
        self.followers: List[Any] = []
        self._tmp: Optional[str] = None
        self.closed = False
        #: :func:`launch_engine`'s seconds (rank 0): ``{"seconds": s,
        #: "ranks": [each rank's {"group": s, "engine": s}]}``, the time to
        #: join the group and to build the rank's engine
        self.boot: Dict[str, Any] = {}

    def record(self, kind: str, *payload) -> None:
        """Rank 0: send one call to the followers before it runs (a no-op
        on a follower, whose calls come from :func:`follow`)."""
        if self.leader:
            self.group.broadcast((kind,) + payload)

    def receive(self) -> tuple:
        """A follower: rank 0's next call (waits while rank 0 idles)."""
        return self.group.broadcast(None)

    def step_clock(self, now: float) -> float:
        """The clock of the step about to run: rank 0 sends its own, a
        follower reads the one :func:`follow` received with the step."""
        if self.leader:
            self.record("step", now)
            return now
        return self.now

    def after_step(self, engine: LLMEngine, done: List[Finished]) -> None:
        self.steps += 1
        for f in done:
            self._finished.update(
                repr((f.req_id, f.token_ids, f.stop_reason)).encode())
        if self.steps % CHECK_EVERY == 0:
            self.check(engine)

    def digest(self, engine: LLMEngine) -> str:
        """This rank's host state: the finished requests so far, the
        running slots (id, tokens, pending token, chunk cursor), the queue,
        every sequence's blocks, the allocator's free count and the leaked
        blocks."""
        h = self._finished.copy()
        slots = [None if s is None else
                 (s.req.req_id, list(s.generated), s.pending_token,
                  s.prefill_cursor) for s in engine.slots]
        seqs = sorted((sid, list(engine.cache.seq(sid).blocks))
                      for sid in engine.cache.active)
        h.update(repr((self.steps, slots,
                       [r.req_id for r in engine.waiting], seqs,
                       engine.cache.allocator.n_free,
                       engine.cache.leaked_blocks)).encode())
        return h.hexdigest()

    def check(self, engine: LLMEngine) -> None:
        """Compare every rank's :meth:`digest`; raises
        :class:`RankDivergence` on every rank when any differs."""
        digests = self.group.gather_objects(self.digest(engine))
        if any(d != digests[0] for d in digests):
            raise RankDivergence(
                f"rank {self.group.rank}: the ranks' states differ after "
                f"step {self.steps}: digests {digests}")
        self.checks += 1

    def close(self, engine: LLMEngine, timeout_s: float = 60.0) -> None:
        """Rank 0: stop the followers (a last digest check), and end the
        processes :func:`launch_engine` started and their group."""
        if not self.leader or self.closed:
            return
        self.closed = True
        try:
            engine.finish_pending()
            self.record("stop")
            self.check(engine)
        finally:
            for p in self.followers:
                p.join(timeout_s)
            stuck = [p for p in self.followers if p.is_alive()]
            for p in stuck:
                p.kill()
                p.join(5.0)
            if self.followers:
                self.group.close()
            if self._tmp is not None:
                shutil.rmtree(self._tmp, ignore_errors=True)
        bad = [p.exitcode for p in self.followers if p.exitcode != 0]
        if stuck or bad:
            raise RuntimeError(f"follower ranks ended badly: exit codes "
                               f"{[p.exitcode for p in self.followers]}")


def follow(engine: LLMEngine) -> List[Finished]:
    """A follower rank's loop: apply rank 0's calls in order until it
    closes, and return every request this rank finished (rank 0's
    ``Finished`` objects carry the same ids and tokens)."""
    mirror = engine.mirror
    if mirror is None or mirror.leader:
        raise ValueError("follow() runs on a follower rank's engine")
    done: List[Finished] = []
    while True:
        kind, *payload = mirror.receive()
        if kind == "step":
            mirror.now = payload[0]
            done.extend(engine.step())
        elif kind == "add":
            rid, kw = payload
            got = engine.add_request(**kw)
            if got != rid:
                raise RankDivergence(f"rank {mirror.group.rank} queued "
                                     f"request {got} where rank 0 queued "
                                     f"{rid}")
        elif kind == "cancel":
            fin = engine.cancel(payload[0])
            if fin is not None:
                done.append(fin)
        elif kind == "finish_pending":
            engine.finish_pending()
        elif kind == "warm":
            engine.warm_executables(payload[0])
        elif kind == "stop":
            mirror.check(engine)
            return done
        else:
            raise ValueError(f"unknown mirrored call {kind!r}")


def rank_state(model_cfg: LlamaConfig, state: Mapping[str, torch.Tensor],
               group: DistGroup, device: DeviceLike = None):
    """``(cfg, shard)``: the rank's shard of the whole model's ``state`` on
    ``device``, its kv heads first widened to tp when tp exceeds them (the
    reference unit's ``replicate_kv_heads``); ``cfg`` is the widened
    config. Rank 0's replicated entries are ``state``'s own tensors (at
    tp=1 its whole shard is), a follower's are copies."""
    cfg, shard = stream_rank_state(model_cfg, state.items(), group.size,
                                   group.rank, resolve_device(device))
    if group.rank:
        # a follower's shard owns its storage: a replicated entry already
        # on the device is still rank 0's tensor (through CUDA IPC or
        # shared memory)
        shard = {k: v.clone() if v.data_ptr() == state[k].data_ptr() else v
                 for k, v in shard.items()}
    return cfg, shard


def stream_rank_state(model_cfg: LlamaConfig,
                      items: Iterable[Tuple[str, torch.Tensor]], tp: int,
                      rank: int, device: DeviceLike,
                      quantize: bool = False):
    """``(cfg, shard)``: rank ``rank`` of ``tp``'s shard on ``device`` of
    the whole model's state, taken from ``items`` (its ``(name, tensor)``
    entries, read one at a time, for a rank of several on the CPU). Each
    entry's kv heads are widened to tp where tp exceeds them, and it is
    sliced; only the slice reaches ``device``, and the whole entry is let
    go before the next is read, so no process holds the whole model: the
    device its shard, the host one entry at a time. Under ``quantize`` a
    projection's per-row scale is taken from the whole entry where it
    lies, and its slice is quantized on ``device`` (the bits of
    ``quantize_state_dict`` on the whole). ``cfg`` is the widened config
    (:func:`rank_state`'s)."""
    rules = tp_rules()
    cfg = replicate_kv_heads({}, model_cfg, tp)[1]
    shard: Dict[str, torch.Tensor] = {}
    for name, t in items:
        piece = replicate_kv_heads({name: t}, model_cfg, tp)[0]
        del t
        if not (quantize and _is_quant_node(name, piece[name])):
            # dense: an entry may be one element broadcast to its shape
            # (``models.llama.geometry_items``)
            shard.update(stream_shard(piece.items(), rules, tp, rank, device))
            continue
        stem = name[: -len(".weight")]
        w = piece.pop(name)
        # the float weight travels under its int8 name, so that it is
        # sliced as the int8 weight is
        part = shard_state_dict({f"{stem}.weight_q": w,
                                 f"{stem}.scale": weight_scale(w)},
                                rules, tp, rank, device=device)
        del w
        part[f"{stem}.weight_q"] = quantize_rows(part[f"{stem}.weight_q"],
                                                 part[f"{stem}.scale"])
        shard.update(part)
    return cfg, shard


def rank_engine(model_cfg: LlamaConfig, state: Mapping[str, torch.Tensor],
                ecfg: EngineConfig, group: DistGroup,
                device: DeviceLike = None) -> LLMEngine:
    """One rank's engine over its shard of the whole model's ``state``,
    with its :class:`StepMirror` attached: rank 0's takes requests, the
    others run :func:`follow`."""
    device = resolve_device(device)
    cfg, shard = rank_state(model_cfg, state, group, device)
    model = LlamaForCausalLM.from_state_dict(cfg, shard, group=group)
    engine = LLMEngine(cfg, model, ecfg, device=device, group=group)
    engine.mirror = StepMirror(group)
    return engine


def _rank_devices(backend: str, tp: int, device: torch.device
                  ) -> List[torch.device]:
    """Each rank's device: NCCL's rank ``r`` the ``r``-th card from rank
    0's; a gloo group's ranks all on rank 0's device (the CPU, or ranks
    sharing one card)."""
    if backend == "nccl":
        base = device.index or 0
        return [torch.device("cuda", base + r) for r in range(tp)]
    return [device] * tp


def _follower_main(rank: int, tp: int, backend: str, init_file: str,
                   device: str, model_cfg: LlamaConfig, state, ecfg,
                   env: Dict[str, str], timeout_s: float) -> None:
    """A follower process of :func:`launch_engine`: rank 0's ``SHAI_*``
    switches, the group, the rank's engine, then :func:`follow` until rank
    0 closes."""
    for k in [k for k in os.environ if k.startswith("SHAI_")]:
        del os.environ[k]
    os.environ.update(env)
    t0 = time.monotonic()
    group = init_group(tp, rank, init_file, backend, device, timeout_s)
    try:
        t1 = time.monotonic()
        engine = rank_engine(model_cfg, state, ecfg, group, device)
        # drop rank 0's tensors (the process object holds this dict too):
        # a CUDA IPC tensor kept to the exit leaves rank 0's blocks marked
        # in use by this process
        state.clear()
        group.gather_objects({"group": t1 - t0,
                              "engine": time.monotonic() - t1})
        follow(engine)
    except BaseException:
        group.close()
        raise
    end_rank(group)


def launch_engine(model_cfg: LlamaConfig, state: Mapping[str, torch.Tensor],
                  ecfg: EngineConfig, tp: int, backend: str = "nccl",
                  device: DeviceLike = None, timeout_s: float = 600.0
                  ) -> LLMEngine:
    """Rank 0's engine of a ``tp``-rank group, with ranks 1..tp-1 started
    as follower processes (``spawn``). ``state``: the whole model's state
    dict (bf16, or int8 from ``ops.quant.quantize_state_dict``); each rank
    loads its shard onto its device, and ``state`` may be dropped once
    this returns (CUDA tensors reach the followers through CUDA IPC). The
    ranks take rank 0's ``SHAI_*`` switches. ``device``: rank 0's (the
    card unless the caller asks for the CPU); NCCL ranks take the next
    cards, gloo ranks rank 0's device. ``timeout_s`` bounds the group's
    collectives. Use the engine through ``generate``,
    ``add_request``/``step`` or ``EngineLoop``; ``engine.close()`` ends
    the followers."""
    if ecfg.tensor_parallel_size != tp:
        raise ValueError(f"launch_engine tp={tp} but the EngineConfig has "
                         f"tensor_parallel_size="
                         f"{ecfg.tensor_parallel_size}")
    device = resolve_device(device)
    devices = _rank_devices(backend, tp, device)
    tmpdir = tempfile.mkdtemp(prefix="shai-tp-")
    init_file = os.path.join(tmpdir, "store")
    env = {k: v for k, v in os.environ.items() if k.startswith("SHAI_")}
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_follower_main, name=f"tp-rank-{r}",
                         args=(r, tp, backend, init_file, str(devices[r]),
                               model_cfg, state, ecfg, env, timeout_s),
                         daemon=True)
             for r in range(1, tp)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    try:
        group = init_group(tp, 0, init_file, backend, devices[0], timeout_s)
        t1 = time.monotonic()
        engine = rank_engine(model_cfg, state, ecfg, group, devices[0])
        t2 = time.monotonic()
        ranks = group.gather_objects({"group": t1 - t0, "engine": t2 - t1})
    except BaseException:
        for p in procs:
            p.kill()
            p.join(5.0)
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    engine.mirror.followers = procs
    engine.mirror._tmp = tmpdir
    engine.mirror.boot = {"seconds": time.monotonic() - t0, "ranks": ranks}
    log.info("engine over %d ranks (%s), followers %s: %s", tp, backend,
             [p.pid for p in procs], engine.mirror.boot)
    return engine


__all__ = ["CHECK_EVERY", "RankDivergence", "StepMirror", "follow",
           "launch_engine", "rank_engine", "rank_state",
           "stream_rank_state"]
