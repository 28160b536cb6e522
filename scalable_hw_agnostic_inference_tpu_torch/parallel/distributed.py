"""The tp ranks of one model as processes of a ``torch.distributed`` group.

The JAX package needs no such module: its ranks are the devices of one
mesh, and XLA inserts the collectives. The port's rank-local modules
(``models/llama.py``) call them through a group object with ``size``,
``rank``, ``all_reduce(t)``, ``all_gather(t, dim)`` and
``broadcast_tensor(t)`` (rank 0's tensor on every rank);
``parallel.loopback.LoopbackGroup`` is that object for threads sharing one
device, and :class:`DistGroup` is it for one process per rank.

The transport follows the backend's name, and nothing else: NCCL sums and
gathers CUDA tensors on the card (and a CUDA graph can capture its calls:
``capturable``); gloo sums and gathers CPU tensors, and a CUDA tensor given
to a gloo group (two ranks sharing one card, which NCCL refuses) is copied
to host memory, reduced there and copied back, here, in plain sight. A
failed collective raises; no call switches transport.

Beside the compute group, every :class:`DistGroup` holds a gloo group of
the same ranks for control messages (``engine/ranks.py``'s step mirror):
host objects, broadcast and gathered over TCP, never a device collective.
Its timeout is long, since a follower rank waits in it while the leader
idles; ``serve.multihost`` bounds its own waits there with the leader's
beat.

:func:`init_group` joins a group through a ``FileStore`` (a file path: no
port to pick, so concurrent test workers cannot collide) or, for ranks on
several hosts, a ``TCPStore`` that rank 0 serves at ``tcp://host:port``
(the unit's ``SHAI_COORDINATOR``). The compute group's timeout bounds how
long a rank waits in a collective for a peer that never comes (a rank
that died, or a leader left alone by a dropped mirror): the collective
then raises. :func:`spawn_ranks` runs a function on every rank of a fresh
group, each in a process of its own (the ``spawn`` start method),
returning the ranks' results; a rank that raises fails the call with that
rank's traceback, and ranks that do not finish are killed at the timeout.

A spawned rank ends through :func:`end_rank`: it leaves its group, flushes
its streams and exits through ``os._exit``. A rank that returned into the
interpreter's own teardown instead ran C++ destructors beside threads that
were still alive, and under load one such teardown aborted (SIGABRT, exit
code -6, ``terminate called without an active exception``).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, NoReturn, Optional, Sequence

import torch
import torch.distributed as dist

#: how long a control-group wait may last (a follower rank waits here for
#: as long as the leader stays idle)
CONTROL_TIMEOUT = timedelta(days=7)

#: the gather into one flat output (``all_gather_into_tensor`` before
#: PyTorch named it ``all_gather_single``)
_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class DistGroup:
    """One rank's handle on a ``torch.distributed`` group of ``size``
    ranks: the interface of ``parallel.loopback.LoopbackGroup`` over the
    process group ``pg`` of ``backend``, and a gloo ``control`` group of
    the same ranks. ``device``: the rank's device (its tensors' home)."""

    def __init__(self, pg, control, size: int, rank: int, backend: str,
                 device: torch.device):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be nccl or gloo, got "
                             f"{backend!r}")
        self.pg, self.control = pg, control
        self.size, self.rank = size, rank
        self.backend = backend
        self.device = device
        #: a CUDA graph may capture this group's collectives (NCCL); a
        #: gloo group's host staging cannot be captured
        self.capturable = backend == "nccl"

    def __repr__(self) -> str:
        return (f"DistGroup(rank={self.rank}, size={self.size}, "
                f"backend={self.backend}, device={self.device})")

    def _staged(self, t: torch.Tensor) -> bool:
        """A gloo group given a CUDA tensor goes through host memory."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t``, in ``t``'s dtype (every rank
        gets the same bits). ``t`` is reduced in place and returned; a gloo
        group's CUDA tensor returns as a new tensor on its device."""
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, group=self.pg)
            return host.to(t.device)
        dist.all_reduce(t, group=self.pg)
        return t

    def broadcast_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, over the compute group (each rank
        passes a tensor of the same shape and dtype; a follower's values
        are overwritten). A gloo group's CUDA tensor returns as a new
        tensor on its device."""
        if self.size == 1:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.broadcast(host, 0, group=self.pg)
            return host.to(t.device)
        dist.broadcast(t, 0, group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` concatenated on ``dim`` in rank order."""
        if self.size == 1:
            return t
        src = t.contiguous()
        staged = self._staged(src)
        if staged:
            src = src.cpu()
        flat = torch.empty((self.size * src.numel(),), dtype=src.dtype,
                           device=src.device)
        _gather_flat(flat, src.reshape(-1), group=self.pg)
        d = dim % src.dim()
        out = flat.view(self.size, *src.shape).movedim(0, d)
        shape = list(src.shape)
        shape[d] *= self.size
        out = out.reshape(shape)
        return out.to(t.device) if staged else out

    # -- the control group: host objects ------------------------------------

    def broadcast(self, obj: Any = None) -> Any:
        """Rank 0's ``obj``, on every rank (over the control group)."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def close(self) -> None:
        """Leave the group (destroys this process's default group)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def end_rank(group: Optional[DistGroup], code: int = 0,
             fail_code: int = 1) -> NoReturn:
    """End a spawned rank's process once its last collective has
    returned: leave ``group`` (its compute and control groups), flush the
    logging handlers and the standard streams, and exit with ``code``
    through ``os._exit`` (``fail_code`` if leaving the group raised). No
    interpreter teardown runs, so no C++ destructor meets a live transport
    or timer thread."""
    try:
        if group is not None:
            group.close()
    except BaseException:
        traceback.print_exc()
        code = fail_code
    logging.shutdown()
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):
            pass
    os._exit(code)


def _store(init: str, tp: int, rank: int, timeout: timedelta):
    """``tcp://host:port``: a ``TCPStore`` served there by rank 0 (bound on
    every interface of its host) and joined by the others; anything else:
    the ``FileStore`` at that path."""
    if not init.startswith("tcp://"):
        return dist.FileStore(init, tp)
    host, _, port = init[len("tcp://"):].rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad store address {init!r}; expected "
                         f"tcp://host:port")
    return dist.TCPStore(host, int(port), tp, rank == 0, timeout=timeout)


def init_group(tp: int, rank: int, init_file: str, backend: str,
               device=None, timeout_s: float = 600.0) -> DistGroup:
    """Join rank ``rank`` of a ``tp``-rank group as this process's default
    group, through the store at ``init_file``: a ``FileStore`` path every
    rank names, or ``tcp://host:port``, a ``TCPStore`` that rank 0 serves
    there. ``device``: the rank's device (NCCL: a CUDA device, made
    current here; None is ``cuda:rank``); a gloo group's ranks may hold
    CUDA tensors or CPU tensors (None: the CPU). ``timeout_s`` bounds the
    store's rendezvous and every collective of the compute group. One
    small collective runs before returning, so a transport that cannot
    start fails here, not inside the first forward."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp={tp}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL group needs CUDA")
        device = torch.device(device if device is not None
                              else f"cuda:{rank}")
        torch.cuda.set_device(device)
    elif backend == "gloo":
        device = torch.device(device if device is not None else "cpu")
    else:
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    timeout = timedelta(seconds=timeout_s)
    store = _store(init_file, tp, rank, timeout)
    dist.init_process_group(backend, store=store, world_size=tp, rank=rank,
                            timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    group = DistGroup(dist.group.WORLD, control, tp, rank, backend, device)
    probe = torch.ones((1,), dtype=torch.float32, device=device)
    if float(group.all_reduce(probe).item()) != tp:
        raise RuntimeError(f"{group}: a probe sum over {tp} ranks gave "
                           f"{float(probe.item())}")
    return group


def _rank_main(fn, rank: int, tp: int, backend: str, init_file: str,
               devices, args, results, group_timeout_s: float) -> None:
    """One spawned rank: join the group, run ``fn(group, *args)``, send
    back ``(rank, "ok", pickled result)`` or ``(rank, "error",
    traceback)``. The message is flushed before the rank leaves its group,
    so a failing rank's traceback reaches the parent before its peers see
    the group break."""
    group = None
    try:
        group = init_group(tp, rank, init_file, backend,
                           None if devices is None else devices[rank],
                           group_timeout_s)
        msg = (rank, "ok", pickle.dumps(fn(group, *args)))
    except BaseException:
        msg = (rank, "error", traceback.format_exc())
    results.put(msg)
    results.close()
    results.join_thread()
    end_rank(group)


def spawn_ranks(fn: Callable[..., Any], tp: int, backend: str = "gloo",
                timeout_s: float = 120.0, args: Sequence[Any] = (),
                devices: Optional[Sequence] = None,
                group_timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(group, *args)`` on each of ``tp`` ranks, each a process of
    its own (``spawn``) joined to a fresh :class:`DistGroup` over a
    ``FileStore`` in a temporary directory, and return the results in rank
    order. ``fn`` and ``args`` must pickle by reference (a function at a
    module's top level); results travel pickled by value. ``devices``:
    each rank's device (None: :func:`init_group`'s default).
    ``group_timeout_s``: the group's collective timeout.

    A rank that raises fails the call with a ``RuntimeError`` carrying that
    rank's traceback; the other ranks are killed then. Ranks still running
    after ``timeout_s`` seconds are killed and the call raises
    ``TimeoutError``. No rank outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="shai-ranks-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"tp-rank-{r}",
                         args=(fn, r, tp, backend,
                               os.path.join(tmp, "store"), devices,
                               tuple(args), results, group_timeout_s),
                         daemon=True)
             for r in range(tp)]
    out: List[Any] = [None] * tp
    done = set()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(done) < tp:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(tp)) - done)
                raise TimeoutError(f"ranks {missing} of {tp} did not finish "
                                   f"within {timeout_s} s")
            try:
                rank, status, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead and results.empty():
                    # give a rank's last message a moment to arrive
                    time.sleep(0.2)
                    if results.empty():
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {tp} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
            done.add(rank)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
