"""The tp ranks of one model as threads of one process on one device.

The JAX package tests its tensor-parallel plan on 8 virtual CPU devices
(``tests/conftest.py``), where XLA inserts the collectives. The port's
rank-local modules call the collectives themselves, through a group object
with ``size``, ``rank``, ``all_reduce`` and ``all_gather``.
:class:`LoopbackGroup` is that object for ranks that share one device, and
a ``torch.distributed`` group takes its place without a change to the
model code.

Each rank is a thread (:func:`run_ranks`), and the ranks take turns: one
rank runs at a time, in rank order, and hands the turn to the next rank at
each collective, after depositing its tensor in its slot of that
collective. When the turn comes back to a rank, every rank has deposited,
and the rank combines the slots in rank order (a bf16 sum stays in bf16,
as NCCL's does; every rank gets the same bits). Two sets of slots
alternate between consecutive collectives: no rank deposits into a set
before every rank has combined what it held. Taking turns, rather than a
barrier that lets all ranks run at once, keeps the threads from
contending for the interpreter lock (which every PyTorch call releases
and retakes): on one H100, ``chip_smoke.py``'s ``tp_plan`` run of
Llama-3-8B at tp=8 (a prefill and 16 decode steps) took 27.7 s with a
barrier and 7.9 s taking turns.

Every rank launches on the caller's CUDA stream (:func:`run_ranks` sets it
in each thread; ``torch.cuda.current_stream()`` is per thread), so a
partial is written before any rank's combine reads it. The turn is a host
wait, which no CUDA graph can capture: a rank-local forward over this
group runs eagerly.
"""

from __future__ import annotations

import _thread
import threading
from typing import Any, Callable, List, Optional

import torch


#: the longest a rank waits for its turn, in seconds (a rank that never
#: hands the turn on fails the run instead of hanging it)
TURN_TIMEOUT_S = 600.0


class LoopbackGroup:
    """A group of ``size`` ranks, each a thread started by
    :func:`run_ranks`; ``rank`` is the calling thread's."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"group size must be >= 1, got {size}")
        self.size = size
        # rank r may run while it holds _turn[r]; the others wait on theirs
        self._turn = [_thread.allocate_lock() for _ in range(size)]
        for lock in self._turn:
            lock.acquire()
        self._slots: List[List[Optional[torch.Tensor]]] = [
            [None] * size, [None] * size]
        self._calls = [0] * size
        self._done = [False] * size
        self._broken = False
        self._local = threading.local()

    @property
    def rank(self) -> int:
        rank = getattr(self._local, "rank", None)
        if rank is None:
            raise RuntimeError("not a rank of this group: start the ranks "
                               "with parallel.loopback.run_ranks")
        return rank

    def _wait_turn(self, rank: int) -> None:
        if not self._turn[rank].acquire(timeout=TURN_TIMEOUT_S):
            raise TimeoutError(f"rank {rank} waited {TURN_TIMEOUT_S} s for "
                               f"its turn")
        if self._broken:
            raise threading.BrokenBarrierError(
                f"rank {rank}: another rank of the group failed")

    def _pass_turn(self, rank: int) -> None:
        """Hand the turn to the next rank that has not finished."""
        for step in range(1, self.size):
            nxt = (rank + step) % self.size
            if not self._done[nxt]:
                self._turn[nxt].release()
                return

    def _exchange(self, t: torch.Tensor,
                  combine: Callable[[List[torch.Tensor]], torch.Tensor]
                  ) -> torch.Tensor:
        if self.size == 1:
            return combine([t])
        rank = self.rank
        if any(self._done):
            raise RuntimeError("a collective after a rank of the group "
                               "finished: the ranks must call the same "
                               "collectives")
        slots = self._slots[self._calls[rank] % 2]
        self._calls[rank] += 1
        slots[rank] = t
        self._pass_turn(rank)
        self._wait_turn(rank)
        return combine(list(slots))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t``, in ``t``'s dtype, added in rank
        order (every rank gets the same bits)."""

        def total(ts):
            out = ts[0].clone()
            for other in ts[1:]:
                out += other
            return out

        return self._exchange(t, total)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``t`` concatenated on ``dim`` in rank order."""
        return self._exchange(t, lambda ts: torch.cat(ts, dim=dim))

    def broadcast_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank (a copy of it)."""
        return self._exchange(t, lambda ts: ts[0].clone())

    def abort(self) -> None:
        """Wake every waiting rank with ``threading.BrokenBarrierError``
        (one rank failed)."""
        self._broken = True
        for lock in self._turn:
            if lock.locked():
                lock.release()

    def _reset(self) -> None:
        """A fresh start for :func:`run_ranks`: every turn taken, no rank
        done, no collective called, not broken."""
        for lock in self._turn:
            lock.acquire(blocking=False)
        self._calls = [0] * self.size
        self._done = [False] * self.size
        self._broken = False

    def _run(self, rank: int, fn: Callable[[int], Any]) -> Any:
        """Rank ``rank``'s part of :func:`run_ranks`: wait for its first
        turn (rank 0 holds it at the start), run, hand the turn on."""
        self._local.rank = rank
        if rank:
            self._wait_turn(rank)
        out = fn(rank)
        self._done[rank] = True
        self._pass_turn(rank)
        return out


def run_ranks(fn: Callable[[int], Any], group: LoopbackGroup) -> List[Any]:
    """Run ``fn(rank)`` for every rank of ``group``, each in a thread of its
    own, taking turns (module note), and return the results in rank order.
    Each thread takes the caller's grad mode, inference mode and current
    CUDA stream. If a rank raises, the other ranks stop at their next wait
    and the first rank's exception is raised here."""
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    stream = (torch.cuda.current_stream()
              if torch.cuda.is_available() and torch.cuda.is_initialized()
              else None)
    results: List[Any] = [None] * group.size
    errors: List[Optional[BaseException]] = [None] * group.size
    group._reset()

    def body(rank: int) -> None:
        try:
            with torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad):
                if stream is not None:
                    with torch.cuda.stream(stream):
                        results[rank] = group._run(rank, fn)
                else:
                    results[rank] = group._run(rank, fn)
        except BaseException as e:  # re-raised in the caller below
            errors[rank] = e
            group.abort()

    threads = [threading.Thread(target=body, args=(r,),
                                name=f"tp-rank-{r}", daemon=True)
               for r in range(group.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors
                  if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)),
                 next((e for e in errors if e is not None), None))
    if first is not None:
        raise first
    return results
