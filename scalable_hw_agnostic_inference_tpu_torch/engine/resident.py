"""Device-resident decode batch state and the in-flight lookahead record.

Port of ``scalable_hw_agnostic_inference_tpu/engine/resident.py``
(``composition_sig``, ``InflightStep``, ``ResidentBatch``). The lock-step
loop re-marshals the whole batch view host to device every step, then
blocks on the sampled tokens before its host bookkeeping. The async
pipeline (``SHAI_ASYNC_DECODE``) removes both halves:

* :class:`ResidentBatch` keeps the composition-dependent inputs (``tables``,
  ``temp``, ``topk``, ``topp``, and an mllama engine's ``slot_idx``,
  ``has_image`` and ``cross_len``) on the device for decode and speculative
  verify alike (the reference's ``resident.py:15``: a verify graph is one
  more graph it feeds), keyed by a composition signature: they are
  uploaded again only when the signature changes (join, finish,
  preemption) or the decode graph they feed changes, and
  block-table growth alone uploads only ``tables``. They live in the static
  input buffers of the :class:`~.graphs.DecodeGraph` they feed: a refresh
  copies into those tensors and never replaces them, since a captured
  graph reads the addresses it was captured with.

* :class:`InflightStep` records one dispatched, not yet retired decode
  step. Its ``nxt`` and ``pos_next`` are the graph's static outputs, which
  the next replay of that graph overwrites; the pipeline dispatches step
  N+1 (feeding it ``nxt`` and ``pos_next`` on the device) before it
  retires step N, so each dispatch also copies its tokens into a host
  buffer of its own and records an event, and retiring waits on that
  event only. When a running request asked for logprobs (``want_lp``,
  reference ``engine.py:1024``), the same dispatch copies the graph's
  logprob readout (``top_ids``, ``top_lp``, ``tok_lp``) into host buffers
  of its own behind the same event.

Host uploads go through pinned staging buffers from PyTorch's caching
host allocator: each refresh takes a fresh one, and the allocator does
not hand a block out again until the copy recorded on it has completed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def composition_sig(running, Bb: int) -> Tuple:
    """Identity of the compacted batch view: which request sits in which
    batch row (and slot), at which batch bucket. Sampling knobs and the
    cross tail are per-request constants, so the ``req_id`` entries cover
    them; block
    growth and reassignment are tracked separately (``blocks``)."""
    return (tuple((s.req.req_id, s.slot) for s in running), Bb)


def upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """Copy host ``src`` into the front rows of the device tensor ``dst``
    in place: through a pinned staging buffer, without blocking, on CUDA;
    a plain copy on the CPU."""
    host = torch.from_numpy(np.ascontiguousarray(src))
    dst = dst[:host.shape[0]]
    if dst.device.type == "cuda":
        dst.copy_(host.pin_memory(), non_blocking=True)
    else:
        dst.copy_(host)


@dataclasses.dataclass
class InflightStep:
    """One dispatched decode step awaiting retirement (host readback)."""

    sig: Tuple
    running: List[Any]                # _Running snapshot, batch-row order
    nxt: torch.Tensor                 # device [Bb] sampled tokens (feedback)
    pos_next: torch.Tensor            # device [Bb] pos + 1 (feedback)
    host: torch.Tensor                # [Bb] host copy of nxt, own buffer
    # host copies of (top_ids [Bb, K], top_lp [Bb, K], tok_lp [Bb]), own
    # buffers; None when no running request asked for logprobs
    lp_host: Optional[Tuple[torch.Tensor, ...]]
    event: Optional[Any]              # CUDA event after the copies (None: CPU)
    t_dispatch: float                 # monotonic enqueue stamp (gap metric)

    @property
    def want_lp(self) -> bool:
        return self.lp_host is not None

    def fetch(self):
        """The step's sampled tokens and, when ``want_lp``, its logprob
        readout on the host: ``(nxt, top_ids, top_lp, tok_lp)`` as numpy
        (the last three None otherwise). Waits for this step's copies
        only, never for a later dispatch."""
        if self.event is not None:
            self.event.synchronize()
        if self.lp_host is None:
            return self.host.numpy(), None, None, None
        return (self.host.numpy(),) + tuple(t.numpy() for t in self.lp_host)


class ResidentBatch:
    """Composition-keyed device mirror of the decode batch inputs, held in
    the static inputs of the decode graph it last fed."""

    def __init__(self) -> None:
        self.invalidate()

    def invalidate(self) -> None:
        self.sig: Optional[Tuple] = None
        self.target: Any = None
        self.blocks: Tuple[Tuple[int, ...], ...] = ()

    def refresh(self, engine, running, Bb: int, graph) -> Dict[str, Any]:
        """Load ``running``, compacted into ``Bb`` rows, into ``graph``'s
        static inputs; return them.

        Same composition and same graph: nothing moves, unless some row's
        block LIST changed since the last marshal, and then only
        ``tables``. Staleness is keyed on the block IDENTITIES, not counts:
        the allocator's free list is LIFO, so a shrink-then-regrow cycle
        (speculative rollback) can hand two slots each other's freed
        blocks with every per-row count unchanged, and a count key would
        reuse tables that point rows at the wrong physical blocks.
        Otherwise one full host marshal (the engine's lock-step
        ``_marshal_running``) is uploaded.
        """
        sig = composition_sig(running, Bb)
        blocks = tuple(tuple(engine.cache.seq(s.req.req_id).blocks)
                       for s in running)
        inputs = graph.inputs
        if sig == self.sig and graph is self.target:
            if blocks != self.blocks:
                M = engine.ecfg.blocks_per_seq
                tables = np.zeros((Bb, M), np.int32)
                for i, s in enumerate(running):
                    tables[i] = engine.cache.seq(s.req.req_id).table(M)
                upload(inputs["tables"], tables)
                self.blocks = blocks
            return inputs
        host = engine._marshal_running(running, Bb)
        for name, arr in host.items():
            upload(inputs[name], arr)
        self.sig = sig
        self.target = graph
        self.blocks = blocks
        return inputs
