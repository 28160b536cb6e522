"""Decode executables: one captured CUDA graph per decode key.

The port's counterpart of the reference's jitted decode executables
(``engine.py:2009-2032`` ``_decode_for``, ``runner.py:780``
``make_decode(feedback=True)``, compiled before readiness by
``engine/warm.py:16``). In eager PyTorch a decode step is some 1,300
launches from Python, and the host's dispatch is the step's time; a
:class:`DecodeGraph` records those launches once and replays them with one
call, so a dispatch costs what the reference's asynchronous executable
launch costs.

One graph per ``_decode_for`` key ``(ctx bucket, batch bucket)`` (ragged:
one context entry, so the key is the batch bucket). Under speculative
decoding a graph of the same class holds each verify key
(``runner.make_verify``, the reference's ``_verify_for`` at
``engine.py:2120``): ``("verify", ctx bucket, batch bucket)``, ``tokens
[Bb, k+1]`` (the pending token and the draft), ``pos`` (each row's
``pos0``), the batch view and knobs, and two sets of uniforms as static
inputs; ``o``, ``oex``, ``accept_p``, ``o_lp``, ``d_lp``, ``oex_lp``,
``top_ids`` and ``top_lp`` as static outputs. Its ``Bb * (k+1)`` attention
rows take split scratch too, so the engine's reservation covers them. Under
``SHAI_FUSED_STEP`` a graph of the same class holds a fused step
(``runner.make_fused_step``): one per batch bucket, and one more bb=1
graph for the engine's chunk-only calls. It owns static inputs
(``tokens``, ``pos``, ``tables``, ``temp``, ``topk``, ``topp`` and the
step's ``uniforms``) and, once captured, static outputs (``nxt``,
``pos_next`` and the logprob readout ``top_ids``, ``top_lp``, ``tok_lp``
of ``runner.token_logprobs``) that every replay overwrites; a fused graph
also has the chunk window as static inputs (``c_ids``, ``c_ntext``,
``c_table``, ``c_start``; the null window until the engine loads one) and
the chunk's raw logits ``c_logits`` as a static output. The readout
is part of every graph: there is one graph per key whether or not a
request asks for logprobs, and the engine copies the readout to the host
only when one does. Both disciplines replay the same graphs: the
lock-step engine fills every input from the host, the async engine feeds
step N's ``nxt``/``pos_next`` back on the device.

Capture (:meth:`DecodeGraph.capture`): the decode function runs once
eagerly on the capture stream (that builds the kernels, sets their
attributes and primes cuBLAS outside the capture), then is captured on
that side stream into the memory pool every graph of the engine shares
(:class:`GraphPool`). The split scratch of B2/B3 is reserved on the capture
stream for the engine's largest key before the first capture, and a
capture that would grow it raises. Python's garbage collector is run before
and held off during a capture: a collection inside it could destroy a dead
engine's graphs, and a graph's reset is not permitted while a stream
captures (it invalidates the capture). A failed capture raises; nothing
turns graphs off. The captured graph holds the addresses of the weights and the
KV pool, which the runner writes in place; each replay checks that the
pool's tensors are still the ones captured.

An mllama engine's decode and verify graphs also hold the engine's per-slot
cross-KV buffers (``cross_kv``, written in place at admission and checked
on each replay as the pool is) and three more static inputs: ``slot_idx``
(each batch row's slot in the buffers), ``has_image`` (its cross gate) and
``cross_len`` (its valid vision states). Each replay gathers the rows'
buffers by ``slot_idx`` into the graph's pool and runs B1 over them once per
cross layer.

The kernel wrappers count a launch where they launch, which under capture
happens once and never on replay: a graph takes the counts its capture
added off again and adds them on every replay, so the counters stay the
number of kernels that ran.

On the CPU there are no graphs: :meth:`DecodeGraph.replay` runs the same
decode function eagerly on the same static inputs. That is the CPU path of
the tests, not a fallback.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device
from ..ops.cuda import flash_attention as _fa
from ..ops.cuda import int8_matmul as _i8
from ..ops.cuda import paged_attention as _pa
from ..ops.cuda import ragged_paged_attention as _rpa
from .resident import upload

#: the static outputs of a decode step, in the decode function's order
OUTPUTS = ("nxt", "pos_next", "top_ids", "top_lp", "tok_lp")
#: the static outputs of a verify step (``runner.make_verify``), in order
VERIFY_OUTPUTS = ("o", "oex", "accept_p", "o_lp", "d_lp", "oex_lp",
                  "top_ids", "top_lp")
#: the chunk window a fused step takes after the decode inputs, and its
#: extra output
CHUNK_INPUTS = ("c_ids", "c_ntext", "c_table", "c_start")
CHUNK_OUTPUT = "c_logits"

#: the counted kernel launches a decode step may make: (name, wrapper, the
#: wrapper's counter); the W8A16 wrapper counts its decode and its wide
#: instantiation (a fused step's chunk window) apart
COUNTED = (
    ("flash_attention", _fa.flash_attention, "launches"),
    ("paged_decode_attention", _pa.paged_decode_attention, "launches"),
    ("ragged_paged_attention", _rpa.ragged_paged_attention, "launches"),
    ("int8_matmul", _i8.int8_matmul, "launches"),
    ("int8_matmul_wide", _i8.int8_matmul, "wide_launches"),
)


def _launch_counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, attr) for _, fn, attr in COUNTED)


class GraphPool:
    """What the decode graphs of one engine share: one memory pool
    (``torch.cuda.graph_pool_handle()``), one capture stream, and the split
    scratch reserved on that stream. They replay one at a time on the
    engine's stream, and nothing but their static outputs is read after a
    replay, so one graph may reuse memory another freed during its
    capture. On the CPU it holds nothing."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.handle = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        #: ``(fp32 values, counters)`` reserved; None until :meth:`reserve`
        self.reserved: Optional[Tuple[int, int]] = None

    @property
    def stream_id(self) -> int:
        return self.stream.cuda_stream if self.cuda else 0

    def reserve(self, needs) -> None:
        """Reserve the capture stream's split scratch for the largest of
        ``needs`` ``(fp32 values, counters)``, before any capture."""
        numel = max((n for n, _ in needs), default=0)
        counters = max((c for _, c in needs), default=0)
        if self.cuda:
            _rpa.reserve_split_scratch(self.device, self.stream_id, numel,
                                       counters)
        self.reserved = (numel, counters)

    def bytes(self) -> Optional[int]:
        """Bytes the pool's segments hold on the card (from the caching
        allocator's snapshot), or None when the snapshot does not name
        segment pools."""
        if not self.cuda:
            return None
        want = tuple(self.handle)
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) == want:
                total += seg["total_size"]
        return total if named else None


class DecodeGraph:
    """One decode executable: ``decode`` (``runner.make_decode(...,
    feedback=True)``) for ``batch`` rows over ``model`` and the pool
    ``kv``, with static inputs and, after a run or a capture, static
    outputs. ``chunk`` > 0: ``decode`` is ``runner.make_fused_step`` with a
    ``chunk``-token window. ``verify_k`` > 0: ``decode`` is
    ``runner.make_verify`` for ``k = verify_k`` drafts, ``tokens`` is
    ``[batch, k+1]``, ``pos`` each row's ``pos0``, the draws are two sets
    of uniforms (``draws``: ``uniforms [batch, k+1, V]`` for the target
    sample, then ``[batch, k, V]`` for the rejection resample) and the
    outputs are :data:`VERIFY_OUTPUTS`. ``device`` defaults to the card;
    ``"cpu"`` runs eagerly."""

    def __init__(self, key, decode: Callable, model, kv, batch: int,
                 blocks_per_seq: int, vocab_size: int,
                 device: DeviceLike = None,
                 pool: Optional[GraphPool] = None, chunk: int = 0,
                 verify_k: int = 0, cross_kv=None, cross_text_len: int = 1):
        self.device = resolve_device(device)
        self.key = key
        self.decode = decode
        self.model = model
        self.kv = kv
        #: an mllama engine's per-slot cross-KV buffers (None: text)
        self.cross_kv = cross_kv
        self.pool = pool if pool is not None else GraphPool(self.device)
        dev = self.device
        with torch.inference_mode(False):
            def i32(*shape):
                return torch.zeros(shape, dtype=torch.int32, device=dev)

            def f32(value, *shape):
                return torch.full(shape, value, dtype=torch.float32,
                                  device=dev)

            # padding rows: null tables (block 0), greedy-neutral knobs
            self.inputs: Dict[str, torch.Tensor] = {
                "tokens": (i32(batch, verify_k + 1) if verify_k
                           else i32(batch)),
                "pos": i32(batch),
                "tables": i32(batch, blocks_per_seq),
                "temp": f32(1.0, batch), "topk": i32(batch),
                "topp": f32(1.0, batch)}
            if cross_kv is not None:
                # padding rows: slot 0 under a zero gate, the engine's
                # text-row cross_len
                self.inputs.update(
                    slot_idx=i32(batch), has_image=f32(0.0, batch),
                    cross_len=i32(batch) + cross_text_len)
            if chunk:
                # the null window: zero ids over null block 0, one token
                self.inputs.update(
                    c_ids=i32(1, chunk), c_ntext=i32(1) + 1,
                    c_table=i32(1, blocks_per_seq), c_start=i32(1))
            if verify_k:
                self.uniforms = f32(0.5, batch, verify_k + 1, vocab_size)
                self.draws: Tuple[torch.Tensor, ...] = (
                    self.uniforms, f32(0.5, batch, verify_k, vocab_size))
            else:
                self.uniforms = f32(0.5, batch, vocab_size)
                self.draws = (self.uniforms,)
        self.chunk = chunk
        self.verify_k = verify_k
        if verify_k:
            self.outputs = VERIFY_OUTPUTS
            for name in VERIFY_OUTPUTS:
                setattr(self, name, None)
        else:
            self.outputs = OUTPUTS + ((CHUNK_OUTPUT,) if chunk else ())
        #: a chunk window is loaded (False: the null window)
        self.window = False
        self.c_logits: Optional[torch.Tensor] = None
        self.nxt: Optional[torch.Tensor] = None
        self.pos_next: Optional[torch.Tensor] = None
        self.top_ids: Optional[torch.Tensor] = None
        self.top_lp: Optional[torch.Tensor] = None
        self.tok_lp: Optional[torch.Tensor] = None
        #: kernel launches one replay makes, per counted wrapper
        self.launches: Dict[str, int] = {}
        self._counted: Tuple[Tuple[Callable, int], ...] = ()
        self.replays = 0
        self.capture_seconds = 0.0
        self._graph = None
        self._ptrs: Tuple[Tuple[int, ...], ...] = ((), ())

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def _pool_ptrs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """The addresses of the KV pool's tensors and of the cross
        buffers'."""
        return tuple(tuple(t.data_ptr() for lay in bufs
                           for t in lay.values())
                     for bufs in (self.kv, self.cross_kv or ()))

    def eager(self) -> Tuple[torch.Tensor, ...]:
        """One eager call of the decode function on the static inputs, on
        the current stream: the graph's outputs, fresh tensors."""
        a = self.inputs
        window = [a[name] for name in CHUNK_INPUTS] if self.chunk else []
        rng = self.draws if self.verify_k else self.uniforms
        kw = {}
        if self.cross_kv is not None:
            kw["cross"] = (self.cross_kv, a["has_image"], a["slot_idx"],
                           a["cross_len"])
        with torch.inference_mode():
            _, *outs = self.decode(
                self.model, self.kv, a["tokens"], a["pos"], a["tables"],
                rng, a["temp"], a["topk"], a["topp"], *window, **kw)
        return tuple(outs)

    def _set_outputs(self, outs) -> None:
        for name, t in zip(self.outputs, outs, strict=True):
            setattr(self, name, t)

    def load_window(self, window) -> None:
        """Load a fused graph's chunk window before a replay: ``(ids [1,
        C], n_text, table [1, M], start)`` as host arrays and ints, or
        None for the null window (written only when a window was
        loaded)."""
        a = self.inputs
        if window is None:
            if self.window:
                for name in CHUNK_INPUTS:
                    a[name].zero_()
                a["c_ntext"].fill_(1)
                self.window = False
            return
        ids, n_text, table, start = window
        upload(a["c_ids"], ids)
        upload(a["c_table"], table)
        upload(a["c_ntext"], np.asarray([n_text], np.int32))
        upload(a["c_start"], np.asarray([start], np.int32))
        self.window = True

    def capture(self) -> None:
        """Capture the step (CUDA); a no-op on the CPU. Raises when the
        capture fails."""
        if not self.pool.cuda or self.captured:
            return
        if self.pool.reserved is None:
            raise RuntimeError("reserve the pool's split scratch for the "
                               "largest key before the first capture")
        dev = self.device
        stream = self.pool.stream
        torch.cuda.synchronize(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with _rpa.frozen_scratch(), torch.cuda.stream(stream):
            self.eager()   # kernels built, attributes set, cuBLAS primed
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        gc.collect()   # dead engines' graphs go now, outside any capture
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with _rpa.frozen_scratch(), torch.cuda.graph(
                    graph, pool=self.pool.handle, stream=stream,
                    capture_error_mode="thread_local"):
                outs = self.eager()
        finally:
            if collecting:
                gc.enable()
            # capture launched nothing: the counts it added come off here
            # and go back on at every replay
            added = [now - was for now, was in zip(_launch_counts(), before)]
            for (_, fn, attr), was in zip(COUNTED, before):
                setattr(fn, attr, was)
        self.capture_seconds = time.perf_counter() - t0
        self._set_outputs(outs)
        self._counted = tuple((entry, n) for entry, n in zip(COUNTED, added)
                              if n)
        self.launches = {name: n for (name, _, _), n in self._counted}
        self._ptrs = self._pool_ptrs()
        self._graph = graph

    def feed(self, tokens: torch.Tensor, pos: torch.Tensor) -> None:
        """Copy the previous step's device outputs into this graph's
        ``tokens`` and ``pos`` (device to device, on the stream)."""
        self.inputs["tokens"].copy_(tokens)
        self.inputs["pos"].copy_(pos)

    def draw(self, generator: torch.Generator) -> None:
        """The step's uniforms, fresh from ``generator`` (one eager launch
        per set before the replay: a replay alone would reuse the last
        draws); a verify graph's target set first, then its resample set."""
        for u in self.draws:
            u.uniform_(0.0, 1.0, generator=generator)

    def replay(self) -> None:
        """Run the step on the current stream: the graph on CUDA, the
        decode function eagerly on the CPU."""
        if self._graph is None:
            if self.pool.cuda:
                raise RuntimeError(f"decode graph {self.key} was never "
                                   f"captured")
            self._set_outputs(self.eager())
        else:
            pool, cross = self._pool_ptrs()
            if pool != self._ptrs[0]:
                raise RuntimeError(f"decode graph {self.key}: the KV pool "
                                   f"moved since capture")
            if cross != self._ptrs[1]:
                raise RuntimeError(f"decode graph {self.key}: the cross "
                                   f"buffers moved since capture")
            self._graph.replay()
            for (_, fn, attr), n in self._counted:
                setattr(fn, attr, getattr(fn, attr) + n)
        self.replays += 1
