"""Device<->host block movers for the KV tier, as torch index moves.

Port of ``scalable_hw_agnostic_inference_tpu/kvtier/restore.py``
(``make_tier_gather`` at ``:32``, ``make_tier_restore`` at ``:53``):

- :func:`make_tier_gather` -- demotion read: one ``index_select`` per
  layer and pool tensor gathers the evicted blocks into a FRESH stacked
  tensor ``[L, n, Bs, Hkv, Dh]`` (and ``[L, n, Hkv]`` for the scale rows
  of an int8 pool), enqueued on the current stream, so it reads the
  blocks before any later work on that stream can re-allocate and write
  them (the reference relies on dispatch order the same way);
- :class:`HostCopy` -- the gathered tensors' copy into pinned (page-locked)
  host memory, non-blocking, with an event recorded after it; the copy-out worker
  waits on that event alone (never on the whole device), and the gathered
  tensors stay referenced until it completes;
- :func:`make_tier_restore` -- the warm-hit write: the host rows staged in
  pinned memory (:func:`staging`), copied to the card, then one IN-PLACE
  ``index_copy_`` per layer and pool tensor. The reference donates the
  pool and rebinds it; here every captured decode and fused graph holds
  the pool tensors' addresses, so a restore that allocated new pool
  tensors would leave the graphs reading stale memory. It runs eagerly,
  outside every capture.

Index vectors are padded to a closed set of sizes (``engine/cache.py``'s
``_PAD_SIZES``); padding rows target reserved block 0, whose contents are
garbage by contract. numpy has no bfloat16, so a bf16 pool moves as its
int16 view: the host holds the raw 16-bit words, and the restore writes
them back through the same view, byte for byte. An int8 pool's blocks and
f32 scale rows move in the same call and come back byte-identical (never
re-quantized).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

def _raw(t: torch.Tensor) -> torch.Tensor:
    """The tensor as the host tier holds it: a bf16 tensor as its int16
    view (the same memory), any other dtype as itself."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _names(quant: bool) -> Tuple[str, ...]:
    return ("k", "v", "ks", "vs") if quant else ("k", "v")


def make_tier_gather(quant: bool = False):
    """Batched demotion gather: ``(kv, idx [n]) -> (k, v[, ks, vs])``, each
    a fresh tensor stacked over the layers, ``[n_layers, n, block_size,
    n_kv_heads, head_dim]`` (``[n_layers, n, n_kv_heads]`` for the
    scales), bf16 viewed as int16."""
    names = _names(quant)

    def gather(kv: List[Dict[str, torch.Tensor]], idx: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
        with torch.inference_mode():
            return tuple(torch.stack([_raw(lay[name]).index_select(0, idx)
                                      for lay in kv]) for name in names)

    return gather


def make_tier_restore(quant: bool = False):
    """Per-layer restore: ``(layer, idx [n], host_k, host_v[, host_ks,
    host_vs])`` copies the host rows into the layer's pool tensors at the
    block ids ``idx``, in place (``index_copy_`` on the raw view)."""
    names = _names(quant)

    def restore(lay: Dict[str, torch.Tensor], idx: torch.Tensor,
                *host: torch.Tensor) -> None:
        with torch.inference_mode():
            for name, src in zip(names, host):
                _raw(lay[name]).index_copy_(0, idx, src)

    return restore


def staging(shape, dtype: np.dtype, device: torch.device,
            pinned: bool = True) -> torch.Tensor:
    """A host buffer for a restore's rows: pinned when they go to the card,
    so their copy runs without blocking the host (the caching host
    allocator keeps the buffer until that copy completes); ``pinned=False``
    stages in pageable memory (a blocking copy)."""
    tdt = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
    return torch.empty(shape, dtype=tdt,
                       pin_memory=pinned and device.type == "cuda")


class HostCopy:
    """Gathered device tensors on their way to host memory. On the card the
    copy is enqueued non-blocking into pinned buffers (``pinned=False``:
    pageable ones, a blocking copy) on the current stream and an event is
    recorded after it; the gathered tensors stay referenced until
    :meth:`host_arrays` has waited on that event. On the CPU the tensors
    are host memory already."""

    def __init__(self, tensors: Sequence[torch.Tensor], pinned: bool = True):
        tensors = list(tensors)
        self._src = tensors
        self._event = None
        if tensors and tensors[0].is_cuda:
            with torch.inference_mode():
                self._host = [torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=pinned)
                              for t in tensors]
                for h, t in zip(self._host, tensors):
                    h.copy_(t, non_blocking=pinned)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensors

    def host_arrays(self) -> Tuple[np.ndarray, ...]:
        """Wait for the copy (this copy's event only), release the
        gathered device tensors, and return the host arrays."""
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return tuple(t.numpy() for t in self._host)
