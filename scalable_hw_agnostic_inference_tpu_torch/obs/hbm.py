"""Live HBM ledger: reconcile declared memory budgets against runtime truth.

Copy of ``scalable_hw_agnostic_inference_tpu/obs/hbm.py``. On the card the
engine samples the CUDA caching allocator's host-side counters every
step-loop tick (``engine.LLMEngine._sample_hbm``: ``memory_allocated`` as
the bytes in use, ``max_memory_allocated`` as the peak, the device's
``total_memory`` as the limit), attributes bytes to named pools (weights,
KV pool, the decode graphs' static batch inputs, the in-flight
lookahead), and exports the verdicts —
``shai_hbm_{pool}_bytes``, ``shai_hbm_headroom_bytes``,
``shai_hbm_fragmentation_ratio`` — plus a steady-state drift detector
whose ``shai_hbm_leak_suspect`` gauge flips when memory grows
monotonically across N composition-stable windows (the signature of a
KV-block or buffer leak, which a fixed-size preallocated pool otherwise
hides until preemption storms start).

On the CPU (the tests) the ledger degrades to the *accounted* view: the
pool attribution is still exact (the engine computes it from its own
tensors), only the unattributed remainder and fragmentation read as zero.
The allocator holds memory no pool names (the CUDA graph pool, B2/B3's
split scratch, cuBLAS workspaces): the engine reports the first two in
``extra`` beside the unattributed bytes.

Layering: stdlib-only, like the rest of ``obs`` — the engine feeds samples
in; the serve layer exports the snapshot.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Hashable, Optional

#: env knobs for the drift detector (small values let tests converge fast)
ENV_WINDOW = "SHAI_HBM_WINDOW"            # samples per window (default 8)
ENV_WINDOWS = "SHAI_HBM_WINDOWS"          # growing windows to flag (default 4)
ENV_MIN_GROWTH = "SHAI_HBM_MIN_GROWTH"    # bytes of growth that count (4096)


class DriftDetector:
    """Monotonic-growth detector over composition-stable sample windows.

    Samples are fed as ``(composition, value)``; windows accumulate **per
    composition** (interleaved samples of other compositions don't reset a
    stream — steady-state idle windows survive traffic bursts between
    them). When ``windows_needed`` consecutive window means of the same
    composition each grow by more than ``min_growth``, the leak flag
    latches: a genuine leak needs a human (or a restart), not a gauge that
    un-flags itself the moment the growth pauses.
    """

    def __init__(self, window: int = 8, windows_needed: int = 4,
                 min_growth: float = 4096.0, max_compositions: int = 64):
        self.window = max(1, int(window))
        self.windows_needed = max(2, int(windows_needed))
        self.min_growth = float(min_growth)
        self.max_compositions = max_compositions
        # composition -> {"cur": [values], "means": [window means]}
        self._streams: "OrderedDict[Hashable, Dict[str, list]]" = OrderedDict()
        self.leak_suspect = False
        self.leak_composition: Optional[Hashable] = None
        self.windows_closed = 0

    def feed(self, composition: Hashable, value: float) -> bool:
        """One sample; returns the (latched) leak flag."""
        st = self._streams.get(composition)
        if st is None:
            st = self._streams[composition] = {"cur": [], "means": []}
            while len(self._streams) > self.max_compositions:
                self._streams.popitem(last=False)  # evict the oldest stream
        else:
            self._streams.move_to_end(composition)
        st["cur"].append(float(value))
        if len(st["cur"]) >= self.window:
            mean = sum(st["cur"]) / len(st["cur"])
            st["cur"] = []
            st["means"].append(mean)
            self.windows_closed += 1
            if len(st["means"]) > self.windows_needed:
                del st["means"][:-self.windows_needed]
            means = st["means"]
            if len(means) == self.windows_needed and all(
                    b - a > self.min_growth
                    for a, b in zip(means, means[1:])):
                self.leak_suspect = True
                self.leak_composition = composition
        return self.leak_suspect


class HbmLedger:
    """Per-device runtime memory ledger. Thread-safe: the engine loop
    writes one sample per step; scrape threads read :meth:`snapshot`."""

    def __init__(self, bytes_limit: float = 0.0,
                 window: Optional[int] = None,
                 windows_needed: Optional[int] = None,
                 min_growth: Optional[float] = None):
        from ..utils.env import env_float, env_int

        self.bytes_limit = float(bytes_limit)
        self._drift = DriftDetector(
            window=window if window is not None else env_int(ENV_WINDOW, 8),
            windows_needed=(windows_needed if windows_needed is not None
                            else env_int(ENV_WINDOWS, 4)),
            min_growth=(min_growth if min_growth is not None
                        else env_float(ENV_MIN_GROWTH, 4096.0)))
        self._lock = threading.Lock()
        self._last: Dict[str, float] = {}
        self.samples = 0

    def sample(self, *, pools: Dict[str, float], composition: Hashable,
               bytes_in_use: Optional[float] = None,
               bytes_limit: Optional[float] = None,
               peak_bytes: Optional[float] = None,
               largest_free: Optional[float] = None,
               drift_value: Optional[float] = None,
               host_pools: Optional[Dict[str, float]] = None,
               extra: Optional[Dict[str, float]] = None) -> None:
        """Record one tick.

        ``pools`` partitions the *attributed* bytes by name; ``bytes_in_use``
        is the allocator's truth when available (None = accounted fallback).
        ``drift_value`` is what the leak detector tracks — callers pass the
        *unexplained* share (KV bytes no live holder accounts for, device
        bytes outside every pool): a fixed preallocated pool never grows
        while its blocks leak, and a decoding sequence's held KV grows by
        design, so neither raw pool bytes nor raw usage is a leak signal.

        ``host_pools`` names HOST-RAM pools (the KV tier's ``host_kv``):
        exported like device pools (``shai_hbm_host_kv_bytes``) but
        excluded from the attributed sum — host bytes must never inflate
        ``used``/``headroom`` math against the device HBM limit.
        """
        attributed = float(sum(pools.values()))
        device_stats = bytes_in_use is not None
        used = float(bytes_in_use) if device_stats else attributed
        limit = float(bytes_limit) if bytes_limit else self.bytes_limit
        headroom = (limit - used) if limit else 0.0
        # fragmentation: how much of the free space is NOT one contiguous
        # run — 0 when the largest free block covers all free bytes
        frag = 0.0
        if device_stats and largest_free is not None and limit > used:
            free = limit - used
            frag = min(1.0, max(0.0, 1.0 - float(largest_free) / free))
        leak = self._drift.feed(
            composition, used if drift_value is None else float(drift_value))
        snap: Dict[str, float] = {f"{k}_bytes": float(v)
                                  for k, v in pools.items()}
        if host_pools:
            snap.update({f"{k}_bytes": float(v)
                         for k, v in host_pools.items()})
        if extra:
            snap.update({k: float(v) for k, v in extra.items()})
        snap.update({
            "used_bytes": used,
            "attributed_bytes": attributed,
            "unattributed_bytes": max(0.0, used - attributed)
            if device_stats else 0.0,
            "limit_bytes": limit,
            "headroom_bytes": headroom,
            "peak_bytes": float(peak_bytes) if peak_bytes else 0.0,
            "fragmentation_ratio": round(frag, 4),
            "leak_suspect": 1.0 if leak else 0.0,
            "device_stats": 1.0 if device_stats else 0.0,
        })
        with self._lock:
            self.samples += 1
            snap["samples"] = float(self.samples)
            self._last = snap

    @property
    def leak_suspect(self) -> bool:
        return self._drift.leak_suspect

    def snapshot(self) -> Dict[str, Any]:
        """Latest sample (flat numeric keys — the ``/stats`` ``"hbm"``
        section; ``serve.metrics`` prefixes each with ``shai_hbm_``)."""
        with self._lock:
            return dict(self._last)
