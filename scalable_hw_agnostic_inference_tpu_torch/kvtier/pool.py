"""Bounded host-RAM KV block pool + the async copy-out worker.

Trimmed copy of ``scalable_hw_agnostic_inference_tpu/kvtier/pool.py``
(``maybe_host_tier``, ``CopyOutWorker``, ``HostKVTier`` with its
advertisement cache and ``protect``, which feed ``/stats`` and
``/kv/digests``). The pool is a content-addressed store: entries are keyed
by the SAME chain hashes the device prefix cache uses
(``engine/cache.py``), so a device-cache miss falls through here by
walking the prompt's hash chain. Each entry holds one block's k/v for
every layer as numpy arrays (``[n_layers, block_size, n_kv_heads,
head_dim]`` each, plus ``[n_layers, n_kv_heads]`` f32 scales for an int8
pool); its accounting is exact (``used_bytes == entries *
block_nbytes``, always). A bf16 pool's entries hold the raw 16-bit words
in ``kvnet.frames.BF16`` (numpy has no bfloat16), which the frame codec
names ``bfloat16`` on the wire.

Copy-out discipline (``SHAI_KVTIER_ASYNC``, default on): the engine-side
demotion gathers evicted blocks into fresh device tensors and starts
their non-blocking copy into pinned host memory
(``kvtier.restore.HostCopy``); the :class:`CopyOutWorker` thread waits
on that copy's event, off the engine thread, then publishes the entries.
A full queue DROPS the demotion (counted): the tier never applies
backpressure to the engine. ``=0`` publishes at the eviction site:
deterministic, the mode the differential tests pin.

Failure contract: every tier failure (transfer error, queue overflow,
capacity refusal, raced eviction) degrades to recompute. Nothing in this
module can fail a request; it can only decline to save work, and counts
that it did (``errors``/``dropped`` on ``/metrics``).

Thread contract: ``_entries`` and ``_stats`` are lock-guarded (the engine
thread stores and probes, the copy-out worker publishes, scrape threads
snapshot, all under ``_lock``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..kvnet.frames import BF16
from ..utils.env import env_bool, env_int

log = logging.getLogger(__name__)

#: copy-out queue sentinel: the worker exits after draining everything
#: enqueued before it (bounded shutdown, the SIGTERM path)
_STOP = object()

#: default host pool capacity (SHAI_KVTIER_BYTES): 256 MiB — a few
#: thousand blocks at typical small-model geometry; production tiers size
#: it to the pod's RAM request
DEFAULT_CAPACITY_BYTES = 256 << 20
#: bounded copy-out queue: past this, demotions drop (never block)
COPYOUT_QUEUE_DEPTH = 64
#: chain-head runs one advertisement exports (kvnet.directory): bounds
#: the /kv/digests + /stats payload whatever the pool holds
ADVERT_MAX_RUNS = 64
#: hash-list cap on one run's /kv/digests?head= answer (a replication
#: pull re-chunks through fetch_run anyway)
ADVERT_MAX_RUN_HASHES = 1024
#: LRU entries scanned past protected runs before capacity wins and the
#: oldest is evicted anyway — protection defers, it never deadlocks
PROTECT_SCAN_LIMIT = 128


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype a tier stores a pool dtype as: ``"bfloat16"`` (or an
    ``ml_dtypes`` bfloat16) as :data:`~..kvnet.frames.BF16`, anything else
    as numpy reads it."""
    if str(dtype) in ("bfloat16", "torch.bfloat16"):
        return BF16
    return np.dtype(dtype)


def _materialize(arrays) -> Tuple[np.ndarray, ...]:
    """A demotion's arrays as host numpy: a ``kvtier.restore.HostCopy``
    waits for its copy; anything else is numpy-coercible."""
    if len(arrays) == 1 and hasattr(arrays[0], "host_arrays"):
        return arrays[0].host_arrays()
    return tuple(np.asarray(a) for a in arrays)


def maybe_host_tier(*, n_layers: int, block_size: int, n_kv_heads: int,
                    head_dim: int, dtype,
                    quant: bool = False) -> Optional["HostKVTier"]:
    """The ``SHAI_KVTIER`` gate: a configured :class:`HostKVTier`, or None
    when the knob is off (the default — the tier is opt-in). ``dtype`` is
    the pool's block dtype by name (``"bfloat16"``, ``"float32"``,
    ``"int8"``). ``quant`` declares an int8 device pool
    (``SHAI_KV_QUANT``): entries then carry the per-(block, head) f32
    scales next to the int8 blocks, and ``block_nbytes`` prices both."""
    if not env_bool("SHAI_KVTIER", False):
        return None
    capacity = max(0, env_int("SHAI_KVTIER_BYTES", DEFAULT_CAPACITY_BYTES))
    tier = HostKVTier(
        n_layers=n_layers, block_size=block_size, n_kv_heads=n_kv_heads,
        head_dim=head_dim, dtype=dtype, capacity_bytes=capacity,
        async_copy=env_bool("SHAI_KVTIER_ASYNC", True), quant=quant)
    if tier.block_nbytes > tier.capacity_bytes:
        log.warning(
            "SHAI_KVTIER_BYTES=%d holds zero %d-byte blocks — the tier is "
            "on but every demotion will be refused", capacity,
            tier.block_nbytes)
    return tier


class CopyOutWorker:
    """One daemon thread draining the demotion queue: wait for each
    demotion's device->host copy (its own event), then publish into the
    pool."""

    def __init__(self, pool: "HostKVTier",
                 max_queue: int = COPYOUT_QUEUE_DEPTH):
        self._pool = pool
        self._q: "queue.Queue[Tuple]" = queue.Queue(max_queue)
        self._closed = threading.Event()
        # serializes submit vs close: a batch must never land BEHIND the
        # shutdown sentinel (it would leak unprocessed with a True return
        # and wedge a later drain()'s q.join())
        self._sub_lock = threading.Lock()
        self._stop_sent = False
        self._thread = threading.Thread(
            target=self._run, name="shai-kvtier-copyout", daemon=True)
        self._thread.start()

    def submit(self, item: Tuple) -> bool:
        """Enqueue one demotion batch; False = queue full or worker closed
        (caller counts the drop — the tier never backpressures the
        engine)."""
        with self._sub_lock:
            if self._closed.is_set():
                return False
            try:
                self._q.put_nowait(item)
                return True
            except queue.Full:
                return False

    def drain(self) -> None:
        """Block until every enqueued batch is published (tests/bench)."""
        self._q.join()

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def close(self, timeout: float = 5.0) -> bool:
        """Bounded shutdown (SIGTERM/drain): refuse new batches, let the
        in-flight + queued demotions publish, then JOIN the worker thread
        within ``timeout`` seconds. True = the thread exited (no orphaned
        device->host copy runs past the drain); False = the budget
        expired with a copy still in flight (the caller logs and lets the
        daemon thread die with the process). Idempotent: a repeat call
        never enqueues a second sentinel — it just re-joins."""
        with self._sub_lock:
            # after this, submit() refuses — nothing can land behind the
            # sentinel enqueued below. The sentinel slot is CLAIMED under
            # the same lock so concurrent close() calls cannot enqueue
            # two sentinels (the second would never be consumed and a
            # later drain()'s q.join() would hang); the blocking put
            # itself happens outside it so a submit() never stalls
            # behind a wedged-worker close.
            self._closed.set()
            send = self._thread.is_alive() and not self._stop_sent
            if send:
                self._stop_sent = True
        deadline = time.monotonic() + max(0.0, timeout)
        if send:
            try:
                self._q.put(_STOP, timeout=max(0.01, timeout))
            except queue.Full:
                # the worker is wedged mid-copy with a full queue: give
                # the sentinel slot back so a LATER close() retries once
                # there is room; the join below still bounds the wait
                with self._sub_lock:
                    self._stop_sent = False
        self._thread.join(max(0.0, deadline - time.monotonic()))
        return not self._thread.is_alive()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                self._q.task_done()
                return
            hashes, arrays, n = item
            try:
                # the wait the engine thread never pays: the gather
                # outputs are fresh tensors, valid even after the evicted
                # blocks were re-allocated
                self._pool._ingest(hashes, _materialize(arrays), n)
            except Exception:
                log.warning("kv tier copy-out failed; blocks evicted "
                            "without demotion", exc_info=True)
                self._pool.count_error()
            finally:
                self._q.task_done()


class HostKVTier:
    """Bounded, LRU-evicting, content-addressed host block pool."""

    def __init__(self, *, n_layers: int, block_size: int, n_kv_heads: int,
                 head_dim: int, dtype, capacity_bytes: int,
                 async_copy: bool = True, quant: bool = False):
        self.n_layers = int(n_layers)
        self.block_size = int(block_size)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        #: storage dtype (a bf16 pool's is the 16-bit ``BF16`` view)
        self.dtype = host_dtype(dtype)
        self.quant = bool(quant)
        #: host bytes ONE block costs (k + v across every layer, plus the
        #: per-(block, head) f32 scales of a quantized pool) — the unit of
        #: every capacity/accounting decision in this class
        self.block_nbytes = (2 * self.n_layers * self.block_size
                             * self.n_kv_heads * self.head_dim
                             * self.dtype.itemsize)
        if self.quant:
            self.block_nbytes += 2 * self.n_layers * self.n_kv_heads * 4
        #: what an entry's arrays are viewed as: the storage dtype for k/v
        #: (carrying the wire name of a bf16 pool), f32 for the scales
        self._entry_dtypes = ((self.dtype, self.dtype)
                              + ((np.dtype(np.float32),) * 2
                                 if self.quant else ()))
        self.capacity_bytes = int(capacity_bytes)
        self.async_copy = bool(async_copy)
        self._lock = threading.Lock()
        #: hash -> (k, v[, ks, vs]) numpy, each [n_layers, ...block dims]
        self._entries: "OrderedDict[int, Tuple[np.ndarray, ...]]" = (
            OrderedDict())
        self._stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "stores": 0, "evictions": 0,
            "restored": 0, "errors": 0, "dropped": 0, "bytes": 0,
        }
        # incremental advertisement cache (kvnet.directory): the fleet
        # polls the chain-head set on EVERY /stats scrape, so it must be
        # maintained on store/evict instead of recomputed by an
        # O(entries) walk per poll. Runs are store-adjacency chains —
        # consecutive hashes of one demotion batch, extended across
        # batches when a batch continues a tracked run's tail.
        #: head -> {"hashes": [h, ...], "seq": recency counter}
        self._adv_runs: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        #: hash -> (head, index inside its run) — indices never shift:
        #: runs only append at the tail and truncate from a suffix
        self._adv_of: Dict[int, Tuple[int, int]] = {}
        self._adv_seq = 0
        #: head -> protection deadline (monotonic): cova defers eviction
        #: on a run's LAST advertised holder one directory cycle
        self._protected: Dict[int, float] = {}
        self._worker: Optional[CopyOutWorker] = None
        #: latched by close(): a post-close demotion must count a drop,
        #: never lazily spawn a fresh worker past the drain
        self._closing = False

    # -- capacity / accounting ---------------------------------------------

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return len(self._entries) * self.block_nbytes

    @property
    def n_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def utilization(self) -> float:
        if self.capacity_bytes <= 0:
            return 1.0
        return min(1.0, self.used_bytes / self.capacity_bytes)

    def has(self, h: int) -> bool:
        with self._lock:
            return h in self._entries

    def accepts(self, h: int) -> bool:
        """Would :meth:`store` of hash ``h`` do useful work? (Not already
        resident, and the pool can hold at least one block.)"""
        if self.block_nbytes > self.capacity_bytes:
            return False
        return not self.has(h)

    # -- demotion (engine thread enqueues / worker publishes) --------------

    def store_batch(self, hashes: Sequence[int], *arrays_and_n,
                    sync: bool = False) -> None:
        """Accept ``n`` demoted blocks: ``arrays_and_n`` is ``(k_all,
        v_all[, k_scale, v_scale], n)`` — the gather outputs
        ``[n_layers, pad, ...]`` as numpy arrays, or as ONE
        ``kvtier.restore.HostCopy`` of them (its copy is waited for by
        the worker in async mode, here in sync mode), column ``j``
        belonging to ``hashes[j]``. Quantized pools pass the two scale
        stacks ``[n_layers, pad, Hkv]`` between blocks and count.

        ``sync=True`` publishes on THIS thread even when the pool runs
        the async copy-out worker: the kvnet fetch path hands in blocks
        that are already host-side numpy — the worker exists only to pay
        device->host copies, and routing a network pull through its queue
        would race the very admission the pull exists to warm (or drop
        the blocks on a full queue while ``fetched`` already counted)."""
        *arrays, n = arrays_and_n
        arrays = tuple(arrays)
        if self.async_copy and not sync:
            with self._lock:
                if self._closing:
                    # closed tier: degrade to a counted drop — a late
                    # demotion must not resurrect the worker thread the
                    # drain just joined
                    self._stats["dropped"] += n
                    return
                if self._worker is None:
                    # lazy: engines that never demote never spawn the
                    # thread
                    self._worker = CopyOutWorker(self)
                w = self._worker
            if not w.submit((list(hashes), arrays, n)):
                with self._lock:
                    self._stats["dropped"] += n
            return
        try:
            self._ingest(list(hashes), _materialize(arrays), n)
        except Exception:
            log.warning("kv tier store failed; blocks evicted without "
                        "demotion", exc_info=True)
            self.count_error()

    def _ingest(self, hashes: List[int],
                arrays: Tuple[np.ndarray, ...], n: int) -> None:
        """Publish ``n`` materialized blocks, LRU-evicting to capacity."""
        for j, h in enumerate(hashes[:n]):
            prev = hashes[j - 1] if j > 0 else None
            with self._lock:
                if h in self._entries:
                    self._entries.move_to_end(h)
                    self._adv_touch_locked(h)
                    continue
                if self.block_nbytes > self.capacity_bytes:
                    self._stats["dropped"] += 1
                    continue
            # the contiguous block copy happens OUTSIDE the lock: the
            # engine thread probes/restores under the same lock, and a
            # worker-side demotion copy must never stall admission
            blk = tuple(np.ascontiguousarray(a[:, j]).view(dt)
                        for a, dt in zip(arrays, self._entry_dtypes))
            with self._lock:
                if h in self._entries:  # raced publish: keep the LRU touch
                    self._entries.move_to_end(h)
                    self._adv_touch_locked(h)
                    continue
                while ((len(self._entries) + 1) * self.block_nbytes
                       > self.capacity_bytes):
                    self._evict_one_locked()
                self._entries[h] = blk
                self._adv_store_locked(h, prev)
                self._stats["stores"] += 1
                self._stats["bytes"] += self.block_nbytes

    # -- advertisement bookkeeping (kvnet.directory) -----------------------

    def _adv_store_locked(self, h: int, prev: Optional[int]) -> None:
        """Track a freshly stored hash: extend the run whose TAIL is its
        in-batch predecessor (chain hashes make the successor unique, so
        store-adjacency IS chain adjacency within a batch), else open a
        new run headed by ``h``. O(1) — the whole point of the cache."""
        self._adv_seq += 1
        if prev is not None:
            rec = self._adv_of.get(prev)
            if rec is not None:
                head, idx = rec
                run = self._adv_runs.get(head)
                if run is not None and idx == len(run["hashes"]) - 1:
                    self._adv_of[h] = (head, len(run["hashes"]))
                    run["hashes"].append(h)
                    run["seq"] = self._adv_seq
                    self._adv_runs.move_to_end(head)
                    return
        self._adv_of[h] = (h, 0)
        self._adv_runs[h] = {"hashes": [h], "seq": self._adv_seq}

    def _adv_touch_locked(self, h: int) -> None:
        """A re-published resident hash refreshes its run's recency (the
        advertisement must surface what the pool would keep longest)."""
        rec = self._adv_of.get(h)
        if rec is None:
            return
        run = self._adv_runs.get(rec[0])
        if run is not None:
            self._adv_seq += 1
            run["seq"] = self._adv_seq
            self._adv_runs.move_to_end(rec[0])

    def _adv_evict_locked(self, h: int) -> None:
        """Untrack an evicted hash: its run truncates AT it — everything
        chained past an evicted block is unreachable by a leading-run
        walk, so advertising it would only manufacture stale probes.
        Amortized O(1): each hash leaves the advertisement at most once
        per store."""
        rec = self._adv_of.pop(h, None)
        if rec is None:
            return
        head, idx = rec
        run = self._adv_runs.get(head)
        if run is None:
            return
        for x in run["hashes"][idx + 1:]:
            self._adv_of.pop(x, None)
        del run["hashes"][idx:]
        if not run["hashes"]:
            del self._adv_runs[head]

    def _evict_one_locked(self) -> None:
        """Evict one entry LRU-first, skipping (a bounded scan of)
        entries whose run head is protected — the last-advertised-holder
        deferral. When every scanned entry is protected, capacity wins
        and the oldest goes anyway: protection defers an eviction one
        directory cycle, it never wedges the pool."""
        victim = None
        if self._protected:
            now = time.monotonic()
            for i, h in enumerate(self._entries):
                if i >= PROTECT_SCAN_LIMIT:
                    break
                rec = self._adv_of.get(h)
                dl = (self._protected.get(rec[0])
                      if rec is not None else None)
                if dl is not None and dl > now:
                    continue
                victim = h
                break
        if victim is None:
            victim = next(iter(self._entries))
        del self._entries[victim]
        self._stats["evictions"] += 1
        self._adv_evict_locked(victim)

    def advertisement(self, limit: int = ADVERT_MAX_RUNS) -> List[Dict]:
        """The pod's bounded chain-head advertisement, most recent run
        first: ``[{"head", "n", "seq"}, ...]`` — the ``/kv/digests`` and
        ``/stats`` payload the fleet directory is built from. O(limit)
        under the lock, never O(entries)."""
        out: List[Dict] = []
        with self._lock:
            for head in reversed(self._adv_runs):
                if len(out) >= max(0, limit):
                    break
                run = self._adv_runs[head]
                out.append({"head": head, "n": len(run["hashes"]),
                            "seq": run["seq"]})
        return out

    def run_hashes(self, head: int,
                   limit: int = ADVERT_MAX_RUN_HASHES) -> List[int]:
        """One advertised run's hash chain (``/kv/digests?head=`` — the
        replication pull resolves what to fetch through this)."""
        with self._lock:
            run = self._adv_runs.get(int(head))
            if run is None:
                return []
            return list(run["hashes"][:max(0, limit)])

    def protect(self, heads: Sequence[int], ttl_s: float) -> int:
        """Defer eviction of the given runs' blocks for ``ttl_s`` (cova
        marks sole-holder runs each directory cycle so the fleet never
        drops its only copy while a probe is in flight). Expired marks
        are swept here — the eviction scan only ever sees live ones.
        Returns the live protected-head count."""
        now = time.monotonic()
        with self._lock:
            for h in [h for h, dl in self._protected.items() if dl <= now]:
                del self._protected[h]
            for h in list(heads)[:ADVERT_MAX_RUNS]:
                self._protected[int(h)] = now + max(0.0, ttl_s)
            return len(self._protected)

    def drain(self) -> None:
        """Wait for pending async copy-outs to publish (tests/bench)."""
        w = self._worker
        if w is not None:
            w.drain()

    def close(self, timeout: float = 5.0) -> bool:
        """Bounded copy-out shutdown for the SIGTERM/drain path: latch
        the tier closed (late demotions become counted drops — never a
        fresh worker), and join the worker thread within ``timeout``
        (see :meth:`CopyOutWorker.close`). True when no worker exists or
        it exited inside the budget. Restores/probes keep working — only
        the demotion side closes."""
        with self._lock:
            self._closing = True
            w = self._worker
        if w is None:
            return True
        ok = w.close(timeout)
        if not ok:
            log.warning("kv tier copy-out worker did not exit within "
                        "%.1fs — an in-flight demotion copy will die "
                        "with the process", timeout)
        return ok

    # -- restore-side lookups (engine thread) ------------------------------

    def _run_entries(self, hashes: Sequence[int]) -> List[Tuple]:
        """THE leading-contiguous-run walk both lookup surfaces share:
        every visited resident entry is LRU-touched, the walk stops at the
        first miss. One implementation on purpose — probe (admission) and
        get (restore AND the ``/kv/blocks`` network serve) must refresh
        recency identically, or serving a run to a peer would leave the
        very blocks it just advertised cold and first-in-line for
        eviction."""
        with self._lock:
            out = []
            for h in hashes:
                e = self._entries.get(h)
                if e is None:
                    break
                self._entries.move_to_end(h)
                out.append((h, e))
            return out

    def probe_run(self, hashes: Sequence[int]) -> int:
        """Length of the leading contiguous run of resident hashes —
        the admission ladder's fall-through probe. Counts one hit per
        resident block and one miss when the walk stops short."""
        run = len(self._run_entries(hashes))
        with self._lock:
            self._stats["hits"] += run
            if run < len(hashes):
                self._stats["misses"] += 1
        return run

    def resident_run(self, hashes: Sequence[int]) -> int:
        """:meth:`probe_run` WITHOUT the hit/miss accounting — the kvnet
        transport's pre-fetch probe. The exported hit rate must keep
        measuring the ADMISSION ladder only; a decode fleet's handoff
        pulls would otherwise blend transport probes into the signal
        dashboards alert on. Recency is still refreshed (shared walk)."""
        return len(self._run_entries(hashes))

    def get_run(self, hashes: Sequence[int]) -> List[Tuple]:
        """Leading contiguous resident run as ``(hash, k, v[, ks, vs])``
        tuples (LRU-touched exactly like :meth:`probe_run`, via the shared
        walk; entries STAY resident — a restored block evicted from the
        device again re-demotes for free, and a network-served run stays
        warm for the next peer)."""
        return [(h,) + tuple(e) for h, e in self._run_entries(hashes)]

    # -- counters / export -------------------------------------------------

    def count_error(self) -> None:
        with self._lock:
            self._stats["errors"] += 1

    def count_restored(self, n: int) -> None:
        with self._lock:
            self._stats["restored"] += n

    def snapshot(self) -> Dict[str, float]:
        """Flat numeric snapshot: the ``/stats`` ``"kvtier"`` section and
        the source of the ``shai_kvtier_*`` exports (``serve.metrics``)."""
        with self._lock:
            st = dict(self._stats)
            entries = len(self._entries)
        looked = st["hits"] + st["misses"]
        used = entries * self.block_nbytes
        return {
            **{k: float(v) for k, v in st.items()},
            "entries": float(entries),
            "used_bytes": float(used),
            "capacity_bytes": float(self.capacity_bytes),
            "block_nbytes": float(self.block_nbytes),
            "utilization": round(min(1.0, used / self.capacity_bytes), 4)
            if self.capacity_bytes > 0 else 1.0,
            "hit_rate": round(st["hits"] / looked, 4) if looked else 0.0,
        }
