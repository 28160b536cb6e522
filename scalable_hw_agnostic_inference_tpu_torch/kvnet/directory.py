"""Fleet-wide KV fabric: the content-addressed directory and the engine's
peer-probe rung.

Port of ``scalable_hw_agnostic_inference_tpu/kvnet/directory.py``
(``fabric_enabled``, ``resolve_fabric_peers``, ``KvFabricStats``,
``KvDirectory``, ``FabricProbe``). kvnet moves KV point to point for one
request (a handoff or a migration names its peer); this module makes the
same transport a fleet-wide content-addressed pool, so a prefix computed
once anywhere becomes warm everywhere:

- :class:`KvDirectory`: a blake2b-64 chain head -> holders map, built from
  each pod's host-tier advertisement (``HostKVTier.advertisement``, read
  off ``/stats`` by a fleet controller or ``GET /kv/digests`` by a peer).
  A hint, never a promise: a wrong holder degrades to recompute at the
  prober, never to a failure. Standard library only, so that a port of
  the control plane can import it;
- :class:`KvFabricStats`: the ``shai_kvfabric_*`` counters, on the
  engine-telemetry seam (``obs.steploop.StepTelemetry.kvfabric``);
- :class:`FabricProbe`: the third rung of the engine's admission ladder
  (``LLMEngine._admit_cached``): on a device and host-tier miss, resolve
  holders (a slice riding the request, or the pod-local directory
  refreshed from ``SHAI_KVFABRIC_PEERS``), pull the run with
  :meth:`~.client.KvNetClient.fetch_run` under the caller's wall budget,
  and let ordinary warm admission restore it.

Failure contract: a probe never raises and never blocks past its budget;
every failure (no holders, an open breaker, a transport error, a stale
entry) returns 0 blocks and the engine recomputes. The ``kvfabric.probe``
fault site (``resilience.faults.KVFABRIC_PROBE``) injects that path.

Threads: every map lives under its class's lock; the HTTP work (probe
pulls, digest refreshes) runs outside the locks.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

from ..resilience import faults as rz_faults
from ..utils.env import env_bool, env_float, env_str

log = logging.getLogger(__name__)

#: the ``shai_kvfabric_*`` families this module feeds (serve/metrics.py
#: derives them from the snapshot)
METRIC_FAMILIES = (
    "shai_kvfabric_probes_total",
    "shai_kvfabric_remote_hits_total",
    "shai_kvfabric_remote_misses_total",
    "shai_kvfabric_replications_total",
    "shai_kvfabric_directory_size_total",
    "shai_kvfabric_stale_holders_total",
)

#: holders tried per probe: the first warm holder wins, so past the second
#: fallback the budget is better spent recomputing
MAX_PROBE_HOLDERS = 3
#: bound on the affinity-digest -> chain-head map (a routing hint only)
MAX_AFF_HEADS = 1024
#: bound on the tracked per-head routing hit counters
MAX_HIT_HEADS = 4096
#: replication target for hot heads (a fleet controller pushes background
#: pulls until this many pods advertise the run)
REPLICA_TARGET = 2


def fabric_enabled() -> bool:
    """The ``SHAI_KVFABRIC`` gate: on explicitly, or armed by a static peer
    list (``SHAI_KVFABRIC_PEERS``). Off by default, and then the admission
    ladder is exactly the pre-fabric engine's."""
    return env_bool("SHAI_KVFABRIC", False) or bool(
        (env_str("SHAI_KVFABRIC_PEERS", "") or "").strip())


def resolve_fabric_peers() -> List[str]:
    """Static peer URLs from ``SHAI_KVFABRIC_PEERS`` (comma-separated): the
    directory's source when no controller pushes holder slices down."""
    return [p.strip().rstrip("/") for p in
            (env_str("SHAI_KVFABRIC_PEERS", "") or "").split(",")
            if p.strip()]


class KvFabricStats:
    """The ``shai_kvfabric_*`` counters: probe attempts and outcomes on the
    engine side, replication pulls on the serving side. ``directory_size``
    is the pod-local directory's head count (set by whoever refreshes
    it); the rest are monotonic."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {
            "probes": 0, "remote_hits": 0, "remote_misses": 0,
            "replications": 0, "stale_holders": 0, "directory_size": 0,
        }

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n

    def set_directory_size(self, n: int) -> None:
        with self._lock:
            self._counts["directory_size"] = int(n)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {k: float(v) for k, v in self._counts.items()}


class KvDirectory:
    """Chain head -> holders map with routing hit counts.

    Keys are the chain hash of a prompt's FIRST full block
    (``PagedKVCache._chain_hashes``: a function of the tokens alone, so
    every pod computing the prompt derives the same key). Per holder URL
    it keeps the advertised run length, the advertisement's sequence
    number and the local receipt time (recency ranks holders and drives
    the TTL prune). A hint: holders advertise asynchronously and evict
    independently, so every consumer survives a stale entry.
    """

    def __init__(self, ttl_s: Optional[float] = None):
        #: advertisement time-to-live: a holder unseen this long is pruned
        self.ttl_s = (env_float("SHAI_KVFABRIC_TTL_S", 15.0)
                      if ttl_s is None else float(ttl_s))
        self._lock = threading.Lock()
        #: head -> {holder_url: (run_len, adv_seq, seen_monotonic)}
        self._holders: Dict[int, Dict[str, Tuple[int, int, float]]] = {}
        #: holder_url -> the heads it advertises (a fresh advertisement
        #: retires the holder's dropped heads)
        self._by_holder: Dict[str, set] = {}
        #: per-head routing hit counts (the replication trigger)
        self._hits: "OrderedDict[int, int]" = OrderedDict()
        #: affinity digest -> head: maps a prompt to its chain head for a
        #: router that has no tokenizer
        self._aff2head: "OrderedDict[str, int]" = OrderedDict()

    # -- ingest --------------------------------------------------------------

    def update_holder(self, url: str, adverts: Sequence[Dict],
                      now: Optional[float] = None) -> None:
        """Replace ``url``'s advertised head set with ``adverts``
        (``[{"head", "n", "seq"}, ...]``, ``HostKVTier.advertisement``'s
        shape). Malformed entries are skipped: adverts come off the
        network."""
        t = time.monotonic() if now is None else now
        url = url.rstrip("/")
        fresh: Dict[int, Tuple[int, int, float]] = {}
        for a in adverts or ():
            try:
                fresh[int(a["head"])] = (int(a.get("n", 1)),
                                         int(a.get("seq", 0)), t)
            except (TypeError, ValueError, KeyError, AttributeError):
                continue
        with self._lock:
            for head in self._by_holder.get(url, ()):
                if head not in fresh:
                    hs = self._holders.get(head)
                    if hs is not None:
                        hs.pop(url, None)
                        if not hs:
                            del self._holders[head]
            for head, rec in fresh.items():
                self._holders.setdefault(head, {})[url] = rec
            if fresh:
                self._by_holder[url] = set(fresh)
            else:
                self._by_holder.pop(url, None)

    def note_affinity(self, aff: str, head: int) -> None:
        with self._lock:
            self._aff2head.pop(aff, None)
            self._aff2head[aff] = int(head)
            while len(self._aff2head) > MAX_AFF_HEADS:
                self._aff2head.popitem(last=False)

    # -- queries -------------------------------------------------------------

    def head_of(self, aff: str) -> Optional[int]:
        with self._lock:
            h = self._aff2head.get(aff)
            if h is not None:
                self._aff2head.move_to_end(aff)
            return h

    def holders_of(self, head: Optional[int]) -> List[str]:
        """Holder URLs of ``head``, the longest advertised run first (ties
        broken by recency): the order the prober tries them in."""
        if head is None:
            return []
        with self._lock:
            hs = self._holders.get(int(head))
            if not hs:
                return []
            return [u for u, _ in sorted(
                hs.items(), key=lambda kv: (-kv[1][0], -kv[1][2]))]

    def note_hit(self, head: int) -> int:
        """Count one routing decision that relied on ``head`` being warm
        somewhere; returns the running count."""
        with self._lock:
            n = self._hits.get(head, 0) + 1
            self._hits.pop(head, None)
            self._hits[head] = n
            while len(self._hits) > MAX_HIT_HEADS:
                self._hits.popitem(last=False)
            return n

    def hot_heads(self, threshold: int) -> List[Tuple[int, int]]:
        """Heads at or above ``threshold`` routing hits, hottest first."""
        with self._lock:
            hot = [(h, n) for h, n in self._hits.items() if n >= threshold]
        hot.sort(key=lambda kv: -kv[1])
        return hot

    def sole_holders(self) -> Dict[int, str]:
        """Heads with exactly ONE advertised holder: evicting them drops
        the fleet's only copy, so a controller protects them for a cycle
        (``POST /kv/protect`` on the holder)."""
        with self._lock:
            return {h: next(iter(hs)) for h, hs in self._holders.items()
                    if len(hs) == 1}

    def size(self) -> int:
        with self._lock:
            return len(self._holders)

    def prune(self, now: Optional[float] = None) -> int:
        """Drop the (holder, head) records unseen for ``ttl_s``; returns
        how many went. A pod that stopped advertising ages out instead of
        attracting probes forever."""
        t = time.monotonic() if now is None else now
        dropped = 0
        with self._lock:
            for head in list(self._holders):
                hs = self._holders[head]
                for url in list(hs):
                    if t - hs[url][2] > self.ttl_s:
                        del hs[url]
                        s = self._by_holder.get(url)
                        if s is not None:
                            s.discard(head)
                            if not s:
                                del self._by_holder[url]
                        dropped += 1
                if not hs:
                    del self._holders[head]
        return dropped

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            n_heads = len(self._holders)
            n_holders = len(self._by_holder)
            n_sole = sum(1 for hs in self._holders.values() if len(hs) == 1)
            hits = sum(self._hits.values())
        return {"directory_size": float(n_heads),
                "holders": float(n_holders),
                "sole_holders": float(n_sole),
                "routing_hits": float(hits)}


class FabricProbe:
    """The peer-probe rung: resolve holders, pull the run, degrade.

    Owns ONE :class:`~.client.KvNetClient` (its breaker table is the
    per-holder failure memory) and, with static peers
    (``SHAI_KVFABRIC_PEERS``), a pod-local :class:`KvDirectory` refreshed
    from each peer's ``GET /kv/digests`` on a TTL. The refresh, like the
    probe, runs outside ``_lock``, which guards the refresh deadline only.
    """

    def __init__(self, tier, kvnet_stats=None,
                 stats: Optional[KvFabricStats] = None,
                 peers: Optional[Sequence[str]] = None, client=None,
                 ttl_s: Optional[float] = None):
        from .client import KvNetClient

        self.tier = tier
        self.stats = stats or KvFabricStats()
        self.client = client or KvNetClient(tier, kvnet_stats)
        self.peers = list(resolve_fabric_peers() if peers is None else peers)
        self.ttl_s = (env_float("SHAI_KVFABRIC_TTL_S", 15.0)
                      if ttl_s is None else float(ttl_s))
        self.directory = KvDirectory(ttl_s=self.ttl_s)
        self._lock = threading.Lock()
        self._refresh_at = 0.0          # next directory refresh (monotonic)

    def close(self) -> None:
        self.client.close()

    # -- directory (static peers) -------------------------------------------

    def holders_for(self, head: int) -> List[str]:
        """Holder URLs of ``head`` from the pod-local directory, refreshed
        from the static peer list when its TTL lapsed; [] without peers
        (a holder slice riding the request is the caller's first
        choice)."""
        if not self.peers:
            return []
        now = time.monotonic()
        with self._lock:
            due = now >= self._refresh_at
            if due:
                # claim the refresh under the lock; the HTTP work runs
                # outside it (a slow peer must not serialize probes)
                self._refresh_at = now + self.ttl_s
        if due:
            for peer in self.peers:
                got = self.client.fetch_digests(peer)
                if got is not None:
                    self.directory.update_holder(peer, got.get("adverts"))
            self.directory.prune()
            self.stats.set_directory_size(self.directory.size())
        return self.directory.holders_of(head)

    # -- the probe -----------------------------------------------------------

    def probe(self, hashes: Sequence[int], holders: Sequence[str],
              budget_s: float, traceparent: Optional[str] = None) -> int:
        """Try to make the local tier hold the leading run of ``hashes``,
        pulling from ``holders`` in order under ONE aggregate wall budget.
        Returns the blocks now resident (0: the engine recomputes); never
        raises. ``traceparent`` joins each pull to the request's trace
        (the probe runs on the engine loop, where no context is live).

        One ``probes`` per call; ``remote_hits`` when a holder lands
        blocks, else ``remote_misses``. A holder that answered cleanly
        yet held nothing also counts one ``stale_holders`` (the
        advertisement outlived the blocks), told apart from an unreachable
        holder by the kvnet stats: a clean empty answer moves neither
        ``errors`` nor ``fallbacks``."""
        hashes = list(hashes)
        if not hashes or not holders or budget_s <= 0:
            return 0
        self.stats.count("probes")
        deadline = time.monotonic() + budget_s
        inj = rz_faults.get()
        fetched = 0
        stale = 0
        for url in list(holders)[:MAX_PROBE_HOLDERS]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if inj.active:
                # chaos site: an injected failure looks like a dead holder,
                # breaker-counted and degraded past, the path a real
                # connect fault takes inside fetch_run
                inj.sleep_at(rz_faults.KVFABRIC_PROBE)
                if inj.should_fail(rz_faults.KVFABRIC_PROBE):
                    self.client.breaker_of(url).record_failure()
                    self.client.stats.count_error()
                    continue
            before = self.client.stats.snapshot()
            fetched = self.client.fetch_run(url, hashes, budget_s=remaining,
                                            traceparent=traceparent)
            if fetched > 0:
                break
            after = self.client.stats.snapshot()
            if (after["errors"] == before["errors"]
                    and after["fallbacks"] == before["fallbacks"]):
                stale += 1
        if fetched > 0:
            self.stats.count("remote_hits")
        else:
            self.stats.count("remote_misses")
            if stale:
                self.stats.count("stale_holders", stale)
        return fetched
