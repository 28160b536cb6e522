"""Live request migration: the MIGRATE envelope and its ship and restore.

Port of ``scalable_hw_agnostic_inference_tpu/kvnet/migrate.py``
(``MigrateError``, ``MigrateBusy``, ``MigrateStats``, the ``KVMG``
envelope, ``MigrationInbox``, ``MigrateClient`` with ``ship`` and
``ship_any``, ``restore_entries`` and the peer selection). A draining pod
must not turn its in-flight sequences into errors: the engine snapshots
each running sequence's resumable state (``LLMEngine.snapshot_sequence``:
prompt and generated token ids, the remaining sampling budget, the QoS
identity, the deadline remainder, and the chain hashes of the KV run it
banks in the host tier, generated blocks included); this module moves
that state to a healthy peer, which restores the KV into its pool in
place and re-admits the sequence mid-generation.

Wire format (``POST /kv/migrate``, content type
``application/x-shai-migrate``), byte-compatible with a JAX pod's in both
directions::

    envelope := magic "KVMG" | u8 version | u64 manifest_len
                | u32 crc32(manifest) | manifest JSON | frame*

``frame*`` is the CRC-checked block frame stream of :mod:`.frames`: bf16
and int8-with-scales blocks cross byte-exact, so a migrated sequence's
greedy continuation equals the unmigrated engine's. A manifest-only
envelope (no frames) is legal: the peer then pulls the run from
``manifest["source_url"]`` over ``GET /kv/blocks`` (the draining pod
holds that route open), or recomputes.

The degradation ladder: every rung ends in a completed request while any
capable pod exists.

1. **ship**: manifest and blocks POSTed to the peer, which restores and
   resumes warm;
2. **warm recompute on the peer**: the restore (or the blocks) did not
   land; the peer pulls what it can over ``/kv/blocks`` and recomputes
   the rest;
3. **cold recompute**: no peer accepted the ship; the client replays the
   request against any serving pod;
4. **fail**: only when no capable pod exists.

Fault sites: ``migrate.ship`` (the POST never leaves the pod: rung 3) and
``migrate.restore`` (the peer refuses the blocks: rung 2).

Counters (``shai_migrate_*``, on the engine-telemetry seam):
``shipped``/``received``/``resumed`` on the happy path; ``failed``, ship
attempts that never landed; ``fallbacks``, ladder degradations;
``busy``, 429 answers from saturated peers (back-pressure, never a
failure).

The storm guard: a pod whose :class:`MigrationInbox` is saturated (banked
manifests at capacity, or concurrent accepts at
``SHAI_MIGRATE_MAX_INBOUND``) answers ``POST /kv/migrate`` with 429 and
``Retry-After``; :meth:`MigrateClient.ship_any` walks its candidate peers,
skipping busy ones, and waits out the smallest advertised Retry-After
within its budget only once every candidate refused.

The reference speaks HTTP through ``httpx``, which the port does not use:
one POST here is ``http.client`` from the standard library, behind the
``post_transport`` seam (a callable ``(url, body, headers, deadline) ->
(status, headers, body)`` raising :class:`~.client.ConnectError` for a
connect-phase failure). Threads: the counters and the inbox map are
lock-guarded; the snapshot runs on the engine loop thread, the ship on a
serving thread outside every lock.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs import trace as obs_trace
from ..resilience import faults as rz_faults
from ..utils.env import env_bool, env_float, env_int, env_str
from . import frames
from .client import ConnectError, KvNetClient, http_connection, publish_run

log = logging.getLogger(__name__)

#: the receiving pod's endpoint (serve/app.py registers it)
MIGRATE_ROUTE = "/kv/migrate"
MAGIC = b"KVMG"
VERSION = 1
#: manifests are token-id lists and scalars; anything bigger is hostile
MAX_MANIFEST_BYTES = 1 << 22
#: bounded resume inbox: unreplayed migrations evict FIFO past this
MAX_INBOX_ENTRIES = 64
#: JSON byte cap on a ship's ack and on the fleet's peer list
MAX_ACK_BYTES = 1 << 20

_HEAD = struct.Struct("<4sBQI")  # magic, version, manifest_len, crc32

#: the exported counter families (serve/metrics.py maps the snapshot keys
#: onto these names)
METRIC_FAMILIES = (
    "shai_migrate_shipped_total", "shai_migrate_received_total",
    "shai_migrate_resumed_total", "shai_migrate_failed_total",
    "shai_migrate_fallbacks_total", "shai_migrate_peer_busy_total",
)


class MigrateError(ValueError):
    """Malformed, truncated or corrupt migration envelope."""


class MigrateBusy(RuntimeError):
    """The accept side is saturated (inbox full or at the concurrent
    inbound cap): the route answers 429 with ``Retry-After`` and the
    shipper tries another peer. Carries the seconds to wait."""

    def __init__(self, retry_after_s: float = 1.0):
        super().__init__("migration inbox saturated; try another peer")
        self.retry_after_s = max(0.1, float(retry_after_s))


def migrate_max_inbound() -> int:
    """Per-pod cap on CONCURRENT inbound accepts
    (``SHAI_MIGRATE_MAX_INBOUND``, default 4, lenient): above it the pod
    answers 429, so a drain of several pods cannot storm one survivor."""
    return max(1, env_int("SHAI_MIGRATE_MAX_INBOUND", 4))


class MigrateStats:
    """The ``shai_migrate_*`` counters, shared by the ship side (the
    drain), the accept side (``POST /kv/migrate``) and the resume path;
    exported through the engine-telemetry seam and ``/stats``
    ``"migrate"``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {
            "shipped": 0, "received": 0, "resumed": 0, "failed": 0,
            "fallbacks": 0, "busy": 0,
        }

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] += n

    def count_fallback(self) -> None:
        self.count("fallbacks")

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {k: float(v) for k, v in self._counts.items()}


# -- envelope codec -----------------------------------------------------------

def encode_migration(manifest: Dict[str, Any],
                     entries: Sequence[Tuple] = ()) -> bytes:
    """Manifest plus block entries (``HostKVTier.get_run`` tuples) -> one
    MIGRATE envelope. The manifest holds plain ints, floats and strings
    (``snapshot_sequence``), serialized as the reference does (compact
    separators), so both packages write the same bytes."""
    body = json.dumps(manifest, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_MANIFEST_BYTES:
        raise MigrateError(f"manifest of {len(body)} bytes over limit")
    return (_HEAD.pack(MAGIC, VERSION, len(body), zlib.crc32(body))
            + body + frames.encode_frames(entries))


def decode_migration(data: bytes) -> Tuple[Dict[str, Any], List[Tuple]]:
    """Strict decode: a bad magic or version, truncation, a CRC mismatch,
    an over-limit or non-object manifest, or any malformed block frame
    raises; a half-parsed migration is never accepted."""
    if len(data) < _HEAD.size:
        raise MigrateError("envelope shorter than its header")
    magic, version, mlen, crc = _HEAD.unpack_from(data, 0)
    if magic != MAGIC:
        raise MigrateError(f"bad envelope magic {magic!r}")
    if version != VERSION:
        raise MigrateError(f"unsupported envelope version {version}")
    if mlen > MAX_MANIFEST_BYTES:
        raise MigrateError(f"manifest length {mlen} over limit")
    off = _HEAD.size
    if off + mlen > len(data):
        raise MigrateError("truncated manifest")
    body = bytes(data[off:off + mlen])
    if zlib.crc32(body) != crc:
        raise MigrateError("manifest CRC mismatch")
    try:
        manifest = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MigrateError(f"manifest is not JSON: {e}")
    if not isinstance(manifest, dict):
        raise MigrateError("manifest must be a JSON object")
    try:
        entries = frames.decode_frames(data[off + mlen:])
    except frames.FrameError as e:
        raise MigrateError(f"bad block frames: {e}")
    return manifest, entries


# -- resume inbox (receiving pod) ---------------------------------------------

class MigrationInbox:
    """Bounded store of accepted, not yet replayed manifests, keyed by the
    resume handle the ship's ack carries. ``pop`` is the exactly-once
    gate: a duplicate replay reads as unknown and degrades to a cold
    replay instead of generating twice."""

    def __init__(self, capacity: int = MAX_INBOX_ENTRIES):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._accepting = 0   # concurrent accepts in flight (the 429 gate)

    def begin_accept(self, cap: int) -> bool:
        """Reserve one concurrent-accept slot; False when the pod should
        answer 429 instead (at ``cap`` accepts in flight, or the next put
        would evict a banked entry). Pair every True with
        :meth:`end_accept` in a ``finally``."""
        with self._lock:
            if self._accepting >= max(1, int(cap)) \
                    or len(self._entries) + self._accepting >= self.capacity:
                return False
            self._accepting += 1
            return True

    def end_accept(self) -> None:
        with self._lock:
            self._accepting = max(0, self._accepting - 1)

    def saturated(self, cap: int) -> bool:
        """The route's cheap probe before it reads a possibly large
        envelope; :meth:`begin_accept` closes the check-then-accept race
        at the real accept."""
        with self._lock:
            return (self._accepting >= max(1, int(cap))
                    or len(self._entries) + self._accepting
                    >= self.capacity)

    def put(self, manifest: Dict[str, Any]) -> str:
        rid = uuid.uuid4().hex[:16]
        with self._lock:
            while len(self._entries) >= self.capacity:
                self._entries.popitem(last=False)
            self._entries[rid] = manifest
        return rid

    def pop(self, rid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._entries.pop(rid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


# -- ship (draining pod) ------------------------------------------------------

class MigrateClient(KvNetClient):
    """The kvnet transport plus :meth:`ship`: the fetch side's peer
    allowlist, per-peer breaker and connect-only retries. A pod in the
    network KV plane builds one of these in place of the plain client."""

    def __init__(self, tier, stats=None,
                 mstats: Optional[MigrateStats] = None,
                 post_transport=None, **kw):
        super().__init__(tier, stats, **kw)
        self.mstats = mstats or MigrateStats()
        #: one POST: ``(url, body, headers, deadline) -> (status, headers,
        #: body)``; the default is :meth:`_http_post`
        self._post = post_transport or self._http_post

    def _http_post(self, url: str, body: bytes, headers: Dict[str, str],
                   deadline: float) -> Tuple[int, Dict[str, str], bytes]:
        """One POST over a fresh ``http.client`` connection: connect within
        ``connect_timeout_s`` (a failure raises ``ConnectError``), then the
        send and each read within ``timeout_s``; the answer's body is read
        up to ``MAX_ACK_BYTES``. Returns the status, the lowercased
        headers and the body."""
        parts, conn = http_connection(url, self.connect_timeout_s)
        try:
            try:
                conn.connect()
            except OSError as e:
                raise ConnectError(f"connect to {parts.netloc}: {e}") from e
            conn.sock.settimeout(max(0.1, min(
                self.timeout_s, deadline - time.monotonic())))
            conn.request("POST", parts.path or "/", body=body,
                         headers=dict(headers, **{
                             "content-length": str(len(body))}))
            r = conn.getresponse()
            data = r.read(MAX_ACK_BYTES + 1)
            if len(data) > MAX_ACK_BYTES:
                raise frames.FrameError("ship answer over its byte cap")
            return (r.status, {k.lower(): v for k, v in r.getheaders()},
                    data)
        finally:
            conn.close()

    def _encode_payload(self, manifest: Dict[str, Any],
                        entries: Sequence[Tuple]) -> Optional[bytes]:
        try:
            return encode_migration(manifest, entries)
        except Exception:
            # unencodable blocks: ship manifest-only; the peer pulls or
            # recomputes (rung 2), the manifest itself must still land
            log.warning("migrate: block entries unencodable — shipping "
                        "manifest-only", exc_info=True)
            self.mstats.count_fallback()
            try:
                return encode_migration(manifest, ())
            except Exception:
                self.mstats.count("failed")
                return None

    def _post_envelope(self, peer_url: str, payload: bytes
                       ) -> Tuple[str, Any]:
        """One POST to one peer. Returns ``("ok", ack)``, ``("busy",
        retry_after_s)`` (the peer is alive but saturated: the caller
        tries the next one) or ``("fail", None)``; counts ``shipped``,
        ``busy`` or ``failed``."""
        if not peer_url or not self.peer_allowed(peer_url):
            if peer_url:
                log.warning("migrate: refusing ship to disallowed peer %r",
                            peer_url[:120])
            self.mstats.count_fallback()
            return "fail", None
        br = self.breaker_of(peer_url)
        if not br.allow():
            self.mstats.count("failed")
            return "fail", None
        url = f"{peer_url.rstrip('/')}{MIGRATE_ROUTE}"
        inj = rz_faults.get()
        attempt = 0
        # the ship runs on a serving thread where the request's trace
        # context is live: the peer's restore joins the same trace
        headers = {"content-type": "application/x-shai-migrate"}
        tp = obs_trace.current_traceparent()
        if tp:
            headers["traceparent"] = tp
        try:
            while True:
                try:
                    if inj.active:
                        # chaos site: the ship never leaves the pod, down
                        # to the cold-replay rung
                        inj.sleep_at(rz_faults.MIGRATE_SHIP)
                        if inj.should_fail(rz_faults.MIGRATE_SHIP):
                            raise ConnectError("injected migrate.ship "
                                               "fault")
                    status, rhead, body = self._post(
                        url, payload, headers,
                        time.monotonic() + self.timeout_s)
                except ConnectError:
                    br.record_failure()
                    if attempt < self.connect_retries and br.allow():
                        attempt += 1
                        continue
                    self.mstats.count("failed")
                    log.warning("migrate: peer %s unreachable — falling "
                                "back to client replay", peer_url)
                    return "fail", None
                except Exception:
                    # read phase: reachable but failed, never retried
                    br.release_probe()
                    self.mstats.count("failed")
                    log.warning("migrate: ship to %s failed mid-exchange",
                                peer_url, exc_info=True)
                    return "fail", None
                break
            br.record_success()
            if status == 429:
                # the storm guard: healthy but saturated; honour
                # Retry-After, bounded to [0.1, 30] s
                self.mstats.count("busy")
                try:
                    ra = float(rhead.get("retry-after") or 1.0)
                except (TypeError, ValueError):
                    ra = 1.0
                log.info("migrate: peer %s busy (retry-after %.1fs) — "
                         "trying the next peer", peer_url, ra)
                return "busy", max(0.1, min(ra, 30.0))
            if status != 200:
                self.mstats.count("failed")
                log.warning("migrate: %s%s -> %d", peer_url, MIGRATE_ROUTE,
                            status)
                return "fail", None
            try:
                ack = json.loads(body)
            except ValueError:
                self.mstats.count("failed")
                return "fail", None
            if not isinstance(ack, dict) or not ack.get("accepted"):
                self.mstats.count("failed")
                return "fail", None
            self.mstats.count("shipped")
            return "ok", ack
        except BaseException:
            br.release_probe()
            raise

    def ship(self, peer_url: str, manifest: Dict[str, Any],
             entries: Sequence[Tuple] = ()) -> Optional[Dict[str, Any]]:
        """POST one MIGRATE envelope to ``peer_url``. Returns the peer's
        ack (``{"accepted": true, "resume": ..., "restored": n}``) or
        None; never raises (every failure is counted and the caller
        degrades down the ladder). Runs on a serving thread, outside
        every lock."""
        payload = self._encode_payload(manifest, entries)
        if payload is None:
            return None
        state, ack = self._post_envelope(peer_url, payload)
        return ack if state == "ok" else None

    def ship_any(self, peers: Sequence[str], manifest: Dict[str, Any],
                 entries: Sequence[Tuple] = (), budget_s: float = 3.0
                 ) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Walk the candidate peers until one accepts the envelope. A busy
        peer means the next one; only when EVERY candidate is busy does
        the shipper wait out the smallest Retry-After (within
        ``budget_s``) and sweep again. Returns ``(peer_url, ack)``, or
        None when every peer failed or the budget ran out."""
        peers = [p for p in peers if p]
        if not peers:
            return None
        payload = self._encode_payload(manifest, entries)
        if payload is None:
            return None
        deadline = time.monotonic() + max(0.0, budget_s)
        while True:
            wait: Optional[float] = None
            for peer in peers:
                state, out = self._post_envelope(peer, payload)
                if state == "ok":
                    return peer, out
                if state == "busy":
                    wait = out if wait is None else min(wait, out)
            if wait is None:
                return None            # no peer is even busy: all failed
            remaining = deadline - time.monotonic()
            if remaining <= 0.05:
                # every candidate still busy at the budget's end: the
                # caller degrades to the cold replay
                return None
            time.sleep(min(wait, remaining))


# -- restore (receiving pod) --------------------------------------------------

def restore_entries(tier, manifest: Dict[str, Any],
                    entries: Sequence[Tuple], stats: MigrateStats,
                    kvnet: Optional[KvNetClient] = None) -> int:
    """Make the local tier hold the manifest's KV run: publish the shipped
    blocks (validated byte-exact, synchronously: the resume admits
    against them), or pull the run from ``manifest["source_url"]`` when
    the envelope came manifest-only. Returns the blocks resident; every
    failure degrades to recompute on resume (counted), never raises."""
    hashes = [int(h) for h in (manifest.get("hashes") or [])]
    if not hashes or tier is None:
        return 0
    inj = rz_faults.get()
    if inj.active and inj.should_fail(rz_faults.MIGRATE_RESTORE):
        # chaos site: the restore is refused; the resume recomputes
        log.warning("migrate: injected migrate.restore fault — resume "
                    "will recompute")
        stats.count_fallback()
        return 0
    restored = 0
    if entries:
        try:
            restored = publish_run(tier, hashes, entries)
        except Exception:
            log.warning("migrate: shipped blocks rejected — resume "
                        "degrades toward recompute", exc_info=True)
            stats.count_fallback()
    if restored < len(hashes):
        src = str(manifest.get("source_url") or "")
        if src and kvnet is not None:
            # warm recompute on the peer: the draining pod holds
            # /kv/blocks open while its budget lasts (fetch_run never
            # raises and counts its own fallbacks)
            restored = max(restored, kvnet.fetch_run(src, hashes))
    return restored


# -- peer selection (draining pod) --------------------------------------------

def migration_enabled() -> bool:
    """Is the drain's migrate phase armed? ``SHAI_MIGRATE=1``, a pinned
    peer (``SHAI_MIGRATE_PEER_URL``) or a fleet URL
    (``SHAI_MIGRATE_FLEET_URL``) arm it; off by default, so a pod outside
    a migration-aware fleet keeps the wait-then-stop drain."""
    return bool(env_bool("SHAI_MIGRATE", False)
                or (env_str("SHAI_MIGRATE_PEER_URL", "") or "").strip()
                or (env_str("SHAI_MIGRATE_FLEET_URL", "") or "").strip())


def _fleet_snapshot(fleet_url: str) -> Optional[Dict[str, Any]]:
    """``GET <fleet_url>/fleet`` as a dict (5 s, ``MAX_ACK_BYTES``), or
    None on any failure."""
    parts, conn = http_connection(f"{fleet_url.rstrip('/')}/fleet", 5.0)
    try:
        conn.request("GET", parts.path)
        r = conn.getresponse()
        if r.status != 200:
            return None
        snap = json.loads(r.read(MAX_ACK_BYTES + 1))
        return snap if isinstance(snap, dict) else None
    finally:
        conn.close()


def resolve_migrate_peers(own_url: str = "", limit: int = 3) -> List[str]:
    """Candidate ship targets, best first: ``SHAI_MIGRATE_PEER_URL`` wins
    (pinned, the sole candidate); otherwise the fleet controller's
    ``/fleet`` named by ``SHAI_MIGRATE_FLEET_URL`` gives up to ``limit``
    serving, non-overloaded, decode-capable pods other than this one. An
    empty list is the ladder's cold rung."""
    peer = (env_str("SHAI_MIGRATE_PEER_URL", "") or "").strip()
    if peer:
        return [peer]
    fleet_url = (env_str("SHAI_MIGRATE_FLEET_URL", "") or "").strip()
    if not fleet_url:
        return []
    out: List[str] = []
    try:
        snap = _fleet_snapshot(fleet_url)
        if snap is None:
            return []
        urls = snap.get("urls") or {}
        overloaded = set(snap.get("overloaded") or ())
        roles = snap.get("roles") or {}
        own = own_url.rstrip("/")
        for role in ("decode", "both"):
            for name in (roles.get(role) or {}).get("serving") or []:
                u = str(urls.get(name) or "")
                if u and name not in overloaded and u.rstrip("/") != own \
                        and u not in out:
                    out.append(u)
                    if len(out) >= max(1, limit):
                        return out
    except Exception:
        log.warning("migrate: fleet peer discovery failed", exc_info=True)
    return out


def resolve_migrate_peer(own_url: str = "") -> str:
    """The single best ship target; ``""`` = no peer."""
    peers = resolve_migrate_peers(own_url, limit=1)
    return peers[0] if peers else ""


def migrate_reserve_s(budget_s: float) -> float:
    """Seconds of the drain budget reserved for the migrate phase: the
    drain waits ``budget - reserve`` for natural completion first, so
    short requests still finish in place and only the long tail ships.
    ``SHAI_MIGRATE_RESERVE_S`` (default 5, lenient), capped at half the
    budget."""
    return max(0.0, min(env_float("SHAI_MIGRATE_RESERVE_S", 5.0),
                        budget_s * 0.5))
