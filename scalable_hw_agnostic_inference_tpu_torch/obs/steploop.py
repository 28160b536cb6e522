"""Engine step telemetry: the counters, gauges and histograms the engine
feeds and ``/stats`` and ``/metrics`` read.

Trimmed port of ``scalable_hw_agnostic_inference_tpu/obs/steploop.py``,
with the reference's names: the TTFT, TPOT, queue-wait and step-gap
histograms over the reference's buckets (``:39``), ``BucketHistogram``,
and on ``StepTelemetry`` ``count_recompile``, ``count_flush`` with
``pipeline_flushes`` and ``flush_reasons`` (whose reasons include
``deadline``), ``count_preemption``, ``count_pad`` (pad-waste accounting
by phase: prefill, chunk, decode, verify), ``record_step`` (the last
step's occupancy and KV gauges, its speculative rollback and ``spec``
counters with the ``spec_acceptance_rate`` gauge),
``warmed_executables``, ``snapshot`` and ``histograms``, which
``serve/metrics.py`` exports; the per-step record ring the flight recorder
dumps (``recent_steps``, each record with its ``finished_ids``), the
watchdog's feed (``last_step_age_s``, ``step_duration_p99``), the bounded
per-tenant attribution (``count_tenant_request``, ``note_tenant_ttft``,
``tenant_snapshot``, ``tenant_histograms``), ``pad_phase_snapshot``, and
the slots the conformance instruments and the KV planes ride on
(``slo``, ``sentinel``, ``hbm``, ``qos_sched``, ``kvtier``, ``kvnet``,
``migrate``, ``kvfabric``). Stdlib only.

One difference from the reference: the async engine's step returns with
a replay still in flight, so :meth:`StepTelemetry.record_step` takes the
stamp of the step's last READBACK (``completed_at``) for the watchdog,
not the return of ``step()``. A step that only enqueued a replay leaves
the watchdog's clock where the last retired step put it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: explicit histogram bounds (seconds). TTFT includes queue time, so its
#: range reaches minutes; TPOT is per-token decode pace (milliseconds).
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0, 60.0)
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0)
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                      5.0, 10.0, 30.0, 60.0)
#: inter-step device gap (seconds): host time between fetching one decode
#: step's results and enqueueing the next decode dispatch. The async
#: pipeline dispatches ahead of the fetch, so steady steps observe
#: (clamped) zero; lock-step observes the full marshal and bookkeeping gap
#: every step.
STEP_GAP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                    0.025, 0.05, 0.1, 0.5)
#: bounded tenant-label cardinality for the per-tenant instruments: later
#: tenants collapse into "other", so a client minting tenant names cannot
#: grow the metric series set without bound
MAX_TENANT_LABELS = 32
_OTHER_TENANT = "other"
_DEFAULT_TENANT = "default"


class BucketHistogram:
    """Thread-safe fixed-bucket histogram (cumulative bucket counts, sum
    and count, Prometheus-shaped)."""

    def __init__(self, bounds: Sequence[float]):
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def snapshot(self) -> Dict[str, Any]:
        """``{"buckets": [(le, cumulative_count), ..., ("+Inf", n)],
        "sum": float, "count": int}``: one locked copy."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        return {"buckets": out + [("+Inf", n)], "sum": total, "count": n}


class StepTelemetry:
    """One engine's step-loop instruments. The engine loop thread writes,
    ``/stats``, ``/metrics``, the watchdog and the flight recorder read;
    every method is thread-safe."""

    def __init__(self, total_blocks: int = 0, max_steps: int = 256) -> None:
        self._lock = threading.Lock()
        self.total_blocks = total_blocks
        # conformance instruments, attached by the engine at construction
        # (obs.slo.SloEngine, obs.sentinel.PerfSentinel, obs.hbm.HbmLedger)
        # and the SHAI_QOS scheduler: riding on this object keeps ONE
        # provider seam feeding /stats, /metrics and /debug/conformance
        self.slo = None
        self.sentinel = None
        self.hbm = None
        self.qos_sched = None
        # the host KV tier (kvtier.pool.HostKVTier) and the kvnet
        # transport counters (kvnet.client.KvNetStats), attached by an
        # engine with a tier: the shai_kvtier_* / shai_kvnet_* families
        # and the /stats sections read them here
        self.kvtier = None
        self.kvnet = None
        # live-migration counters (kvnet.migrate.MigrateStats), attached by
        # every engine: the shai_migrate_* families export wherever a drain
        # can ship or a peer can resume
        self.migrate = None
        # the KV fabric's probe counters (kvnet.directory.KvFabricStats),
        # attached only when the fabric is armed: a fabric-off pod has no
        # kvfabric section and no shai_kvfabric_* family
        self.kvfabric = None
        # per-tenant attribution (bounded: MAX_TENANT_LABELS + "other")
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._tenant_ttft: Dict[str, BucketHistogram] = {}
        self._steps: deque = deque(maxlen=max_steps)
        self.ttft = BucketHistogram(TTFT_BUCKETS)
        self.tpot = BucketHistogram(TPOT_BUCKETS)
        self.queue_wait = BucketHistogram(QUEUE_WAIT_BUCKETS)
        self.step_gap = BucketHistogram(STEP_GAP_BUCKETS)
        self.steps = 0
        self.preemptions = 0
        self.recompiles = 0          # executables built after warmup
        self.requests_finished = 0
        self.warmed_executables = 0  # closed-set size at readiness
        # a tensor-parallel rank's {"size", "rank", "backend", "graphs"}
        # (None on one device): which rank, and captured or eager decode
        self.tp: Optional[Dict[str, Any]] = None
        # async decode pipeline flushes: the in-flight lookahead step was
        # retired early because an event changed the batch composition or
        # the control flow; each one is a serialization point the steady
        # path avoids
        self.pipeline_flushes = 0
        self._flush_reasons: Dict[str, int] = {}
        # pad-waste accounting: per dispatch, the token slots the call
        # walked for real context against shape padding, in total and by
        # phase (prefill, chunk, decode, verify)
        self.pad_tokens = 0
        self.real_tokens = 0
        self.pad_by_phase: Dict[str, int] = {}
        self.real_by_phase: Dict[str, int] = {}
        # last-step gauges (scraped between steps)
        self._gauges: Dict[str, float] = {}
        # the watchdog's feed: monotonic stamp of the last COMPLETED
        # (retired) step; set at construction, so "busy since boot, never
        # stepped" reads as an ever-growing age
        self._last_step_mono = time.monotonic()

    def count_preemption(self) -> None:
        with self._lock:
            self.preemptions += 1

    def count_recompile(self, kind: str = "") -> None:
        with self._lock:
            self.recompiles += 1

    def count_flush(self, reason: str = "") -> None:
        with self._lock:
            self.pipeline_flushes += 1
            if reason:
                self._flush_reasons[reason] = (
                    self._flush_reasons.get(reason, 0) + 1)

    def flush_reasons(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._flush_reasons)

    # -- per-tenant attribution (multi-tenant QoS) -------------------------

    def _tenant_key(self, tenant: str) -> str:
        """Bounded label for ``tenant`` (callers hold ``_lock``)."""
        t = tenant or _DEFAULT_TENANT
        if t in self._tenants or len(self._tenants) < MAX_TENANT_LABELS:
            return t
        return _OTHER_TENANT

    def _tenant_ent(self, tenant: str) -> Dict[str, float]:
        """Counters of ``tenant``'s label (callers hold ``_lock``)."""
        key = self._tenant_key(tenant)
        ent = self._tenants.get(key)
        if ent is None:
            ent = self._tenants[key] = {"requests": 0, "waiting": 0,
                                        "running": 0}
        return ent

    def count_tenant_request(self, tenant: str, priority: str = "") -> None:
        """One request submitted under ``tenant`` (engine ``add_request``);
        ``priority`` additionally buckets the count per class."""
        with self._lock:
            ent = self._tenant_ent(tenant)
            ent["requests"] += 1
            if priority:
                k = f"requests_{priority}"
                ent[k] = ent.get(k, 0) + 1

    def note_tenant_ttft(self, tenant: str, v: float) -> None:
        with self._lock:
            key = self._tenant_key(tenant)
            h = self._tenant_ttft.get(key)
            if h is None:
                h = self._tenant_ttft[key] = BucketHistogram(TTFT_BUCKETS)
        h.observe(v)  # BucketHistogram has its own lock

    def tenant_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant cumulative counts and last-step gauges (the
        engine-side ``/stats`` -> ``qos.tenants`` payload)."""
        with self._lock:
            out = {t: dict(ent) for t, ent in self._tenants.items()}
            hists = list(self._tenant_ttft.items())
        for t, h in hists:
            if t in out:
                snap = h.snapshot()
                out[t]["ttft_count"] = snap["count"]
                if snap["count"]:
                    out[t]["ttft_mean_ms"] = round(
                        snap["sum"] / snap["count"] * 1e3, 3)
        return out

    def tenant_histograms(self) -> Dict[str, Dict[str, Any]]:
        """tenant -> TTFT histogram snapshot (``shai_tenant_ttft_seconds``)."""
        with self._lock:
            hists = list(self._tenant_ttft.items())
        return {t: h.snapshot() for t, h in hists}

    def count_pad(self, real: int, padded: int, phase: str = "") -> None:
        """One dispatch's token-slot accounting: ``real`` context or prompt
        tokens the shapes carried against ``padded`` slots walked only
        because of bucket or batch padding."""
        with self._lock:
            self.real_tokens += max(0, real)
            self.pad_tokens += max(0, padded)
            if phase:
                self.real_by_phase[phase] = (
                    self.real_by_phase.get(phase, 0) + max(0, real))
                self.pad_by_phase[phase] = (
                    self.pad_by_phase.get(phase, 0) + max(0, padded))

    def pad_phase_snapshot(self) -> Dict[str, Dict[str, int]]:
        """phase -> {real, pad} cumulative counts."""
        with self._lock:
            return {p: {"real": self.real_by_phase.get(p, 0),
                        "pad": self.pad_by_phase.get(p, 0)}
                    for p in set(self.real_by_phase)
                    | set(self.pad_by_phase)}

    def record_step(self, *, kind: str, duration_s: float, n_running: int,
                    n_waiting: int, n_chunking: int, blocks_free: int,
                    blocks_evictable: int = 0, finished: int = 0,
                    rollback_tokens: int = 0,
                    spec: Optional[Dict[str, Any]] = None,
                    finished_ids: Sequence[int] = (),
                    tenants: Optional[Dict[str, Sequence[int]]] = None,
                    completed_at: Optional[float] = None) -> None:
        """One engine ``step()`` returned: count it and its finished
        requests, ring its record, and replace the occupancy and KV
        gauges. ``kind`` names the path taken (``"decode"``, ``"spec"``,
        ``"idle"``); ``rollback_tokens`` the speculative reservation given
        back during the step, ``spec`` the engine's cumulative
        ``SpecStats.as_dict()`` (the record's ``spec`` and the
        ``spec_acceptance_rate`` gauge), None without a drafter;
        ``duration_s`` its host seconds, ``finished_ids`` the engine
        request ids that reached a terminal state (the join key with the
        request traces' ``engine_req_id``). ``completed_at``: the
        monotonic stamp of the step's last readback, when a replay is
        still in flight at return (None: the step completed now)."""
        total = self.total_blocks or 1
        used = max(0, total - blocks_free)
        # pressure vs occupancy: evictable prefix-cache blocks are
        # reclaimable (a warm cache legitimately fills the pool), so
        # kv_utilization, the admission and overload signal, counts the
        # blocks live sequences hold; kv_occupancy keeps the raw view
        live = max(0, used - max(0, blocks_evictable))
        rec = {
            "ts": round(time.time(), 4),
            "step": 0,  # filled under the lock below
            "kind": kind,
            "duration_s": round(duration_s, 6),
            "running": n_running,
            "waiting": n_waiting,
            "chunking": n_chunking,
            "finished": finished,
            "kv_blocks_free": blocks_free,
            "kv_blocks_evictable": blocks_evictable,
            "kv_utilization": round(live / total, 4),
            "kv_occupancy": round(used / total, 4),
            "rollback_tokens": rollback_tokens,
            "finished_ids": list(finished_ids),
        }
        if spec:
            rec["spec"] = dict(spec)
        now = time.monotonic() if completed_at is None else completed_at
        with self._lock:
            self.steps += 1
            self.requests_finished += finished
            rec["step"] = self.steps
            rec["preemptions_total"] = self.preemptions
            rec["recompiles_total"] = self.recompiles
            self._steps.append(rec)
            self._gauges = {
                "running": float(n_running),
                "waiting": float(n_waiting),
                "chunking": float(n_chunking),
                "kv_utilization": rec["kv_utilization"],
                "kv_occupancy": rec["kv_occupancy"],
                "kv_blocks_free": float(blocks_free),
                "last_step_duration_s": rec["duration_s"],
            }
            if spec and "spec_acceptance_rate" in spec:
                self._gauges["spec_acceptance_rate"] = float(
                    spec["spec_acceptance_rate"])
            if tenants is not None:
                # replace-the-gauge semantics: a tenant absent this step
                # reads 0 queued/running, but keeps its cumulative counts
                for ent in self._tenants.values():
                    ent["waiting"] = ent["running"] = 0
                for t, (n_wait, n_run) in tenants.items():
                    ent = self._tenant_ent(t)
                    ent["waiting"] = int(n_wait)
                    ent["running"] = int(n_run)
            self._last_step_mono = max(self._last_step_mono, now)

    # -- readouts ----------------------------------------------------------

    def last_step_age_s(self, now: Optional[float] = None) -> float:
        """Seconds since the last completed (retired) engine step (since
        construction when none ran yet): the watchdog's staleness
        signal."""
        with self._lock:
            last = self._last_step_mono
        return max(0.0, (now if now is not None else time.monotonic()) - last)

    def step_duration_p99(self) -> float:
        """p99 of the recent step-duration ring (0.0 with no steps): the
        watchdog's scale for what a normal step costs on this tier."""
        with self._lock:
            durations = sorted(r["duration_s"] for r in self._steps)
        if not durations:
            return 0.0
        return durations[min(len(durations) - 1,
                             int(0.99 * (len(durations) - 1)))]

    def recent_steps(self, n: int = 256) -> List[Dict[str, Any]]:
        with self._lock:
            steps = list(self._steps)
        return steps[-n:]

    def snapshot(self) -> Dict[str, Any]:
        """Flat cumulative snapshot: the source of the ``/metrics`` gauge
        and counter families and of the admission gate's queue and KV
        reads."""
        with self._lock:
            out: Dict[str, Any] = {
                "steps": self.steps,
                "preemptions": self.preemptions,
                "recompiles": self.recompiles,
                "requests_finished": self.requests_finished,
                "warmed_executables": self.warmed_executables,
                "kv_blocks_total": self.total_blocks,
                "pipeline_flushes": self.pipeline_flushes,
                "pad_tokens": self.pad_tokens,
                "real_tokens": self.real_tokens,
            }
            walked = self.pad_tokens + self.real_tokens
            out["pad_fraction"] = (round(self.pad_tokens / walked, 4)
                                   if walked else 0.0)
            out["pad_by_phase"] = {
                p: {"real": self.real_by_phase.get(p, 0),
                    "pad": self.pad_by_phase.get(p, 0)}
                for p in set(self.real_by_phase) | set(self.pad_by_phase)}
            out.update(self._gauges)
        if self.tp is not None:
            out["tp"] = dict(self.tp)
        kvt = self.kvtier
        if kvt is not None:
            # host-tier saturation and hit rate travel with the engine
            # snapshot: the admission gate prices host_kv_utilization
            ksnap = kvt.snapshot()
            out["host_kv_utilization"] = ksnap.get("utilization", 0.0)
            out["host_kv_used_bytes"] = ksnap.get("used_bytes", 0.0)
            out["host_kv_hit_rate"] = ksnap.get("hit_rate", 0.0)
        for name, h in (("ttft", self.ttft), ("tpot", self.tpot),
                        ("queue_wait", self.queue_wait),
                        ("step_gap", self.step_gap)):
            out[f"{name}_count"] = h.count
        return out

    def histograms(self) -> Dict[str, Dict[str, Any]]:
        """Named histogram snapshots for the Prometheus exposition."""
        return {"ttft_seconds": self.ttft.snapshot(),
                "tpot_seconds": self.tpot.snapshot(),
                "queue_wait_seconds": self.queue_wait.snapshot(),
                "step_gap_seconds": self.step_gap.snapshot()}
