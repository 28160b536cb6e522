"""Serving one unit over tensor-parallel ranks: the leader owns HTTP, the
other ranks mirror every call that reaches the device.

Port of ``scalable_hw_agnostic_inference_tpu/serve/multihost.py``
(``MultihostDriver``: ``wrap_leader``, ``shutdown``, ``follower_loop``;
``serve_multihost``) onto ``torch.distributed`` ranks, one process a rank,
each owning one card (``parallel.distributed``). The ranks of a unit must
enter the same collectives in the same order, so, as in the reference:

- **global rank 0 (the leader)** runs the normal HTTP surface; each call
  of the service's ``mirror_methods`` (the lowest entries through which
  requests reach the device: ``generate_text`` for the ``llama`` unit) is
  broadcast to every rank before it runs, under one lock, so all ranks see
  the calls in one order. Warmup runs after the wrap, so it is mirrored;
- **every other rank (a follower)** loads its shard, then loops on the
  broadcasts, running the identical call. An ``HTTPError`` there is the
  symmetric host-side rejection the leader raised too before any device
  work: logged, and the loop goes on. Any other exception means this rank
  diverged: it dies. An unmirrored method name is refused. A follower's
  mirrored work traces under the leader's trace id (the call carries the
  W3C ``traceparent``). The ``multihost.mirror`` fault site drops a
  broadcast (the leader then runs alone).

Layout (``core.mesh.rank_layout``): ``MESH_SPEC=tp=N`` on one host runs N
ranks there; with ``SHAI_COORDINATOR``, ``SHAI_NUM_PROCESSES`` and
``SHAI_PROCESS_ID`` (``core.device.distributed_env``) each host runs
``tp / SHAI_NUM_PROCESSES`` local ranks, global rank ``process_id * local
+ local_rank``, and the group's ``TCPStore`` is served at the coordinator
by global rank 0. A host's main process is its local rank 0; it spawns
the others as child processes, which bind no port and spawn nothing. On
host 0 the main process is the leader; on any other host it is a follower
that binds ``/health``, ``/readiness`` and an empty ``/metrics``, as the
reference's follower does. The leader answers ``/readiness`` only after
every rank has loaded (a gather of each rank's boot seconds over the
control group, :attr:`UnitRanks.boot`).

Departures from the reference:

- one process a rank, where the reference runs one process a host and
  lays its devices out as one mesh;
- the mirror travels over the group's gloo control group
  (``DistGroup.broadcast``), where the reference publishes into the
  coordination service's KV store; no device collective carries control;
- fail-together is explicit. The reference relies on the coordination
  service's heartbeat to kill every process when one dies; here each
  host's main process watches its local ranks every :data:`WATCH_S`
  seconds, a child rank watches its parent, and a leader whose mirrored
  call (its broadcast included) raises anything but an ``HTTPError``
  fails the unit: ``/readiness`` goes 503, and :data:`FAIL_GRACE_S`
  later the process kills its local ranks and exits with
  :data:`FAIL_EXIT`. A rank whose peer process ended sees its next
  collective or control broadcast raise at once (the transport's
  connection closes) and dies too. A peer lost without a word (a host
  lost, a partition) closes nothing, so the leader beats: once every
  rank has loaded it broadcasts a no-op every :data:`BEAT_S` seconds
  while no call holds the mirror, and every wait on the control group
  is bounded: a follower that hears nothing from the leader for
  :data:`BEAT_MISSES` beats, a leader whose broadcast (a beat among
  them) is not taken within as long, and a follower whose leader has
  not loaded within the group's timeout fail the unit as above. A rank
  left alone in a collective (a dropped mirror) raises when the compute
  group's timeout, :data:`TP_TIMEOUT_S`, ends, unless its peers, who
  heard no beat meanwhile, ended first.

After ``shutdown`` every rank reports what it mirrored
(:attr:`UnitRanks.mirrored`).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import multiprocessing
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import trace as obs_trace
from ..parallel.distributed import DistGroup, end_rank, init_group
from ..resilience import faults as rz_faults
from ..utils.env import env_str
from .asgi import HTTPError

log = logging.getLogger(__name__)

_OP_SHUTDOWN = 0
_OP_CALL = 1
_OP_BEAT = 2

#: the exit code of a rank's process that fails together with its unit
FAIL_EXIT = 3
#: seconds ``/readiness`` answers 503 before a failed unit's process exits
FAIL_GRACE_S = 1.0
#: how often a host's main process polls its local ranks (and a child
#: rank its parent)
WATCH_S = 0.2
#: the compute group's collective (and rendezvous) timeout, in seconds;
#: it also bounds how long a loaded follower waits for the leader's load
TP_TIMEOUT_S = 300.0
#: seconds between two of the leader's beats
BEAT_S = 5.0
#: beats a rank may miss: a control broadcast that does not complete
#: within ``BEAT_MISSES * beat_s`` fails the unit
BEAT_MISSES = 6


def _exit_process(reason: str) -> None:
    """A bare driver's fail-together: end this process now."""
    log.error("failing together: %s", reason)
    sys.stderr.flush()
    os._exit(FAIL_EXIT)


@contextlib.contextmanager
def _bounded(seconds: Optional[float], what: str,
             on_fail: Callable[[str], None]):
    """Run the block; if it has not ended ``seconds`` after it began (None:
    never), call ``on_fail`` from a timer thread (the block, blocked in a
    transport, is not interrupted: ``on_fail`` ends the process)."""
    if seconds is None:
        yield
        return
    timer = threading.Timer(seconds, on_fail, args=(
        f"{what}: no word within {seconds:g} s",))
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


class MultihostDriver:
    """Request mirroring over ``group``'s control group, at the service's
    ``mirror_methods``. ``trace_sink(trace_dict)`` receives each completed
    follower-side mirror trace (None: dropped). ``on_fail(reason)`` runs
    when the leader's mirrored call raises anything but an ``HTTPError``,
    or a bounded control wait runs out (default: the process exits with
    :data:`FAIL_EXIT`). ``beat_s``: the leader's beat (:meth:`start_beats`)
    and, for every broadcast, a bound of ``BEAT_MISSES * beat_s``
    seconds; None: unbounded, with no beats."""

    def __init__(self, service, group: DistGroup,
                 trace_sink: Optional[Callable[[Dict], None]] = None,
                 on_fail: Optional[Callable[[str], None]] = None,
                 beat_s: Optional[float] = None):
        self.service = service
        self.group = group
        self._lock = threading.Lock()
        self.methods = tuple(getattr(service, "mirror_methods", ("infer",)))
        self.trace_sink = trace_sink
        self.on_fail = on_fail or _exit_process
        self.beat_s = beat_s
        self._closed = False
        #: calls mirrored so far, by method: broadcast (the leader) or run
        #: (a follower)
        self.calls: Dict[str, int] = collections.Counter()

    @property
    def bound_s(self) -> Optional[float]:
        """How long one control broadcast may take (None: unbounded)."""
        return None if self.beat_s is None else BEAT_MISSES * self.beat_s

    def _broadcast(self, obj, what: str):
        with _bounded(self.bound_s, what, self.on_fail):
            return self.group.broadcast(obj)

    # -- leader side --------------------------------------------------------
    def wrap_leader(self) -> None:
        """Wrap each mirror method so every call reaches all ranks."""
        for name in self.methods:
            inner = getattr(self.service, name)

            def wrapped(*args, _inner=inner, _name=name, **kwargs):
                with self._lock:
                    # chaos site: a dropped broadcast leaves the leader
                    # alone in the call's collectives until the group's
                    # timeout, or until the followers, who hear no beat
                    # meanwhile, end: either fails the unit together
                    try:
                        if rz_faults.get().should_drop(rz_faults.MIRROR):
                            log.error("fault injection: mirror broadcast "
                                      "for %s DROPPED", _name)
                        else:
                            self._broadcast((_OP_CALL, (
                                _name, args, kwargs,
                                obs_trace.current_traceparent())),
                                f"the mirror of {_name}")
                            self.calls[_name] += 1
                        return _inner(*args, **kwargs)
                    except HTTPError:
                        raise
                    except Exception as e:
                        # a follower is gone (the broadcast raised), or the
                        # followers ran the same call: they raised it too
                        # and died, or they diverged
                        self.on_fail(f"mirrored {_name} raised "
                                     f"{type(e).__name__}: {e}")
                        raise

            setattr(self.service, name, wrapped)

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            self._broadcast((_OP_SHUTDOWN, None), "the shutdown")

    def start_beats(self) -> None:
        """Leader: broadcast a no-op every ``beat_s`` seconds while no
        call holds the mirror, until :meth:`shutdown` (once every rank
        waits on the control group: after the boot). A beat that raises
        fails the unit."""
        def beat():
            while True:
                time.sleep(self.beat_s)
                with self._lock:
                    if self._closed:
                        return
                    try:
                        self._broadcast((_OP_BEAT, None), "a beat")
                    except Exception as e:
                        self.on_fail(f"a beat raised {type(e).__name__}: "
                                     f"{e}")
                        return

        threading.Thread(target=beat, name="mirror-beat",
                         daemon=True).start()

    # -- follower side ------------------------------------------------------
    def follower_loop(self) -> None:
        """Mirror the leader's calls until a shutdown broadcast; an
        ``HTTPError`` is logged and the loop goes on, anything else (an
        unmirrored name among it) raises. A beat is skipped; with
        ``beat_s``, no word from the leader for ``BEAT_MISSES`` beats
        calls ``on_fail``."""
        while True:
            op, msg = self._broadcast(None, "the leader")
            if op == _OP_BEAT:
                continue
            if op == _OP_SHUTDOWN:
                log.info("follower rank %d: shutdown broadcast received",
                         self.group.rank)
                return
            name, args, kwargs, traceparent = msg
            if name not in self.methods:
                log.error("follower: refusing unmirrored method %r", name)
                raise ValueError(f"unmirrored method {name!r}")
            self.calls[name] += 1
            tr = obs_trace.begin_request_trace(
                f"mirror {name}", traceparent, role="follower", method=name)
            try:
                with obs_trace.use_trace(tr):
                    getattr(self.service, name)(*args, **kwargs)
            except HTTPError as e:
                log.info("follower: mirrored %s rejected the payload "
                         "symmetrically (%s) - continuing", name, e)
            except Exception:
                log.exception("follower: mirrored %s diverged - dying so "
                              "the unit fails together", name)
                raise
            finally:
                if tr is not None:
                    tr.close()
                    if self.trace_sink is not None:
                        try:
                            self.trace_sink(tr.to_dict())
                        except Exception:
                            log.exception("mirror trace sink failed")


def _boot(rank: int, group_s: float, t_load: float) -> Dict[str, float]:
    """One rank's boot seconds: joining the group, then loading (from
    ``t_load`` to now)."""
    return {"rank": rank, "group_s": group_s,
            "load_s": time.monotonic() - t_load}


def _watch_parent(parent: int) -> None:
    """A child rank dies with its host's main process."""
    def watch():
        while os.getppid() == parent:
            time.sleep(WATCH_S)
        _exit_process(f"the host's main process {parent} ended")

    threading.Thread(target=watch, name="rank-parent-watch",
                     daemon=True).start()


def _local_rank_main(service, layout, local_rank: int, store: str,
                     backend: str, timeout_s: float, beat_s: float,
                     parent: int) -> None:
    """A child rank of a host: join the group, load, mirror until the
    shutdown, report what it mirrored, then end through
    ``parallel.distributed.end_rank`` (the group left, the streams
    flushed, exit code 0 through ``os._exit``: no interpreter teardown).
    Any failure, or a control wait past its bound, exits with
    :data:`FAIL_EXIT`."""
    logging.basicConfig(level=env_str("LOG_LEVEL", "INFO"),
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    _watch_parent(parent)
    rank = layout.rank(local_rank)
    group = None
    try:
        t0 = time.monotonic()
        group = init_group(layout.tp, rank, store, backend,
                           layout.devices[local_rank], timeout_s)
        service.group = group
        t1 = time.monotonic()
        service.load()
        with _bounded(timeout_s, "the other ranks' load", _exit_process):
            group.gather_objects(_boot(rank, t1 - t0, t1))
        driver = MultihostDriver(service, group, beat_s=beat_s)
        driver.follower_loop()
        with _bounded(driver.bound_s, "the mirrored counts", _exit_process):
            group.gather_objects(dict(driver.calls))
    except BaseException:
        log.exception("rank %d failed", rank)
        sys.stderr.flush()
        os._exit(FAIL_EXIT)
    end_rank(group, 0, FAIL_EXIT)


class UnitRanks:
    """This host's ranks of one unit (:func:`start_ranks`): the group of
    its main process's rank, the driver, the local child ranks and the
    watch over them."""

    def __init__(self, service, layout, group: DistGroup, procs: List,
                 store_dir: Optional[str],
                 on_fail: Optional[Callable[[str], None]],
                 group_s: float = 0.0, timeout_s: float = TP_TIMEOUT_S,
                 beat_s: float = BEAT_S):
        self.service, self.layout, self.group = service, layout, group
        self.procs = procs
        #: seconds this rank took to join the group
        self.group_s = group_s
        self.timeout_s = timeout_s
        self._store_dir = store_dir
        self._on_fail = on_fail
        self._lock = threading.Lock()
        #: the reason the unit failed (None while it serves)
        self.failed: Optional[str] = None
        self.closing = False
        #: every rank's boot seconds, in rank order (after the leader's
        #: load): ``{"rank", "group_s", "load_s"}``
        self.boot: List[Dict[str, float]] = []
        #: every rank's mirrored calls by method, in rank order (after
        #: :meth:`close`)
        self.mirrored: List[Dict[str, int]] = []
        self.driver = MultihostDriver(service, group, on_fail=self.fail,
                                      beat_s=beat_s)
        threading.Thread(target=self._watch, name="rank-watch",
                         daemon=True).start()

    @property
    def leader(self) -> bool:
        return self.group.rank == 0

    def _watch(self) -> None:
        while not self.closing and self.failed is None:
            for r, p in enumerate(self.procs, start=1):
                if p.exitcode is not None and not self.closing:
                    self.fail(f"local rank {r} (pid {p.pid}) exited with "
                              f"code {p.exitcode}")
                    return
            time.sleep(WATCH_S)

    def fail(self, reason: str) -> None:
        """Fail the unit together: readiness 503 now, and (unless the
        caller gave ``on_fail``) the local ranks killed and this process
        ended with :data:`FAIL_EXIT` :data:`FAIL_GRACE_S` later."""
        with self._lock:
            if self.failed is not None or self.closing:
                return
            self.failed = reason
        log.error("unit over %d ranks fails together: %s", self.layout.tp,
                  reason)
        if self._on_fail is not None:
            self._on_fail(reason)
            return

        def end():
            time.sleep(FAIL_GRACE_S)
            for p in self.procs:
                p.kill()
            _exit_process(reason)

        threading.Thread(target=end, name="rank-fail", daemon=True).start()

    def loaded(self, t_load: float) -> None:
        """After this rank's load (begun at ``t_load``): gather every
        rank's boot seconds (each rank arrives here once loaded, within
        the group's timeout), then, on the leader, start the beats."""
        with _bounded(self.timeout_s, "the other ranks' load", self.fail):
            self.boot = self.group.gather_objects(
                _boot(self.group.rank, self.group_s, t_load))
        if self.leader:
            self.driver.start_beats()

    def _mirrored(self) -> None:
        with _bounded(self.driver.bound_s, "the mirrored counts", self.fail):
            self.mirrored = self.group.gather_objects(
                dict(self.driver.calls))

    def follow(self) -> None:
        """A follower host's main rank: mirror until the shutdown, then
        report what it mirrored."""
        self.driver.follower_loop()
        self._mirrored()

    def close(self, timeout_s: float = 60.0) -> None:
        """Leader: broadcast the shutdown and gather what every rank
        mirrored. Every host: join the local ranks (killing any still
        running after ``timeout_s``) and leave the group."""
        self.closing = True
        try:
            if self.leader and self.failed is None:
                self.driver.shutdown()
                self._mirrored()
        finally:
            self.driver._closed = True   # no beat after this
            for p in self.procs:
                p.join(timeout_s)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            self.group.close()
            if self._store_dir is not None:
                shutil.rmtree(self._store_dir, ignore_errors=True)
        bad = [p.exitcode for p in self.procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"local ranks ended badly: exit codes "
                               f"{[p.exitcode for p in self.procs]}")


def start_ranks(cfg, service, backend: Optional[str] = None,
                on_fail: Optional[Callable[[str], None]] = None,
                timeout_s: float = TP_TIMEOUT_S,
                beat_s: float = BEAT_S) -> UnitRanks:
    """Start this host's ranks of ``service`` (not yet loaded) as
    ``cfg``'s ``MESH_SPEC`` and the ``SHAI_COORDINATOR`` contract lay them
    out, and return its main process's :class:`UnitRanks`: local ranks
    1.. spawned (each a copy of the unloaded ``service``), this process
    joined as its host's local rank 0, its group given to the service
    (``service.group``, which the unit's ``load()`` reads). On the leader,
    the mirror methods are wrapped, ``load`` gathers every rank's boot
    once this rank has loaded (and starts the beats), and ``ready_error``
    reports a failed unit. ``backend``: NCCL on the card, gloo on the CPU
    by default; gloo on the card runs every local rank on the unit's
    device (ranks sharing one card). ``on_fail(reason)``: in place of
    ending the process when the unit fails. ``timeout_s``: the group's
    collective and rendezvous timeout. ``beat_s``: the leader's beat.

    The ranks are laid out by the knob the service names
    (``ranks_over``: ``MESH_SPEC`` for the ``t5`` unit, ``SUBMESH`` for
    ``flux``; ``supports_multihost`` implies ``MESH_SPEC``). Only a
    service that declares ``supports_multihost`` runs over several hosts;
    the others run over the local ranks of one host, with the same
    mirror, beat and fail-together.

    Refused before anything is spawned or allocated: every refusal of
    ``serve.units.common.unit_layout`` (several hosts at a unit without
    ``supports_multihost`` among them), a service that lays out no ranks
    at all, and a tp the service's ``check_layout(tp)`` refuses (a head
    count it does not divide)."""
    from .units.common import HOSTS_REFUSED, unit_layout

    multihost = getattr(service, "supports_multihost", False)
    over = getattr(service, "ranks_over", None)
    device, layout = unit_layout(cfg, multihost, backend, over)
    if not (multihost or over):
        raise ValueError(f"{type(service).__name__} {HOSTS_REFUSED}")
    if hasattr(service, "check_layout"):
        # a tp the model cannot split (the t5 and flux units' heads)
        service.check_layout(layout.tp)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    store_dir = None
    if layout.coordinator:
        store = f"tcp://{layout.coordinator}"
    else:
        store_dir = tempfile.mkdtemp(prefix="shai-unit-")
        store = os.path.join(store_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_local_rank_main, name=f"tp-rank-{r}",
                         args=(service, layout, r, store, backend,
                               timeout_s, beat_s, os.getpid()), daemon=True)
             for r in range(1, layout.local)]
    t0 = time.monotonic()
    try:
        for p in procs:
            p.start()
        group = init_group(layout.tp, layout.rank(0), store, backend,
                           layout.devices[0], timeout_s)
    except BaseException:
        for p in procs:
            if p.pid is not None:
                p.kill()
                p.join(5.0)
        if store_dir is not None:
            shutil.rmtree(store_dir, ignore_errors=True)
        raise
    service.group = group
    ranks = UnitRanks(service, layout, group, procs, store_dir, on_fail,
                      time.monotonic() - t0, timeout_s, beat_s)
    log.info("rank %d of %d (%s, host %d of %d), local ranks %s", group.rank,
             layout.tp, backend, layout.host, layout.hosts,
             [p.pid for p in procs])
    if ranks.leader:
        load, ready_error = service.load, service.ready_error

        def load_and_gather():
            t_load = time.monotonic()
            try:
                load()
                ranks.loaded(t_load)
            except BaseException as e:
                ranks.fail(f"load failed: {type(e).__name__}: {e}")
                raise

        service.load = load_and_gather
        service.ready_error = lambda: ranks.failed or ready_error()
        ranks.driver.wrap_leader()
    return ranks


def serve_multihost(cfg, service, backend: Optional[str] = None) -> None:
    """The entry point of a unit over ranks: the leader serves HTTP
    (``serve_forever``) and shuts the followers down when it ends; a
    follower host's main process binds the probes, loads its shard and
    mirrors. Once its ranks are joined and its group left, the process
    ends through ``end_rank`` (exit code 0, no interpreter teardown)."""
    from .app import serve_forever
    from .asgi import App, Response
    from .httpd import Server

    ranks = start_ranks(cfg, service, backend)
    if ranks.leader:
        try:
            serve_forever(cfg, service)
        finally:
            ranks.close()
        end_rank(None)

    probes = App()
    state = {"ready": False}

    @probes.route("/health", methods=("GET",))
    async def health(req):  # noqa: ANN001
        return Response({"status": "ok", "role": "follower",
                         "process": ranks.layout.host,
                         "rank": ranks.group.rank})

    @probes.route("/readiness", methods=("GET",))
    async def readiness(req):  # noqa: ANN001
        if ranks.failed is not None:
            return Response({"status": "failed", "error": ranks.failed},
                            status=503)
        if not state["ready"]:
            return Response({"status": "loading"}, status=503)
        return Response({"status": "ready", "role": "follower"})

    @probes.route("/metrics", methods=("GET",))
    async def metrics(req):  # noqa: ANN001
        # followers serve no requests; an empty exposition keeps the pod
        # template's scrape annotations from generating 404 target errors
        return Response("", media_type="text/plain; version=0.0.4")

    server = Server(probes, port=cfg.port)
    server.start_background()
    try:
        t_load = time.monotonic()
        service.load()
        ranks.loaded(t_load)
        state["ready"] = True
        log.info("follower rank %d: loaded, entering the mirror loop",
                 ranks.group.rank)
        ranks.follow()
    except BaseException as e:
        ranks.fail(f"follower rank {ranks.group.rank}: "
                   f"{type(e).__name__}: {e}")
        threading.Event().wait()   # the fail thread ends the process
    server.stop()
    ranks.close()
    end_rank(None)


__all__ = ["BEAT_MISSES", "BEAT_S", "FAIL_EXIT", "FAIL_GRACE_S",
           "MultihostDriver", "TP_TIMEOUT_S", "UnitRanks", "WATCH_S",
           "serve_multihost", "start_ranks"]
