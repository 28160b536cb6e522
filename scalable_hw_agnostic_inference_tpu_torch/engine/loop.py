"""Engine loop thread: the bridge between concurrent HTTP and one engine.

Port of ``scalable_hw_agnostic_inference_tpu/engine/loop.py``
(``EngineLoop`` with ``submit`` and its deadline and QoS tag,
``submit_group`` for the ``n > 1`` fan-out, ``cancel`` (a member of a
group cancels the group), ``drain`` and ``stop``, and the idle hook
``engine.finish_pending``, which the loop also runs on a clean exit, so a
drained loop leaves no replay in flight). One daemon thread owns the engine (and through
it the device); callers submit token-id prompts and wait on a future, so
concurrent requests coalesce into the running batch. Live migration comes
in a later slice.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

from ..resilience.qos import PRIORITY_NORMAL
from .engine import LLMEngine, SamplingParams

log = logging.getLogger(__name__)


class EngineLoop:
    def __init__(self, engine: LLMEngine, poll_s: float = 0.005):
        self.engine = engine
        # items: (prompt_ids, params, on_token, add_request kwargs, future),
        # or a fan-out group: (prompt_ids, [params], [on_token],
        # add_request kwargs, [future])
        self._submit_q: "queue.Queue[tuple]" = queue.Queue()
        self._futures: dict[int, Future] = {}
        self._futures_lock = threading.Lock()
        self._cancel_q: "queue.Queue[Future]" = queue.Queue()
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread = threading.Thread(target=self._run, name="engine-loop",
                                        daemon=True)

    def start(self) -> "EngineLoop":
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        """True while the loop thread runs and accepts work; a crashed
        ``engine.step()`` stops it (the serving layer turns that into a
        failing ``/readiness``)."""
        return self._thread.is_alive() and not self._stop.is_set()

    def stop(self, timeout: float = 5.0) -> None:
        """Signal the loop to exit; its exit path fails outstanding futures."""
        self._stop.set()
        self._thread.join(timeout)

    def drain(self, budget_s: float = 30.0) -> bool:
        """Refuse new submissions, let in-flight requests finish for up to
        ``budget_s`` seconds, then stop. True when everything finished."""
        self._draining.set()
        deadline = time.monotonic() + max(0.0, budget_s)
        drained = False
        while True:
            with self._futures_lock:
                outstanding = bool(self._futures)
            if (not outstanding and self._submit_q.empty()
                    and not self.engine.has_work):
                drained = True
                break
            if time.monotonic() >= deadline:
                log.warning("drain budget (%.1fs) expired with work in "
                            "flight — stopping anyway", budget_s)
                break
            time.sleep(self._poll_s)
        self.stop()
        return drained

    def submit(self, prompt_ids: Sequence[int],
               params: Optional[SamplingParams] = None,
               on_token=None, deadline_at: float = 0.0,
               priority: int = PRIORITY_NORMAL, tenant: str = "",
               traceparent: str = "", idem_key: str = "") -> Future:
        """Enqueue a request; the future resolves to a ``Finished``.
        ``on_token`` is called from the loop thread once per output token,
        in order, and must be cheap (put onto a queue, nothing more).
        ``deadline_at`` (absolute ``time.monotonic()``, 0 = none),
        ``priority``, ``tenant``, ``traceparent`` and ``idem_key`` go to
        ``LLMEngine.add_request``."""
        if self._stop.is_set():
            raise RuntimeError("engine loop is stopped")
        if self._draining.is_set():
            raise RuntimeError("engine loop is draining")
        fut: Future = Future()
        kw = {"deadline_at": deadline_at, "priority": priority,
              "tenant": tenant}
        # the trace context and idempotency key ride along when present
        kw.update({k: v for k, v in (("traceparent", traceparent),
                                     ("idem_key", idem_key)) if v})
        self._submit_q.put((list(prompt_ids), params or SamplingParams(),
                            on_token, kw, fut))
        # close the put-after-stop window: if the loop died between the
        # check and the put, nobody will ever drain this item
        if self._stop.is_set():
            self._fail_all(RuntimeError("engine loop is stopped"))
        return fut

    def submit_group(self, prompt_ids: Sequence[int],
                     params_list: Sequence[SamplingParams], *,
                     on_tokens: Optional[Sequence] = None,
                     deadline_at: float = 0.0,
                     priority: int = PRIORITY_NORMAL,
                     tenant: str = "", traceparent: str = "") -> List[Future]:
        """The ``n > 1`` fan-out: ONE tokenized prompt, K sampling-param
        sets, K futures. The group rides one queue item, so its members
        are queued together (what lets the engine admit them as one
        prefill with copy-on-write forks under ``SHAI_KV_COW``), under one
        parent id, so cancelling any member cancels the group."""
        if self._stop.is_set():
            raise RuntimeError("engine loop is stopped")
        if self._draining.is_set():
            raise RuntimeError("engine loop is draining")
        futs: List[Future] = [Future() for _ in params_list]
        kw = {"deadline_at": deadline_at, "priority": priority,
              "tenant": tenant}
        if traceparent:
            kw["traceparent"] = traceparent
        self._submit_q.put((list(prompt_ids), list(params_list),
                            list(on_tokens or [None] * len(futs)), kw,
                            futs))
        if self._stop.is_set():
            self._fail_all(RuntimeError("engine loop is stopped"))
        return futs

    def cancel(self, fut: Future) -> None:
        """Ask the loop to abort a submitted request between steps; its
        future resolves with a partial ``"cancelled"`` Finished. A no-op
        when the request already finished."""
        self._cancel_q.put(fut)

    # -- loop --------------------------------------------------------------

    def _drain_submissions(self, block: bool) -> None:
        try:
            item = (self._submit_q.get(timeout=self._poll_s) if block
                    else self._submit_q.get_nowait())
        except queue.Empty:
            return
        while True:
            ids, params, on_token, kw, fut = item
            if isinstance(fut, list):  # a submit_group item
                self._admit_group(ids, params, on_token, kw, fut)
            else:
                self._add(ids, params, on_token, kw, fut)
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                return

    def _add(self, ids, params, on_token, kw, fut) -> Optional[int]:
        """``engine.add_request`` with its future registered; a request it
        refuses (an empty prompt) fails its own future only."""
        try:
            rid = self.engine.add_request(ids, params, on_token=on_token,
                                          **kw)
        except Exception as e:
            fut.set_exception(e)
            return None
        with self._futures_lock:
            self._futures[rid] = fut
        return rid

    def _admit_group(self, ids, params_list, on_tokens, kw, futs) -> None:
        """Queue a fan-out group's members under one parent id: the first
        one queued leads, and its id names the group."""
        parent = -2
        for params, on_token, fut in zip(params_list, on_tokens, futs):
            rid = self._add(ids, params, on_token,
                            dict(kw, parent_rid=parent), fut)
            if rid is not None and parent == -2:
                parent = rid

    def _fail_all(self, err: Exception) -> None:
        """Fail every queued and in-flight future (loop death / stop); the
        futures resolve outside the lock."""
        pending: List[Future] = []
        with self._futures_lock:
            while True:
                try:
                    *_, fut = self._submit_q.get_nowait()
                except queue.Empty:
                    break
                pending.extend(fut if isinstance(fut, list) else [fut])
            pending.extend(self._futures.values())
            self._futures.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(err)

    def _drain_cancels(self) -> None:
        while True:
            try:
                fut = self._cancel_q.get_nowait()
            except queue.Empty:
                return
            with self._futures_lock:
                rid = next((r for r, f in self._futures.items() if f is fut),
                           None)
            if rid is None:
                continue  # already finished (or never admitted)
            # a fan-out group cancels as a unit: its n choices are one
            # response, and a partial group decodes for nobody
            for sib in self.engine.fanout_siblings(rid):
                fin = self.engine.cancel(sib)
                if fin is None:
                    continue
                with self._futures_lock:
                    sfut = self._futures.pop(sib, None)
                if sfut is not None and not sfut.done():
                    sfut.set_result(fin)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                # block for work only when idle; never between engine steps
                self._drain_submissions(block=not self.engine.has_work)
                self._drain_cancels()
                if not self.engine.has_work:
                    # async decode: going idle can leave the final
                    # lookahead step in flight (every slot finished at its
                    # commit); retire it so host mirrors do not sit one
                    # step stale across the idle gap
                    self.engine.finish_pending()
                    continue
                try:
                    for fin in self.engine.step():
                        with self._futures_lock:
                            fut = self._futures.pop(fin.req_id, None)
                        if fut is not None:
                            fut.set_result(fin)
                except Exception:
                    log.exception("engine step failed")
                    self._stop.set()  # a dead loop must refuse submissions
                    raise
            # a clean stop (drain, close) retires the last lookahead, so no
            # replay is left in flight behind the stopped loop
            self.engine.finish_pending()
        finally:
            # sole cleanup point: runs on clean stop AND on crash
            self._fail_all(RuntimeError("engine loop is stopped"))
