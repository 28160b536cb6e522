"""Engine loop thread: the bridge between concurrent HTTP and one engine.

Port of ``scalable_hw_agnostic_inference_tpu/engine/loop.py``
(``EngineLoop`` with ``submit``, ``cancel``, ``drain`` and ``stop``). One
daemon thread owns the engine (and through it the device); callers submit
token-id prompts and wait on a future, so concurrent requests coalesce into
the running batch. Fan-out groups and live migration come in later slices.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

from .engine import LLMEngine, SamplingParams

log = logging.getLogger(__name__)


class EngineLoop:
    def __init__(self, engine: LLMEngine, poll_s: float = 0.005):
        self.engine = engine
        # items: (prompt_ids, params, on_token, future)
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
               on_token=None) -> Future:
        """Enqueue a request; the future resolves to a ``Finished``.
        ``on_token`` is called from the loop thread once per output token,
        in order, and must be cheap."""
        if self._stop.is_set():
            raise RuntimeError("engine loop is stopped")
        if self._draining.is_set():
            raise RuntimeError("engine loop is draining")
        fut: Future = Future()
        self._submit_q.put((list(prompt_ids), params or SamplingParams(),
                            on_token, fut))
        # close the put-after-stop window: if the loop died between the
        # check and the put, nobody will ever drain this item
        if self._stop.is_set():
            self._fail_all(RuntimeError("engine loop is stopped"))
        return fut

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
            ids, params, on_token, fut = item
            try:
                rid = self.engine.add_request(ids, params, on_token=on_token)
                with self._futures_lock:
                    self._futures[rid] = fut
            except Exception as e:  # bad request (e.g. empty prompt)
                fut.set_exception(e)
            try:
                item = self._submit_q.get_nowait()
            except queue.Empty:
                return

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
                pending.append(fut)
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
            fin = self.engine.cancel(rid)
            if fin is None:
                continue
            with self._futures_lock:
                self._futures.pop(rid, None)
            if not fut.done():
                fut.set_result(fin)

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                # block for work only when idle; never between engine steps
                self._drain_submissions(block=not self.engine.has_work)
                self._drain_cancels()
                if not self.engine.has_work:
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
        finally:
            # sole cleanup point: runs on clean stop AND on crash
            self._fail_all(RuntimeError("engine loop is stopped"))
