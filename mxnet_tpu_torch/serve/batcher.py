"""Dynamic micro-batcher: coalesce concurrent requests into padded batches
(counterpart of ``mxnet_tpu/serve/batcher.py``).

A bounded request deque, ONE dispatcher thread that assembles batches,
and ONE completion thread that finalizes results, connected by a depth-2
handoff queue so the next batch's dispatch overlaps the previous batch's
device-to-host copy.

Flush rules: a batch is dispatched when it reaches ``max_batch_size`` or
when the oldest queued request has waited ``max_delay_ms``, whichever
comes first; the window is further capped by the tightest deadline in
the partial batch.  Already-queued requests are drained greedily.

Admission control happens in the caller's thread inside ``submit``:
validation raises :class:`ServeRequestError` before the request can enter
the queue, and a full queue raises :class:`ServeOverloadError`
immediately.  A client ``fut.cancel()`` on a queued request wins: the
dispatcher claims each future with ``set_running_or_notify_cancel``.

Shutdown: ``close(drain=True)`` stops admissions, drains the queue
(flushing partial batches at once) and joins both threads;
``drain=False`` fails queued requests with :class:`ServeClosedError`.
"""
from __future__ import annotations

import collections
import queue as _queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, List, Optional

from .. import trace as _trace
from ..base import make_condition
from .errors import (ServeClosedError, ServeDeadlineError, ServeError,
                     ServeOverloadError)

__all__ = ["MicroBatcher"]

# dispatcher wakeup period while idle: bounds shutdown latency, not
# request latency (a submit notifies the condition variable directly)
_IDLE_POLL_S = 0.05


def _set_result(fut: Future, result) -> bool:
    """Resolve a future, tolerating a racing client ``cancel()``."""
    try:
        fut.set_result(result)
        return True
    except InvalidStateError:
        return False


def _set_exception(fut: Future, exc: BaseException) -> bool:
    try:
        fut.set_exception(exc)
        return True
    except InvalidStateError:
        return False


def _trace_end(req: "_Request", outcome: str) -> None:
    """Close a request's async span on any terminal path (a begin with no
    end renders as an unbounded bar in the dump)."""
    if req.trace_id is not None and _trace.enabled():
        _trace.async_end("serve:request", req.trace_id, cat="serve",
                         outcome=outcome)


class _Request:
    __slots__ = ("data", "future", "enqueue_t", "deadline_t", "trace_id")

    def __init__(self, data, future, enqueue_t, deadline_t, trace_id=None):
        self.data = data
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        # the async span's id across the three threads the request
        # crosses: submit, dispatch, resolve
        self.trace_id = trace_id


class MicroBatcher:
    """Request queue + dispatcher/completion threads around two engine
    callbacks (and an optional ``on_start()`` the dispatcher runs before
    its first batch; the constructor waits for it and re-raises its
    error):

    ``run_batch(requests) -> handoff``
        Runs inference on the dispatcher thread; should START the
        device-to-host copy and return without blocking on it.
    ``finish(handoff) -> [result, ...]``
        Runs on the completion thread; blocks on the copy and returns
        one result per request, in order.
    """

    def __init__(self, run_batch: Callable, finish: Callable, *,
                 max_batch_size: int, max_delay_ms: float,
                 queue_depth: int, default_deadline_ms: Optional[float] = None,
                 validate: Optional[Callable] = None, stats=None,
                 name: str = "serve", on_start: Optional[Callable] = None):
        if max_batch_size < 1:
            raise ServeError("max_batch_size must be >= 1, got %d"
                             % max_batch_size)
        if queue_depth < 1:
            raise ServeError("queue_depth must be >= 1, got %d" % queue_depth)
        self._run_batch = run_batch
        self._finish = finish
        self._max_batch_size = int(max_batch_size)
        self._max_delay_s = float(max_delay_ms) / 1000.0
        self._queue_depth = int(queue_depth)
        self._default_deadline_ms = default_deadline_ms
        self._validate = validate
        self._stats = stats
        self.name = name
        self._q: collections.deque = collections.deque()
        self._cv = make_condition("serve.batcher")
        self._closed = False
        # depth-2 handoff: the dispatcher may run one batch ahead of the
        # completion thread (overlap), then backpressures
        self._done_q: _queue.Queue = _queue.Queue(maxsize=2)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="%s-dispatch" % name,
            daemon=True)
        self._completer = threading.Thread(
            target=self._complete_loop, name="%s-complete" % name,
            daemon=True)
        self._on_start = on_start
        self._start_error: Optional[BaseException] = None
        self._started = threading.Event()
        self._dispatcher.start()
        self._completer.start()
        if on_start is not None:
            self._started.wait()
            if self._start_error is not None:
                self.close()
                raise self._start_error

    # -- client side -------------------------------------------------------
    def submit(self, data, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future resolving to its result.

        Raises ServeRequestError (malformed), ServeOverloadError (queue
        full) or ServeClosedError, all immediately, in this thread."""
        if self._validate is not None:
            data = self._validate(data)
        dl = self._default_deadline_ms if deadline_ms is None else deadline_ms
        now = time.perf_counter()
        traced = _trace.enabled()
        req = _Request(data, Future(), now, now + dl / 1000.0 if dl else None,
                       trace_id=_trace.next_async_id() if traced else None)
        if traced:
            # before the queue append: once the dispatcher sees the
            # request it may record the end
            _trace.async_begin("serve:request", req.trace_id, cat="serve")
        with self._cv:
            if self._closed:
                _trace_end(req, "closed")
                raise ServeClosedError(
                    "serve engine %r is closed" % self.name)
            if len(self._q) >= self._queue_depth:
                if self._stats is not None:
                    self._stats.on_overload()
                _trace_end(req, "overloaded")
                raise ServeOverloadError(
                    "serve queue full (%d queued, depth %d): shed load or "
                    "retry with backoff" % (len(self._q), self._queue_depth))
            self._q.append(req)
            if self._stats is not None:
                self._stats.on_submit(len(self._q))
            self._cv.notify()
        return req.future

    def queue_depth(self) -> int:
        """Requests waiting in the queue now."""
        with self._cv:
            return len(self._q)

    # -- dispatcher thread -------------------------------------------------
    def _gather(self) -> Optional[List[_Request]]:
        """Assemble one batch honoring the flush rules; None on
        closed-and-drained."""
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait(_IDLE_POLL_S)
            if not self._q:
                return None
            batch = [self._q.popleft()]
        while True:
            # cancelled requests neither fill the batch nor cap the window:
            # backfill their slots from the queue first
            with self._cv:
                live = [r for r in batch if not r.future.cancelled()]
                while self._q and len(live) < self._max_batch_size:
                    r = self._q.popleft()
                    batch.append(r)
                    if not r.future.cancelled():
                        live.append(r)
            if len(live) >= self._max_batch_size:
                break
            flush_at = (live[0] if live else batch[0]).enqueue_t \
                + self._max_delay_s
            for r in live:
                if r.deadline_t is not None and r.deadline_t < flush_at:
                    flush_at = r.deadline_t
            timeout = flush_at - time.perf_counter()
            if timeout <= 0:
                break
            with self._cv:
                if not self._q:
                    if self._closed:
                        break       # draining: flush partial batches now
                    self._cv.wait(timeout)
        return batch

    def _dispatch_loop(self) -> None:
        if self._on_start is not None:
            # per-thread device state (library handles, pinned buffers)
            # is created here, by the thread that will run the batches
            try:
                self._on_start()
            except BaseException as e:
                self._start_error = e
            self._started.set()
            if self._start_error is not None:
                self._done_q.put(None)
                return
        while True:
            batch = self._gather()
            if batch is None:
                if self._stats is not None:
                    with self._cv:
                        self._stats.set_queue_depth(0)
                break
            if self._stats is not None:
                with self._cv:
                    self._stats.set_queue_depth(len(self._q))
            now = time.perf_counter()
            live = []
            cancelled = 0
            for r in batch:
                if not r.future.set_running_or_notify_cancel():
                    cancelled += 1
                    _trace_end(r, "cancelled")
                elif r.deadline_t is not None and now > r.deadline_t:
                    if self._stats is not None:
                        self._stats.on_expired(1)
                    _trace_end(r, "expired")
                    _set_exception(r.future, ServeDeadlineError(
                        "deadline exceeded: %.1f ms in queue against a "
                        "%.1f ms deadline"
                        % ((now - r.enqueue_t) * 1e3,
                           (r.deadline_t - r.enqueue_t) * 1e3)))
                else:
                    live.append(r)
            if cancelled and self._stats is not None:
                self._stats.on_cancelled(cancelled)
            if not live:
                continue
            if _trace.enabled():
                for r in live:
                    if r.trace_id is not None:
                        _trace.async_instant("serve:request", r.trace_id,
                                             cat="serve", at="dispatch",
                                             batch=len(live))
            try:
                handoff = self._run_batch(live)
            except BaseException as e:     # engine bug: fail the batch,
                self._fail(live, e)        # never wedge the loop
                continue
            self._done_q.put((live, handoff))
        self._done_q.put(None)

    # -- completion thread -------------------------------------------------
    def _complete_loop(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                break
            live, handoff = item
            try:
                results = list(self._finish(handoff))
            except BaseException as e:
                self._fail(live, e)
                continue
            if len(results) != len(live):
                self._fail(live, ServeError(
                    "engine returned %d results for a %d-request batch"
                    % (len(results), len(live))))
                continue
            now = time.perf_counter()
            lat = []
            traced = _trace.enabled()
            for r, res in zip(live, results):
                if _set_result(r.future, res):
                    lat.append((now - r.enqueue_t) * 1e3)
                if traced:
                    _trace_end(r, "resolved")
            if self._stats is not None:
                self._stats.on_complete(lat)

    def _fail(self, reqs: List[_Request], exc: BaseException) -> None:
        if self._stats is not None:
            self._stats.on_failed(len(reqs))
        if not isinstance(exc, Exception):
            exc = ServeError("serve worker died: %r" % (exc,))
        for r in reqs:
            _set_exception(r.future, exc)
            _trace_end(r, "failed")

    # -- lifecycle ---------------------------------------------------------
    def is_worker_thread(self) -> bool:
        return threading.current_thread() in (self._dispatcher,
                                              self._completer)

    def request_close(self, drain: bool = True) -> None:
        """Stop admissions and ask the workers to shut down without
        joining them (safe from the worker threads).  Idempotent."""
        with self._cv:
            self._closed = True
            dropped = [] if drain else list(self._q)
            if not drain:
                self._q.clear()
                if self._stats is not None:
                    self._stats.set_queue_depth(0)
            self._cv.notify_all()
        failed = cancelled = 0
        for r in dropped:
            _trace_end(r, "closed")
            if _set_exception(r.future, ServeClosedError(
                    "serve engine %r closed before this request was "
                    "dispatched" % self.name)):
                failed += 1
            else:
                cancelled += 1
        if self._stats is not None:
            if failed:
                self._stats.on_failed(failed)
            if cancelled:
                self._stats.on_cancelled(cancelled)

    def close(self, drain: bool = True) -> None:
        """Stop admissions; drain (default) or fail queued requests; join
        both worker threads.  From a worker thread this only requests
        the shutdown."""
        self.request_close(drain=drain)
        if self.is_worker_thread():
            return
        self._dispatcher.join()
        self._completer.join()
