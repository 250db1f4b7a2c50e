"""Composable staged input pipeline with bounded queues and backpressure
(counterpart of ``mxnet_tpu/feed/pipeline.py``).

Layout (the TensorFlow-style staged feed, Abadi et al. 1605.08695 §4.2,
mapped onto the reference's iter_prefetcher.h double-buffer idea)::

    SourceStage -> [queue] -> MapStage(N workers) -> [queue] -> BatchStage
                -> [queue] -> ... -> Pipeline.get() / iteration

* every queue is a bounded ring (:class:`BoundedQueue`): a fast producer
  BLOCKS when its consumer falls behind (backpressure), and the blocked
  time is charged to the producer's ``stall_out_s`` counter;
* epoch ends travel IN-BAND as :class:`EndOfEpoch` sentinels through the
  same blocking ``put`` as data items, so a full queue can delay but
  never drop one (the PrefetchingIter.scala single-``offer`` bug class);
* a worker exception is wrapped in :class:`StageError`, forwarded
  downstream in-band, and re-raised at the consumer with the original
  traceback — garbage is never silently delivered;
* :meth:`Pipeline.close` tears the whole graph down without leaking
  threads: queues are closed (waking every blocked put/get), stage
  threads observe the closure and exit, and close() joins them all.
"""
from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Sequence

from .. import trace as _trace
from ..base import make_lock
from .stats import PipelineStats, StageStats

__all__ = ["EndOfEpoch", "EndOfStream", "StageError", "QueueClosed",
           "BoundedQueue", "Stage", "Pipeline"]


class EndOfEpoch:
    """In-band epoch-end sentinel. Flows through every queue like a data
    item; stages flush any partial state (e.g. a half-built batch) before
    forwarding it."""

    __slots__ = ("epoch",)

    def __init__(self, epoch: int):
        self.epoch = epoch

    def __repr__(self):
        return "EndOfEpoch(%d)" % self.epoch


class EndOfStream:
    """In-band end-of-stream marker: the source reached max_epochs.  The
    consumer closes the pipeline on receipt; a get() after that raises
    StopIteration forever instead of blocking on a finished source."""

    __slots__ = ()


class StageError:
    """In-band error marker: carries a worker exception downstream so the
    consumer re-raises it instead of hanging on a dead producer."""

    __slots__ = ("stage", "exc")

    def __init__(self, stage: str, exc: BaseException):
        self.stage = stage
        self.exc = exc


class QueueClosed(Exception):
    """Raised by put()/get() on a closed queue — the thread's signal to
    exit its loop."""


class BoundedQueue:
    """Bounded FIFO with stall accounting and cooperative shutdown.

    ``put`` blocks while full (charging the producer's stall_out), ``get``
    blocks while empty (charging the consumer's stall_in).  ``close()``
    wakes every waiter; a closed queue still drains its remaining items
    (get raises QueueClosed only once empty) so shutdown never loses an
    in-flight sentinel or error marker.
    """

    def __init__(self, capacity: int,
                 producer_stats: Optional[StageStats] = None,
                 consumer_stats: Optional[StageStats] = None):
        assert capacity >= 1
        self.capacity = capacity
        self._items: List[Any] = []
        self._lock = make_lock("feed.pipeline")
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self.producer_stats = producer_stats
        self.consumer_stats = consumer_stats
        if producer_stats is not None:
            producer_stats.wire_queue(self.depth, capacity)

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def put(self, item: Any) -> None:
        t0 = time.perf_counter()
        with self._not_full:
            while len(self._items) >= self.capacity and not self._closed:
                self._not_full.wait(0.1)
            if self._closed:
                raise QueueClosed()
            self._items.append(item)
            self._not_empty.notify()
        if self.producer_stats is not None:
            self.producer_stats.add_stall_out(time.perf_counter() - t0)

    def get(self) -> Any:
        t0 = time.perf_counter()
        with self._not_empty:
            while not self._items and not self._closed:
                self._not_empty.wait(0.1)
            if not self._items:      # closed AND drained
                raise QueueClosed()
            item = self._items.pop(0)
            self._not_full.notify()
        if self.consumer_stats is not None:
            self.consumer_stats.add_stall_in(time.perf_counter() - t0)
        return item

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_full.notify_all()
            self._not_empty.notify_all()


class Stage:
    """One pipeline stage: thread(s) pulling from an input queue, pushing
    to an output queue.  Subclasses implement :meth:`run` (full control)
    or just :meth:`process` (per-item transform).  Sentinels and error
    markers are forwarded by the base loop; stages only see data items.
    """

    def __init__(self, name: str):
        self.name = name
        self.stats: Optional[StageStats] = None   # wired by Pipeline
        self.in_q: Optional[BoundedQueue] = None
        self.out_q: Optional[BoundedQueue] = None
        self._threads: List[threading.Thread] = []

    # -- wiring (Pipeline) ----------------------------------------------
    def _wire(self, in_q, out_q, stats: StageStats):
        self.in_q, self.out_q, self.stats = in_q, out_q, stats

    def start(self) -> None:
        t = threading.Thread(target=self._run_guarded,
                             name="feed-%s" % self.name, daemon=True)
        self._threads.append(t)
        t.start()

    def threads(self) -> Sequence[threading.Thread]:
        return tuple(self._threads)

    def stop(self) -> None:
        """Hook for extra resources (worker pools); queues are closed by
        the Pipeline before this is called."""

    # -- loop ------------------------------------------------------------
    def _run_guarded(self):
        try:
            self.run()
        except QueueClosed:
            pass
        except BaseException as exc:      # noqa: BLE001 — forwarded in-band
            self._emit_error(exc)

    def _emit_error(self, exc: BaseException):
        try:
            self.out_q.put(StageError(self.name, exc))
        except QueueClosed:
            pass

    def run(self):
        while True:
            item = self.in_q.get()
            if isinstance(item, (EndOfEpoch, EndOfStream, StageError)):
                self.flush()
                self.out_q.put(item)
                continue
            t0 = time.perf_counter()
            out = self.process(item)
            dt = time.perf_counter() - t0
            # the stage's busy interval on the trace timeline (stalls
            # show as the gaps between these spans)
            _trace.complete("feed:%s" % self.name, t0, dt, cat="feed")
            if out is not None:
                self.stats.add_items(self.count(out), dt)
                self.out_q.put(out)
            else:
                self.stats.add_items(0, dt)   # absorbed (e.g. accumulating)

    # -- per-item hooks ---------------------------------------------------
    def process(self, item: Any) -> Any:
        raise NotImplementedError()

    def flush(self):
        """Called when an epoch-end (or error) sentinel passes through,
        BEFORE it is forwarded: emit any partial state to out_q here."""

    def count(self, out: Any) -> int:
        """How many logical items `out` represents (stats)."""
        return 1


class Pipeline:
    """Wire stages with bounded queues, run them, iterate the results.

    ``for item in pipeline`` yields one epoch (stops at the sentinel,
    leaving the pipeline running — the next epoch is already decoding in
    the background); :meth:`close` shuts everything down and joins every
    stage thread.  Usable as a context manager.
    """

    def __init__(self, stages: Sequence[Stage], buffer_size: int = 4,
                 name: str = "feed"):
        assert len(stages) >= 1
        self.stages = list(stages)
        self.stats = PipelineStats(name).register()
        self._consumer_stats = self.stats.stage("consume")
        self._queues: List[BoundedQueue] = []
        self._closed = False
        self._error: Optional[BaseException] = None
        self._epoch = 0
        prev_q = None
        for i, st in enumerate(self.stages):
            s_stats = self.stats.stage(st.name)
            nxt = (self.stages[i + 1] if i + 1 < len(self.stages) else None)
            out_q = BoundedQueue(
                getattr(st, "out_capacity", buffer_size),
                producer_stats=s_stats,
                consumer_stats=None)   # consumer side wired below
            self._queues.append(out_q)
            st._wire(prev_q, out_q, s_stats)
            prev_q = out_q
        # each queue's consumer is the NEXT stage (or the pipeline user)
        for q, st in zip(self._queues[:-1], self.stages[1:]):
            q.consumer_stats = st.stats
        self._queues[-1].consumer_stats = self._consumer_stats
        self._out = self._queues[-1]
        for st in self.stages:
            st.start()

    # -- consumption ------------------------------------------------------
    def get(self) -> Any:
        """Next item; raises StopIteration at epoch end, re-raises a
        forwarded stage exception."""
        if self._error is not None:
            raise self._error
        if self._closed:
            raise StopIteration
        try:
            item = self._out.get()
        except QueueClosed:
            raise StopIteration
        if isinstance(item, StageError):
            self._error = item.exc
            self.close()
            raise item.exc
        if isinstance(item, EndOfStream):
            self.close()
            raise StopIteration
        if isinstance(item, EndOfEpoch):
            self._epoch = item.epoch + 1
            raise StopIteration
        if getattr(item, "ready", None) is not None:
            # a batch copied on the h2d stage's stream: order the
            # consumer's stream after the copy (stages.claim)
            from .stages import claim
            claim(item)
        self._consumer_stats.add_items(1)
        return item

    def __iter__(self):
        return self

    def __next__(self):
        return self.get()

    next = get

    @property
    def epochs_consumed(self) -> int:
        return self._epoch

    def resume_at(self, epoch: int) -> None:
        """Align the consumed-epoch counter with a cursor installed
        directly in the head stage (ParallelReader.fast_restore jumps
        the whole pipeline to mid-epoch N without draining epochs
        0..N-1 through it)."""
        self._epoch = int(epoch)

    def report(self):
        return self.stats.report()

    def report_str(self) -> str:
        return self.stats.report_str()

    # -- shutdown ---------------------------------------------------------
    def close(self, join_timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        for st in self.stages:
            st.stop()
        for q in self._queues:
            q.close()
        for st in self.stages:
            for t in st.threads():
                t.join(join_timeout)

    def alive_threads(self) -> List[threading.Thread]:
        return [t for st in self.stages for t in st.threads() if t.is_alive()]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close(join_timeout=1.0)
        except Exception:
            pass
