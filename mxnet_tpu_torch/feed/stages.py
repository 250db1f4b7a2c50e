"""Concrete feed-pipeline stages (counterpart of
``mxnet_tpu/feed/stages.py``).

    SourceStage        records/batches out of an iterable or DataIter
    MapStage           N parallel workers, ORDER-PRESERVING (decode/augment)
    BatchStage         item accumulation into padded fixed-size batches
    StagingStage       copy into a reusable ring of host buffers, pinned
                       (page-locked) when the batches go on to a card
    DevicePutStage     the non-blocking host-to-device copy, on a copy
                       stream of its own, with one event per batch

All of them ride the Stage/BoundedQueue machinery in pipeline.py: bounded
output queues give backpressure, epoch-end sentinels flow in-band, worker
exceptions are forwarded to the consumer.

On the card the two last stages hand each batch across streams: the copy
runs on the h2d stage's stream and records an event; ``Pipeline.get``
(the consumer's thread) makes the consumer's current stream wait on it
and records that stream on every tensor (``claim``), so the caching
allocator keeps the batch's blocks until the step that reads them is
done.  The same event guards the pinned ring slot the copy read:
StagingStage waits on it before it refills the slot.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from .pipeline import (BoundedQueue, EndOfEpoch, EndOfStream, QueueClosed,
                       Stage, StageError)

__all__ = ["SourceStage", "MapStage", "BatchStage", "StagingStage",
           "DevicePutStage", "StagedBatch", "CopyStream", "claim",
           "claim_tensors", "resolve_device"]


class SourceStage(Stage):
    """Head of the pipeline: drains an iterable (or DataIter-protocol
    object with reset()/next()) and emits its items, then an
    :class:`EndOfEpoch` sentinel, then starts the next epoch — the next
    epoch's decode work overlaps the consumer's epoch boundary (eval,
    checkpointing).  ``max_epochs=None`` loops until the pipeline closes;
    backpressure keeps it from running more than a queue ahead."""

    def __init__(self, source, max_epochs: Optional[int] = None,
                 name: str = "source"):
        super().__init__(name)
        self._source = source
        self._max_epochs = max_epochs

    def _epoch_items(self, epoch: int) -> Iterable[Any]:
        src = self._source
        if callable(src) and not hasattr(src, "next"):
            return src()                       # factory: fresh per epoch
        if hasattr(src, "reset") and hasattr(src, "next"):
            if epoch > 0:
                src.reset()
            return iter(src)                   # DataIter protocol
        if epoch > 0:
            raise RuntimeError(
                "source %r is a one-shot iterable; pass a factory or a "
                "resettable DataIter for multi-epoch feeding" % (src,))
        return iter(src)

    def run(self):
        epoch = 0
        while self._max_epochs is None or epoch < self._max_epochs:
            it = iter(self._epoch_items(epoch))
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                self.stats.add_items(1, time.perf_counter() - t0)
                self.out_q.put(item)
            self.out_q.put(EndOfEpoch(epoch))
            epoch += 1
        self.out_q.put(EndOfStream())


class MapStage(Stage):
    """Order-preserving parallel map (the decode/augment workers).

    A dispatcher thread pulls items and submits them to a worker pool;
    futures enter a bounded ticket queue IN SUBMISSION ORDER and an
    emitter thread resolves them in that order into the output queue — so
    N workers overlap the work, batches still arrive in sequence (the
    same reorder discipline as the native loader's sequence window), and
    the ticket queue bounds how far workers run ahead (backpressure).
    """

    def __init__(self, fn: Callable[[Any], Any], workers: int = 4,
                 name: str = "map"):
        super().__init__(name)
        assert workers >= 1
        self._fn = fn
        self._workers = workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self._tickets: Optional[BoundedQueue] = None
        self._stopped = False

    def start(self):
        self._pool = ThreadPoolExecutor(
            self._workers, thread_name_prefix="feed-%s-w" % self.name)
        self._tickets = BoundedQueue(self._workers * 2)
        t = threading.Thread(target=self._emit_loop,
                             name="feed-%s-emit" % self.name, daemon=True)
        self._threads.append(t)
        t.start()
        super().start()        # dispatcher runs the base run() loop

    def _timed_fn(self, item):
        t0 = time.perf_counter()
        out = self._fn(item)
        return out, time.perf_counter() - t0

    def run(self):             # dispatcher
        while True:
            item = self.in_q.get()
            if isinstance(item, (EndOfEpoch, EndOfStream, StageError)):
                self._tickets.put(item)
                continue
            self._tickets.put(self._pool.submit(self._timed_fn, item))

    def _emit_loop(self):
        try:
            while True:
                ticket = self._tickets.get()
                if isinstance(ticket, (EndOfEpoch, EndOfStream, StageError)):
                    self.out_q.put(ticket)
                    continue
                try:
                    out, busy = ticket.result()
                except BaseException as exc:    # noqa: BLE001 — in-band
                    self._emit_error(exc)
                    return
                self.stats.add_items(1, busy)
                self.out_q.put(out)
        except QueueClosed:
            pass

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        if self._tickets is not None:
            self._tickets.close()
        if self._pool is not None:
            try:
                self._pool.shutdown(wait=False, cancel_futures=True)
            except TypeError:                   # pre-3.9 signature
                self._pool.shutdown(wait=False)


class BatchStage(Stage):
    """Assemble items into fixed-size batches.

    Items are tuples of numpy-stackable fields, e.g. ``(img_chw, label)``.
    Output is ``(stacked_field_0, ..., stacked_field_n, pad)`` where the
    final partial batch of an epoch wraps around to the epoch's first
    items and reports the wrapped row count as ``pad`` (the reference
    round_batch/pad contract).  ``partial="drop"`` discards it instead.
    """

    def __init__(self, batch_size: int, partial: str = "pad",
                 name: str = "batch"):
        super().__init__(name)
        assert partial in ("pad", "drop")
        self.batch_size = batch_size
        self.partial = partial
        self._acc: list = []
        self._epoch_head: list = []   # first batch_size items, for padding

    def process(self, item):
        self._acc.append(item)
        if len(self._epoch_head) < self.batch_size:
            self._epoch_head.append(item)
        if len(self._acc) == self.batch_size:
            out = self._collate(self._acc, pad=0)
            self._acc = []
            return out
        return None

    def flush(self):
        acc, self._acc = self._acc, []
        head, self._epoch_head = self._epoch_head, []
        if not acc:
            return
        pad = self.batch_size - len(acc)
        if self.partial == "drop":
            return
        fill = (head or acc)
        i = 0
        while len(acc) < self.batch_size:
            acc.append(fill[i % len(fill)])
            i += 1
        self.out_q.put(self._collate(acc, pad=pad))
        self.stats.add_items(self.batch_size)

    def _collate(self, items, pad: int):
        if isinstance(items[0], (tuple, list)):
            fields = tuple(np.stack([np.asarray(it[f]) for it in items])
                           for f in range(len(items[0])))
            return fields + (pad,)
        return (np.stack([np.asarray(it) for it in items]), pad)

    def count(self, out):
        return self.batch_size


def _map_arrays(obj, fn):
    """Apply fn to every array-like leaf of a batch tuple/list, passing
    scalars (e.g. the trailing pad int) through untouched."""
    if isinstance(obj, (tuple, list)):
        return tuple(_map_arrays(o, fn) for o in obj) \
            if isinstance(obj, tuple) else [_map_arrays(o, fn) for o in obj]
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return fn(obj)
    return obj


def _leaves(obj):
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _leaves(o)]
    return [obj] if hasattr(obj, "shape") and hasattr(obj, "dtype") else []


class RowShard:
    """Where a rank stages its part of a batch cut over a mesh's ``dp``
    axis (``FusedTrainStep.batched_sharding()`` under a named mesh): the
    step's ``device`` and the part, the ``index``-th of ``size`` equal
    row blocks.  :meth:`cut` keeps those rows of every array whose dim 0
    has the batch's size (the first array's) and passes the others
    whole, the rule of the fused step's ``make_batch``; the batch it
    stages says which arrays it cut (``rows_cut``), so ``make_batch``
    does not cut them again.  A megabatch cuts each of its K batches
    before stacking them: its K axis stays whole."""

    __slots__ = ("device", "index", "size")

    def __init__(self, device, index: int, size: int):
        self.device = resolve_device(device)
        self.index = int(index)
        self.size = int(size)

    def __repr__(self):
        return "RowShard(%s, rows %d of %d)" % (self.device, self.index,
                                                self.size)

    def cut(self, arrays):
        """-> (arrays with this rank's rows, a flag per array: cut)."""
        from ..base import MXNetError
        arrays = list(arrays)
        if not arrays or len(arrays[0].shape) < 1:
            return arrays, tuple(False for _ in arrays)
        batch = int(arrays[0].shape[0])
        if batch % self.size:
            raise MXNetError("batch %d is not divisible by the mesh's dp "
                             "axis (%d)" % (batch, self.size))
        n = batch // self.size
        out, flags = [], []
        for a in arrays:
            hit = len(a.shape) >= 1 and int(a.shape[0]) == batch
            flags.append(hit)
            if not hit:
                out.append(a)
            elif isinstance(a, torch.Tensor):
                out.append(a.narrow(0, self.index * n, n))
            elif hasattr(a, "_get"):
                out.append(a._get().narrow(0, self.index * n, n))
            else:
                out.append(np.asarray(a)[self.index * n:(self.index + 1)
                                         * n])
        return out, tuple(flags)


def resolve_device(device) -> torch.device:
    """A Context, ``torch.device``, :class:`RowShard`, device string, or
    None (the current context, read in the calling thread) -> a
    ``torch.device``."""
    from ..context import Context, current_context
    if device is None:
        device = current_context()
    if isinstance(device, RowShard):
        return device.device
    if isinstance(device, Context):
        return device.torch_device()
    return torch.device(device)


class StagedBatch(tuple):
    """A batch tuple out of StagingStage or DevicePutStage.  ``slot`` is
    the ring slot it was staged in (its ``event`` is set by the copy
    that read it); ``ready`` the event of its host-to-device copy, or
    None when nothing is in flight."""

    slot = None
    ready = None
    # a flag per array: holds this rank's rows only (RowShard.cut)
    rows_cut = None


class _Slot:
    __slots__ = ("arrays", "event")

    def __init__(self, arrays):
        self.arrays = arrays
        self.event = None


class CopyStream:
    """How a batch crosses to the card, for DevicePutStage and
    DevicePrefetchIter alike: ``run(dev, fn)`` runs ``fn`` (which issues
    non-blocking host-to-device copies) on a copy stream of its own, made
    at first use, and records one event after it; -> (fn's result, the
    event).  The copies read host memory only, so they wait for nothing
    queued on the card.  On the host ``fn`` runs as it is and the event
    is None."""

    def __init__(self):
        self._stream = None

    def run(self, dev: torch.device, fn: Callable[[], Any]):
        if dev.type != "cuda":
            return fn(), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(self._stream):
            out = fn()
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return out, ev


def claim_tensors(tensors, ev) -> None:
    """Make the calling thread's current stream wait for ``ev`` (the
    copy that made ``tensors``), and record that stream on every tensor
    (the caching allocator then holds their blocks until the work queued
    there has read them)."""
    tensors = [t for t in tensors if t.is_cuda]
    if not tensors:
        return
    stream = torch.cuda.current_stream(tensors[0].device)
    stream.wait_event(ev)
    for t in tensors:
        t.record_stream(stream)


def claim(batch) -> None:
    """:func:`claim_tensors` for a StagedBatch whose copy is in flight
    (``ready``); a no-op for any other batch."""
    ev = getattr(batch, "ready", None)
    if ev is None:
        return
    claim_tensors([t for t in _leaves(batch)
                   if isinstance(t, torch.Tensor)], ev)
    batch.ready = None


class StagingStage(Stage):
    """Copy each batch into a reusable ring of contiguous host buffers.

    With ``pin`` (default: when a card is present) the buffers are
    page-locked tensors, so DevicePutStage's copies out of them run
    asynchronously; a slot is refilled only once the copy that read it
    has completed (its event).  Without it the ring holds numpy arrays,
    as the reference's does.  ``ring_size`` must exceed the downstream
    queue depth plus in-flight consumers, or a slot would be overwritten
    while a consumer of the host batch still reads it.
    """

    def __init__(self, ring_size: int = 8, pin: Optional[bool] = None,
                 name: str = "staging"):
        super().__init__(name)
        self._ring_size = ring_size
        self._pin = pin
        self._ring: list = []
        self._slot = 0

    def _alloc(self, a):
        if self._pin:
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            return torch.empty(tuple(a.shape), dtype=dtype, pin_memory=True)
        return np.empty(a.shape, a.dtype)

    def process(self, batch):
        if self._pin is None:
            self._pin = torch.cuda.is_available()
        if not self._ring:
            self._ring = [_Slot(_map_arrays(batch, self._alloc))
                          for _ in range(self._ring_size)]
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % self._ring_size
        if slot.event is not None:
            # the copy that last read this slot must have landed
            slot.event.synchronize()
            slot.event = None

        def pair_copy(dst, src):
            if isinstance(src, (tuple, list)):
                return tuple(pair_copy(d, s) for d, s in zip(dst, src))
            if hasattr(src, "shape") and hasattr(src, "dtype"):
                src = np.asarray(src)
                view = dst.numpy() if isinstance(dst, torch.Tensor) else dst
                if view.shape != src.shape or view.dtype != src.dtype:
                    return np.ascontiguousarray(src)   # shape drift: copy
                np.copyto(view, src)
                return dst
            return src
        out = StagedBatch(pair_copy(slot.arrays, batch))
        out.slot = slot
        return out

    def count(self, out):
        lead = out[0] if isinstance(out, (tuple, list)) else out
        return int(lead.shape[0]) if hasattr(lead, "shape") and \
            len(lead.shape) >= 1 else 1


class DevicePutStage(Stage):
    """Issue the host-to-device copy of every array in the batch.

    ``device`` is a Context, a ``torch.device`` or a zero-arg callable
    returning one (e.g. ``lambda: mod._fused.batched_sharding()``); None
    is the current context of the thread that builds the stage.  On the
    card the copies run non-blocking on this stage's own stream and one
    event is recorded after them: the batch carries it as ``ready``
    (Pipeline.get makes the consumer wait on it) and its ring slot as
    ``event`` (StagingStage waits on it before refilling).  By the time
    the consumer's step reads the batch, the copy has had a pipeline
    stage of time to land under the previous step.  On the host the
    arrays are copied into new tensors."""

    def __init__(self, device=None, name: str = "h2d"):
        super().__init__(name)
        self._device = device if callable(device) or \
            isinstance(device, RowShard) else resolve_device(device)
        self._copies = CopyStream()

    def process(self, batch):
        target = self._device() if callable(self._device) \
            else self._device
        dev = resolve_device(target)
        slot = getattr(batch, "slot", None)
        cut = None
        if isinstance(target, RowShard):
            # only this rank's rows cross to the card
            leaves, cut = target.cut(_leaves(batch))
            it = iter(leaves)
            batch = _map_arrays(tuple(batch), lambda a: next(it))
        self.stats.add_bytes(sum(int(a.nbytes) for a in _leaves(batch)))

        def put(a):
            if dev.type != "cuda":
                if isinstance(a, torch.Tensor):
                    return a.to(dev, copy=True)
                return torch.from_numpy(np.array(a, copy=True)).to(dev)
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            return a.to(dev, non_blocking=True)
        out, ev = self._copies.run(
            dev, lambda: StagedBatch(_map_arrays(tuple(batch), put)))
        out.rows_cut = cut
        if ev is not None:
            out.ready = ev
            if slot is not None:
                slot.event = ev
        return out

    def count(self, out):
        lead = out[0] if isinstance(out, (tuple, list)) else out
        return int(lead.shape[0]) if hasattr(lead, "shape") and \
            len(lead.shape) >= 1 else 1
