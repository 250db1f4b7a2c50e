"""mxnet_tpu_torch.feed: staged prefetch-to-device input pipeline
(counterpart of ``mxnet_tpu/feed/__init__.py``).

The IO side of the "as fast as the hardware allows" story: a composable
staged pipeline (source -> parallel decode workers -> batch assembly ->
host staging ring -> async device prefetch) with bounded ring buffers
between stages, backpressure, an in-band epoch-end sentinel protocol,
graceful shutdown, and per-stage instrumentation (items/sec, queue
depth, producer/consumer stall time) surfaced through
``mx.profiler.feed_report()``.  On the card the host ring is pinned and
each batch's copy runs on the h2d stage's own stream, ordered before the
consumer's step by an event (``stages.py``).

Three entry points, lowest to highest level::

    # raw building blocks
    p = feed.Pipeline([feed.SourceStage(src), feed.MapStage(decode, 4),
                       feed.BatchStage(128), feed.StagingStage(),
                       feed.DevicePutStage(mx.gpu(0))])

    # a full RecordIO->device image pipeline
    it = feed.record_pipeline("train.rec", batch_size=128,
                              data_shape=(3, 224, 224), workers=8)
    mod.fit(it, num_epoch=2)

    # wrap ANY existing DataIter with device prefetch
    mod.fit(train_iter, prefetch_to_device=True, ...)

``print(mx.profiler.feed_report_str())`` then shows which stage starves
the card; ``mx.profiler.dump_trace`` shows each stage's busy spans
(``feed:<stage>``, ``feed:h2d_stage``) and the reader workers' decode
spans on lanes of their own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .augment import AugmentSpec, augment_batch, augment_batch_host, draw
from .parallel import ParallelReader
from .pipeline import (BoundedQueue, EndOfEpoch, EndOfStream, Pipeline,
                       QueueClosed, Stage, StageError)
from .stages import (BatchStage, DevicePutStage, MapStage, RowShard,
                     SourceStage, StagedBatch, StagingStage, resolve_device)
from .staging import (DevicePrefetchIter, MegaBatch, device_feed,
                      stack_batch_arrays)
from .sparse import (PAD_ID, ids_pipeline, make_ids_decode, pad_ids,
                     write_ids_record)
from .stats import PipelineStats, StageStats

__all__ = ["Pipeline", "Stage", "BoundedQueue", "EndOfEpoch", "EndOfStream",
           "StageError", "QueueClosed", "SourceStage", "MapStage",
           "BatchStage", "StagingStage", "DevicePutStage", "RowShard",
           "StageStats", "PipelineStats", "DevicePrefetchIter", "MegaBatch", "device_feed",
           "stack_batch_arrays", "FeedDataIter", "record_pipeline",
           "make_jpeg_decode", "make_u8_decode", "ParallelReader",
           "AugmentSpec", "augment_batch", "augment_batch_host", "draw",
           "PAD_ID", "pad_ids", "make_ids_decode", "write_ids_record",
           "ids_pipeline"]


class FeedDataIter:
    """DataIter adapter over a running :class:`Pipeline` whose batches
    are ``(data[B,...], label[B,...], pad)`` tuples: what ``Module.fit``
    consumes.  Epochs map onto the pipeline's in-band sentinels —
    ``next()`` raises StopIteration at an epoch boundary and ``reset()``
    rolls to the next epoch (draining the rest of the current one if the
    consumer stopped early)."""

    def __init__(self, pipeline: Pipeline, data_shape: Tuple[int, ...],
                 batch_size: int, label_width: int = 1,
                 data_name: str = "data",
                 label_name: str = "softmax_label"):
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        self._at_boundary = True
        self._delivered = 0   # batches handed out in the current epoch
        self._samples = 0     # source samples consumed (pad rows excluded)
        # set by record_pipeline(device_augment=True): batches are
        # compact uint8 HWC and Module.fit hands this spec to the fused
        # step, which prepends the crop/flip/cast/normalize prologue
        # (feed.augment)
        self.augment_spec = None

    @property
    def provide_data(self):
        return [(self._data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        if self.label_width == 1:
            return [(self._label_name, (self.batch_size,))]
        return [(self._label_name, (self.batch_size, self.label_width))]

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        from ..io import DataBatch
        from ..ndarray import NDArray
        self._ensure_released()
        try:
            item = self.pipeline.get()
        except StopIteration:
            self._at_boundary = True
            self._delivered = 0
            self._samples = 0
            raise
        data, label, pad = item
        self._at_boundary = False
        self._delivered += 1
        self._samples += self.batch_size - pad
        # a host ring slot (no h2d stage) is refilled later: copy it
        ring = getattr(item, "slot", None) is not None

        def wrap(a):
            if isinstance(a, NDArray):
                return a
            if isinstance(a, torch.Tensor):
                return NDArray(a.clone() if ring else a)
            # keep the wire dtype: the compact-feed path ships uint8
            # batches and the fused step's augment prologue dispatches on
            # it (a float32 default cast would quadruple the copied bytes
            # AND skip the on-device augmentation)
            a = np.asarray(a)
            return NDArray(torch.from_numpy(np.array(a, copy=True)))
        if self.label_width == 1 and getattr(label, "ndim", 1) > 1:
            label = label.reshape(label.shape[0])
        out = DataBatch(data=[wrap(data)], label=[wrap(label)], pad=pad,
                        index=None)
        out.rows_cut = getattr(item, "rows_cut", None)
        return out

    def reset(self):
        if self._at_boundary:
            return            # already positioned at an epoch start
        self._ensure_released()
        try:
            while True:
                self.pipeline.get()
        except StopIteration:
            pass
        self._at_boundary = True
        self._delivered = 0
        self._samples = 0

    def _ensure_released(self):
        """Open a held ParallelReader head (constructed paused so a
        fresh iterator can still take a fast mid-epoch restore); no-op
        for every other pipeline shape."""
        head = self.pipeline.stages[0]
        release = getattr(head, "release", None)
        if callable(release):
            release()

    # -- checkpoint cursor (mx.checkpoint mid-epoch resume) ---------------
    def state(self) -> dict:
        """Position cursor: completed epochs + batches delivered in the
        current one (plus the exact source-sample count, which differs
        from batch*batch_size only across a padded final batch).  With a
        ParallelReader head the derived per-worker ``(epoch, offset)``
        shard positions ride along under ``"reader"``.  ``restore`` on a
        FRESH iterator fast-forwards to the exact next batch."""
        st = {"epoch": self.pipeline.epochs_consumed,
              "batch": self._delivered,
              "samples": self._samples}
        head = self.pipeline.stages[0]
        cursor = getattr(head, "cursor", None)
        if callable(cursor):
            st["reader"] = cursor(st["epoch"], st["samples"])
        return st

    def restore(self, state: dict) -> None:
        """Fast-forward a freshly built iterator to ``state``.  A held
        ParallelReader head takes the fast path: the reader simulates
        its deterministic schedule and restarts each worker process at
        the exact shard offset still needed — no re-decode of the
        already-consumed samples.  Otherwise whole epochs are drained
        through the pipeline (the source replays the same passes) and
        the consumed batches of the target epoch are pulled and
        discarded.  Either way the next ``next()`` returns the exact
        batch the checkpoint's training step would have seen (fast-path
        caveat: a final PADDED batch after a mid-epoch resume pads with
        post-resume rows — pad count and real rows are identical, pad
        content may differ; size your dataset to the batch or use
        ``partial="drop"`` when bitwise pad rows matter)."""
        from ..base import MXNetError
        state = state or {}
        if "inner" in state:
            # a cursor saved THROUGH a DevicePrefetchIter wrapper
            # (prefetch_to_device was toggled off between save and
            # resume): the nested inner state is this iterator's own
            state = state["inner"] or {}
        target_epoch = int(state.get("epoch", 0))
        target_batch = int(state.get("batch", 0))
        head = self.pipeline.stages[0]
        saved = state.get("reader")
        reader_head = hasattr(head, "fast_restore")
        if saved and reader_head:
            # the delivered stream is a pure function of (seed, epoch,
            # nworkers, window): a config drift between save and resume
            # would silently deliver a DIFFERENT stream — re-delivering
            # consumed samples and skipping unconsumed ones — so refuse
            live = {"nworkers": head._nworkers, "seed": head._seed,
                    "shuffle_window": head._window}
            drift = {k: (saved[k], live[k]) for k in live
                     if k in saved and saved[k] != live[k]}
            if drift:
                raise MXNetError(
                    "feed restore: reader config changed between save "
                    "and resume (%s as saved vs live); the sharded "
                    "stream is a function of these — rebuild the "
                    "pipeline with the saved settings" % (drift,))
        elif bool(saved) != reader_head and target_batch:
            # a MID-epoch cursor across a topology change (thread-pool
            # save -> multi-process resume, or the reverse) cannot land
            # on the same stream — the two topologies order samples
            # differently.  Epoch-boundary cursors (batch 0) are safe:
            # every topology starts its epoch deterministically.
            raise MXNetError(
                "feed restore: pipeline topology changed between save "
                "(%s) and resume (%s); a mid-epoch cursor cannot map "
                "across — rebuild the pipeline as saved, or resume "
                "from an epoch-boundary checkpoint"
                % ("multi-process reader" if saved else "thread pool",
                   "multi-process reader" if reader_head
                   else "thread pool"))
        if callable(getattr(head, "fast_restore", None)) and \
                getattr(head, "can_fast_restore", lambda: False)():
            samples = int(state.get("samples",
                                    target_batch * self.batch_size))
            head.fast_restore(target_epoch, samples, saved=saved)
            self.pipeline.resume_at(target_epoch)
            self._delivered = target_batch
            self._samples = samples
            self._at_boundary = target_batch == 0
            return
        self._ensure_released()
        while self.pipeline.epochs_consumed < target_epoch:
            before = self.pipeline.epochs_consumed
            try:
                while True:
                    self.pipeline.get()
            except StopIteration:
                pass
            if self.pipeline.epochs_consumed == before:   # EndOfStream
                raise MXNetError(
                    "feed restore: source exhausted before epoch %d "
                    "(max_epochs too small for this resume?)" % target_epoch)
        for i in range(target_batch):
            try:
                self.pipeline.get()
            except StopIteration:
                raise MXNetError(
                    "feed restore: epoch %d ended after %d batches but the "
                    "checkpoint cursor wants %d (did the dataset or batch "
                    "size change between save and resume?)"
                    % (target_epoch, i, target_batch))
        self._delivered = target_batch
        self._samples = int(state.get("samples",
                                      target_batch * self.batch_size))
        self._at_boundary = target_batch == 0

    def close(self):
        self.pipeline.close()


def make_jpeg_decode(data_shape: Tuple[int, ...], resize: int = 0,
                     rand_crop: bool = False, rand_mirror: bool = False,
                     mean_rgb=None, scale: float = 1.0):
    """Build the decode/augment fn for :func:`record_pipeline` workers:
    (label, payload) -> (CHW float32, label).  JPEG/PNG payloads decode
    via PIL (the python ImageRecordIter path; without PIL they raise);
    payloads whose size equals prod(data_shape) are treated as
    raw-packed CHW uint8."""
    mean = None
    if mean_rgb is not None:
        mean = np.asarray(mean_rgb, np.float32).reshape(-1, 1, 1)
    raw_len = int(np.prod(data_shape))

    def decode(item):
        from ..io import crop_mirror_normalize, resize_shorter_edge
        label, payload = item
        if len(payload) == raw_len:
            img = np.frombuffer(payload, np.uint8).astype(
                np.float32).reshape(data_shape)
        else:
            import io as _io
            from ..io import _pil_image
            pil = _pil_image().open(_io.BytesIO(payload)).convert("RGB")
            if resize:
                pil = resize_shorter_edge(pil, resize)
            img = np.asarray(pil, np.float32).transpose(2, 0, 1)
        img = crop_mirror_normalize(img, data_shape, rand_crop=rand_crop,
                                    rand_mirror=rand_mirror, mean=mean,
                                    scale=scale)
        return np.ascontiguousarray(img, np.float32), np.float32(label)

    return decode


def make_u8_decode(pre_shape: Tuple[int, ...], resize: int = 0):
    """Build the compact-wire decode fn for device-augment pipelines:
    (label, payload) -> (HWC uint8 of exactly ``pre_shape``, f32 label).
    No float math on the host — crop/flip/cast/normalize run inside the
    fused train step (feed.augment), and the batch crosses to the card
    at 1 byte/pixel instead of 4."""
    def decode(item):
        from ..io import decode_to_hwc_u8
        label, payload = item
        return decode_to_hwc_u8(payload, pre_shape, resize=resize), \
            np.float32(label)

    return decode


def staging_stages(buffer_size: int, to_device: bool, device=None):
    """The pipeline's tail: the host ring (pinned when the batches go to
    a card) and, with ``to_device``, the copy onto ``device`` (resolved
    here, in the calling thread; see :class:`DevicePutStage`)."""
    ring = max(8, 2 * buffer_size + 2)
    if not to_device:
        return [StagingStage(ring_size=ring, pin=False)]
    dev = device if callable(device) or isinstance(device, RowShard) \
        else resolve_device(device)
    pin = torch.cuda.is_available() if callable(device) \
        else resolve_device(dev).type == "cuda"
    return [StagingStage(ring_size=ring, pin=pin), DevicePutStage(dev)]


def _record_source(path_imgrec: str):
    """Factory: one sequential pass over a .rec file per call, yielding
    (scalar label, payload bytes) items."""
    from .. import recordio

    def epoch():
        rec = recordio.MXRecordIO(path_imgrec, "r")
        try:
            while True:
                s = rec.read()
                if s is None:
                    return
                header, payload = recordio.unpack(s)
                label = np.asarray(header.label, np.float32).reshape(-1)[0]
                yield float(label), payload
        finally:
            rec.close()

    return epoch


def record_pipeline(path_imgrec: str, batch_size: int,
                    data_shape: Tuple[int, ...], workers: int = 4,
                    resize: int = 0, rand_crop: bool = False,
                    rand_mirror: bool = False, mean_rgb=None,
                    scale: float = 1.0, buffer_size: int = 4,
                    max_epochs: Optional[int] = None, to_device: bool = True,
                    sharding=None, name: str = "record_feed",
                    reader_procs: Optional[int] = None,
                    shuffle_window: Optional[int] = None,
                    device_augment: Optional[bool] = None,
                    seed: int = 0, hold: Optional[bool] = None,
                    partial: str = "pad"):
    """The full staged image pipeline over a RecordIO file, as a DataIter.

    Two source topologies:

    * ``reader_procs == 0`` (default) — in-process thread pool::

          source(.rec) -> decode x workers -> batch -> staging -> h2d

    * ``reader_procs = N`` (or ``MXNET_FEED_WORKERS=N``) — N forked
      reader PROCESSES, each streaming a deterministic shard of the
      .rec with chunked pread, decoding in parallel past the GIL, and
      funneling fixed-shape samples through shared-memory rings into a
      seeded global-shuffle window (``shuffle_window`` /
      ``MXNET_FEED_SHUFFLE_WINDOW``)::

          ParallelReader(N procs, shuffle window) -> batch -> staging -> h2d

      Crash-detected worker restart, clean shutdown and exact mid-epoch
      checkpoint cursors come along (feed.ParallelReader).

    ``device_augment`` (or ``MXNET_FEED_DEVICE_AUGMENT=1``) switches the
    wire format to compact uint8 HWC (~4x fewer bytes copied): workers
    only decode + center-fit each image into a fixed ``(resize, resize,
    C)`` envelope, and the returned iterator carries an ``augment_spec``
    that ``Module.fit`` hands to the fused train step, which prepends the
    crop/flip/cast/normalize prologue (feed.augment), its draws from the
    device's generator, so a mid-epoch resume replays identical crops.

    Returns a :class:`FeedDataIter` ready for ``Module.fit``.
    ``to_device`` lands the batches on ``sharding`` (a Context or
    ``torch.device``, or a zero-arg callable resolving to one, e.g.
    ``lambda: mod._fused.batched_sharding()``), by default the current
    context of the calling thread: ``gpu(0)`` unless the caller asks for
    the CPU.  A batch headed for a card reaches it or the pipeline
    raises."""
    from ..base import get_env
    if reader_procs is None:
        reader_procs = get_env("MXNET_FEED_WORKERS", 0, int)
    if shuffle_window is None:
        shuffle_window = get_env("MXNET_FEED_SHUFFLE_WINDOW", 256, int)
    if device_augment is None:
        device_augment = get_env("MXNET_FEED_DEVICE_AUGMENT", False, bool)

    spec = None
    if device_augment:
        c, h, w = data_shape
        pre = (resize, resize, c) if resize else (h, w, c)
        if rand_crop and pre[0] <= h and pre[1] <= w:
            # no crop margin in the fixed envelope: the device "random"
            # crop would be a constant center crop — quality silently
            # degrades vs the host path, which crops from the full
            # decoded image.  Say so; pass resize > crop size for room.
            import logging
            logging.getLogger("mxnet_tpu_torch.feed").warning(
                "record_pipeline(device_augment=True, rand_crop=True) "
                "with envelope %s == crop %s: no crop margin, the "
                "on-device crop is deterministic; set resize > %d to "
                "give the random crop room", pre[:2], (h, w), max(h, w))
        spec = AugmentSpec(data_shape, pre_shape=pre, rand_crop=rand_crop,
                           rand_mirror=rand_mirror, mean_rgb=mean_rgb,
                           scale=scale)
        decode = make_u8_decode(pre, resize=resize)
        sample_shape, sample_dtype = pre, np.uint8
    else:
        decode = make_jpeg_decode(data_shape, resize=resize,
                                  rand_crop=rand_crop,
                                  rand_mirror=rand_mirror,
                                  mean_rgb=mean_rgb, scale=scale)
        sample_shape, sample_dtype = tuple(data_shape), np.float32

    if reader_procs > 0:
        # hold by default: the FeedDataIter releases the reader on first
        # use, leaving the pre-consumption window open for a fast
        # mid-epoch checkpoint restore
        stages = [
            ParallelReader(("rec", path_imgrec), decode,
                           workers=reader_procs,
                           sample_shape=sample_shape,
                           sample_dtype=sample_dtype,
                           shuffle_window=shuffle_window, seed=seed,
                           max_epochs=max_epochs,
                           hold=True if hold is None else hold),
            BatchStage(batch_size, partial=partial),
        ]
    else:
        stages = [
            SourceStage(_record_source(path_imgrec), max_epochs=max_epochs),
            MapStage(decode, workers=workers, name="decode"),
            BatchStage(batch_size, partial=partial),
        ]
    stages += staging_stages(buffer_size, to_device, sharding)
    pipe = Pipeline(stages, buffer_size=buffer_size, name=name)
    it = FeedDataIter(pipe, data_shape, batch_size)
    it.augment_spec = spec
    return it
