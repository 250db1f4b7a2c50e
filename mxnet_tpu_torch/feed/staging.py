"""Host->device staging: the next batch's copy issued under the current
train step (counterpart of ``mxnet_tpu/feed/staging.py``).

:class:`DevicePrefetchIter` wraps any DataIter and keeps ``depth``
batches in flight: each ``next()`` first tops the window up by pulling
host batches and issuing their copies (through pinned memory,
non-blocking, on a copy stream of its own, one event per batch), then
hands out the OLDEST in-flight batch after ordering the caller's stream
behind its copy.  ``stage_ahead()`` tops the window up without handing
anything out: ``fit``'s superstep loop calls it between a superstep's
dispatch and its drain, so the next megabatch's staging overlaps the
card's work.  Batches are staged onto the device the module's fused
train step reads from (``FusedTrainStep.batched_sharding()``, its
device), so ``make_batch`` copies them device to device into its static
buffers with no second host-to-device transfer.  Batches already on that
device (a feed pipeline with a DevicePutStage) pass through.  Under a
named mesh the step's ``batched_sharding()`` is a
:class:`~.stages.RowShard`, and only this rank's rows of each batch are
copied (a megabatch's K batches each cut before stacking; the batch
says which arrays were cut, and ``make_batch`` cuts them no more).  On
the host the wrapper is plain lookahead.

The route is fixed at the wrap, before the first batch (:attr:`route`).
A ``NativeImageRecordIter`` over JPEG records wrapped for a CUDA device
takes the device route, :class:`JpegDeviceRoute`: the host workers read
and plan without decoding, the JPEG bytes cross to the card from a
pinned buffer, nvjpeg decodes to components, the ``jpeg_color`` and
``image_augment`` kernels write the batch, on a copy stream, one event a
batch; the batches are those the host loader gives but for nvjpeg's
IDCT.  Every other iterator, raw CHW records included, takes
the host route: its host batches are copied.  :meth:`route_report` says
which, with the images decoded on the card and the bytes crossed a
batch.

``Module.fit(..., prefetch_to_device=True)`` wires this in automatically
(base_module.py); :func:`device_feed` is the manual entry point.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from .. import trace as _trace
from .stages import CopyStream, RowShard, claim_tensors, resolve_device
from .stats import PipelineStats

__all__ = ["MegaBatch", "DevicePrefetchIter", "device_feed",
           "stack_batch_arrays", "JpegDeviceRoute", "plan_jobs"]


def _tensor(a):
    from ..ndarray import NDArray
    if isinstance(a, NDArray):
        return a._get()
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def stack_batch_arrays(arrs, device=None):
    """Stack K per-step arrays (NDArray, tensor or array-like) on a new
    leading axis and put them on ``device`` (default: the current
    context) in ONE copy -- the megabatch staging primitive shared by
    the prefetcher (:class:`DevicePrefetchIter`) and the cold path
    (``FusedTrainStep.make_megabatch``), so both produce the same
    layout.  Arrays already on ``device`` are stacked there; host arrays
    are stacked on the host and sent through pinned memory without
    blocking, on the calling thread's current stream."""
    dev = resolve_device(device)
    ts = [_tensor(a) for a in arrs]
    if all(t.device == dev for t in ts):
        return torch.stack(ts)
    host = torch.stack([t.detach().cpu() for t in ts])
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)


class MegaBatch:
    """K training batches stacked on a leading axis, pre-staged on the
    fused superstep's device.  ``data``/``label`` are lists of NDArray
    shaped ``(K, B, ...)``, aligned with the module's data/label names
    like a DataBatch.  Consumers duck-type on the ``megabatch``
    attribute (``Module.fit``'s superstep loop); ``unstack()`` recovers
    the K per-step DataBatches for the per-batch fallback path."""

    def __init__(self, data, label, k, pad=0, index=None, rows_cut=None):
        self.data = data
        self.label = label
        self.megabatch = int(k)
        self.pad = pad
        self.index = index
        # a flag per array (data, then label): holds this rank's rows
        # only (RowShard.cut of each batch)
        self.rows_cut = rows_cut

    def unstack(self):
        from ..io import DataBatch
        from ..ndarray import NDArray

        def row(arr, i):
            return NDArray(_tensor(arr)[i])
        out = [DataBatch(data=[row(a, i) for a in self.data],
                         label=[row(a, i) for a in (self.label or [])],
                         pad=self.pad, index=None)
               for i in range(self.megabatch)]
        for b in out:
            b.rows_cut = self.rows_cut
        return out


def plan_jobs(geom: np.ndarray):
    """A batch plan's rows (``native_io.PLAN_FIELDS``) -> (the decode's
    job rows, ``ops.cuda_kernels.JPEG_JOB_FIELDS``; image_augment's
    geometry rows, ``AUG_FIELDS``): each image read gets a slot of 3 *
    h * w bytes in the decoded components and RGB, packed in order."""
    from ..native_io import PLAN_FIELDS
    f = {k: i for i, k in enumerate(PLAN_FIELDS)}
    ok = geom[:, f["ok"]] != 0
    h, w = geom[:, f["src_h"]], geom[:, f["src_w"]]
    sizes = np.where(ok, 3 * h * w, 0)
    slots = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    jobs = np.stack([geom[:, f["offset"]], geom[:, f["length"]], slots, h,
                     w, geom[:, f["ok"]]], axis=1)
    # AUG_FIELDS: the slot, then PLAN_FIELDS from "ok" to "mirror"
    aug = np.concatenate([slots[:, None], geom[:, f["ok"]:]], axis=1)
    return jobs, aug


class JpegDeviceRoute:
    """JPEG records decoded on ``device``, for a ``NativeImageRecordIter``
    (``data_iter``) wrapped by :class:`DevicePrefetchIter`.

    A plan loader with the iterator's parameters (``native_io``,
    ``plan=True``) reads each record's frame header and draws its crop
    and mirror as the host loader would, in the same order from the same
    stream, on the iterator's threads.  Each batch's JPEG payloads are
    copied into one pinned buffer, grown on demand; on a copy stream
    nvjpeg decodes them to components, each image's work completed
    before the next begins and so before ``next()`` returns, which frees
    the buffer for the next batch (``ops.cuda_kernels.JpegDecoder``),
    ``jpeg_color`` converts them to RGB and ``image_augment`` resizes,
    crops, mirrors and normalizes into the (B, 3, H, W) float32 batch,
    the labels copied beside it; one event is recorded after.
    ``next()`` returns a DataBatch on the device whose ``ready`` is that
    event.  A failed decode or launch raises, naming the record.  On the
    CPU (``device`` cpu, for tests) the decode to components is the host
    loader's libjpeg and the kernels take their plain versions."""

    def __init__(self, data_iter, device):
        from ..ops import cuda_kernels as ck
        self.device = torch.device(device)
        self.batch_size = data_iter.batch_size
        self._hw = tuple(data_iter.data_shape[1:])
        self._label_width = data_iter.label_width
        self._mean, self._scale = data_iter.mean_rgb, data_iter.scale
        self._loader = data_iter.make_loader(plan=True)
        self._decoder = ck.JpegDecoder(self.device)
        self._copies = CopyStream()
        self._pin = self.device.type == "cuda"
        self._payload = None
        self._first = True
        self.batches = self.images = self.bytes = 0

    def _buffer(self, nbytes: int):
        """The payload buffer, at least ``nbytes`` long."""
        if self._payload is None or self._payload.numel() < nbytes:
            self._payload = torch.empty(max(nbytes, 1) * 5 // 4,
                                        dtype=torch.uint8,
                                        pin_memory=self._pin)
        return self._payload

    def _host(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self._pin else t

    def reset(self):
        if not self._first:
            self._loader.reset()
        self._first = False

    def next(self):
        from ..io import DataBatch
        from ..native_io import PLAN_FIELDS
        from ..ndarray import NDArray
        from ..ops import cuda_kernels as ck
        self._first = False
        plan = self._loader.next_plan(self._buffer)
        if plan is None:
            raise StopIteration
        jobs, aug = plan_jobs(plan.geom)
        records = plan.geom[:, PLAN_FIELDS.index("record")]
        geom = self._host(aug)
        label = plan.label.reshape(-1) if self._label_width == 1 \
            else plan.label
        label = self._host(label)
        dev = self.device

        def work():
            pixels = self._decoder.decode(plan.payload, jobs, records)
            data = ck.image_augment(pixels,
                                    geom.to(dev, non_blocking=True),
                                    self._hw, self._mean, self._scale)
            return data, label.to(dev, non_blocking=True)
        (data, lab), ev = self._copies.run(dev, work)
        crossed = plan.nbytes + geom.nbytes + label.nbytes
        self.batches += 1
        self.images += int((aug[:, 1] != 0).sum())
        self.bytes += crossed
        out = DataBatch(data=[NDArray(data)], label=[NDArray(lab)],
                        pad=plan.pad, index=None)
        out.ready = ev
        out.crossed_bytes = crossed
        return out


class DevicePrefetchIter:
    """DataIter wrapper: stage ``depth`` batches ahead on the device.

    Instrumented like a pipeline stage: the ``h2d`` stats row counts
    staged images, the time spent issuing copies and the bytes copied
    from the host; ``stall_in`` accumulates time blocked waiting on the
    wrapped (host) iterator -- how long the card's consumer was starved
    by the host pipeline.  ``sharding`` is the device to stage onto (a
    Context or ``torch.device``, the counterpart of the reference's
    sharding); else ``module``'s fused step's device, else the current
    context of the thread that builds the wrapper.
    """

    def __init__(self, data_iter, sharding=None, module=None, depth: int = 2,
                 megabatch: int = 1, name: str = "device_feed"):
        assert depth >= 1
        self._iter = data_iter
        self._module = module
        self._device = (sharding if isinstance(sharding, RowShard)
                        else resolve_device(sharding)) \
            if sharding is not None or module is None else None
        self._depth = depth
        # megabatch=K: assemble K host batches into ONE stacked (K, B,
        # ...) staged copy (the superstep's input layout) per next(); a
        # sub-K tail at epoch end is staged as plain per-step batches for
        # the K=1 fallback path
        self._megabatch = max(1, int(megabatch))
        self._pending = deque()
        # inner-iterator cursor snapshots aligned 1:1 with _pending, each
        # taken BEFORE its batch was pulled (see state())
        self._pending_states = deque()
        self._exhausted = False
        self._consumed = 0    # batches handed out this epoch (checkpoint)
        self._copies = CopyStream()
        self.stats = PipelineStats(name).register()
        self._h2d = self.stats.stage("h2d")
        self.batch_size = getattr(data_iter, "batch_size", 0)
        # the route, fixed here: JPEG records of a native iterator are
        # decoded on a CUDA device, everything else crosses as host batches
        self._route = None
        dev = self._wrap_device()
        if dev is not None and dev.type == "cuda" and \
                getattr(data_iter, "records", None) == "jpeg" and \
                callable(getattr(data_iter, "make_loader", None)):
            self._route = JpegDeviceRoute(data_iter, dev)
        self._source = self._route or data_iter

    @property
    def route(self) -> str:
        """"device" (JPEG records decoded on the card) or "host"."""
        return "host" if self._route is None else "device"

    def route_report(self) -> dict:
        """The route, and on the device route the batches made, the
        images decoded on the card and the bytes crossed a batch (the
        JPEG payloads, the geometry rows and the labels)."""
        out = {"route": self.route}
        r = self._route
        if r is not None:
            out.update(batches=r.batches, images=r.images,
                       bytes_per_batch=r.bytes / max(1, r.batches))
        return out

    def _wrap_device(self):
        """The device this wrapper stages onto, as known at the wrap: the
        given one, else the module's context's."""
        if self._device is not None:
            return resolve_device(self._device)
        ctx = getattr(self._module, "_context", None)
        return ctx[0].torch_device() if ctx else None

    # -- DataIter surface -------------------------------------------------
    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    @property
    def augment_spec(self):
        """Forward the wrapped iterator's on-device augmentation spec
        (compact uint8 pipelines): fit's augment wiring must see it
        through this wrapper too, or the uint8 batches would reach the
        fused step without their prologue."""
        return getattr(self._iter, "augment_spec", None)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def reset(self):
        self._pending.clear()
        self._pending_states.clear()
        self._exhausted = False
        self._consumed = 0
        self._source.reset()

    def next(self):
        self._fill()
        if not self._pending:
            raise StopIteration
        if self._pending_states:
            self._pending_states.popleft()
        batch, ev = self._pending.popleft()
        if ev is not None:
            claim_tensors([_tensor(a) for a in
                           (batch.data or []) + (batch.label or [])], ev)
        # the checkpoint cursor counts underlying batches: a megabatch
        # consumes K at once (cursor granularity stays exact because
        # fit only checkpoints at superstep boundaries)
        self._consumed += getattr(batch, "megabatch", 1)
        return batch

    # -- checkpoint cursor -------------------------------------------------
    def state(self) -> dict:
        """Position cursor counting batches HANDED OUT -- in-flight staged
        batches are NOT consumed; a resume re-stages them.  For an inner
        iterator with its own cursor, the snapshot taken BEFORE the
        oldest still-pending batch was pulled is reported (the inner's
        live cursor already sits ``depth`` batches ahead; using it would
        skip the staged-but-untrained batches on resume)."""
        st = {"batch": self._consumed}
        inner = getattr(self._iter, "state", None)
        if callable(inner):
            st["inner"] = (self._pending_states[0] if self._pending_states
                           else inner())
        return st

    def restore(self, state: dict) -> None:
        """Fast-forward past the consumed batches.  A wrapped iterator
        with its own cursor (feed.FeedDataIter) restores natively;
        otherwise the host batches are pulled and discarded WITHOUT
        staging them to the device.  A cursor saved WITHOUT the wrapper
        (an epoch-carrying inner-style state -- prefetch_to_device was
        toggled on between save and resume) is delegated to the inner
        iterator rather than silently dropping its epoch."""
        state = state or {}
        self._pending.clear()
        self._pending_states.clear()
        self._exhausted = False
        inner = getattr(self._iter, "restore", None)
        if callable(inner) and "inner" in state:
            inner(state["inner"])
        elif "epoch" in state:
            # an unwrapped iterator's own cursor: only that iterator
            # knows how to honor the epoch component
            if not callable(inner):
                from ..base import MXNetError
                raise MXNetError(
                    "cannot restore an epoch-carrying feed cursor %r: the "
                    "wrapped iterator has no restore(); resume without "
                    "prefetch_to_device or re-save with it enabled" % state)
            inner(state)
        else:
            self._source.reset()
            for _ in range(int(state.get("batch", 0))):
                try:
                    self._source.next()
                except StopIteration:
                    self._exhausted = True
                    break
        self._consumed = int(state.get("batch", 0))

    def iter_next(self):
        self._fill()
        return bool(self._pending)

    def stage_ahead(self) -> None:
        """Top the window up now: ``fit``'s superstep loop calls this after
        a superstep's K steps are queued and before their drain, so the
        next megabatch is stacked, pinned and copied while the card runs
        the current one instead of after the drain, when the card idles."""
        self._fill()

    # -- staging ----------------------------------------------------------
    def _resolve_device(self, mega: bool = False):
        """The device to stage on, or a :class:`RowShard` naming it and
        this rank's rows."""
        if self._device is not None:
            return self._device
        fused = getattr(self._module, "_fused", None)
        if fused is not None:
            return fused.megabatched_sharding() if mega \
                else fused.batched_sharding()
        return self._module._context[0].torch_device()

    def _fill(self):
        k = self._megabatch
        inner_state = getattr(self._iter, "state", None)
        while not self._exhausted and len(self._pending) < self._depth:
            group, pres = [], []
            while len(group) < k and not self._exhausted:
                pre = inner_state() if callable(inner_state) else None
                t0 = time.perf_counter()
                try:
                    batch = self._source.next()
                except StopIteration:
                    self._exhausted = True
                    break
                self._h2d.add_stall_in(time.perf_counter() - t0)
                group.append(batch)
                pres.append(pre)
            if not group:
                return
            if k > 1 and len(group) == k:
                # one pending entry per megabatch; the cursor snapshot is
                # the position BEFORE its first batch was pulled
                self._pending.append(self._stage_mega(group))
                if pres[0] is not None:
                    self._pending_states.append(pres[0])
            else:
                for batch, pre in zip(group, pres):
                    self._pending.append(self._stage(batch))
                    if pre is not None:
                        self._pending_states.append(pre)

    def _stage(self, batch):
        from ..io import DataBatch
        from ..ndarray import NDArray
        dev = self._resolve_device()
        t0 = time.perf_counter()
        arrays = list(batch.data or []) + list(batch.label or [])
        cut = None
        if isinstance(dev, RowShard):
            arrays, cut = dev.cut(arrays)
            dev = dev.device
        host_bytes = sum(_tensor(a).nbytes for a in arrays
                         if _tensor(a).device != dev)

        def put_all():
            out = []
            for arr in arrays:
                t = _tensor(arr)
                if t.device == dev:
                    out.append(arr if isinstance(arr, NDArray)
                               else NDArray(t))
                elif dev.type == "cuda":
                    host = t if t.is_pinned() else t.pin_memory()
                    out.append(NDArray(host.to(dev, non_blocking=True)))
                else:
                    out.append(NDArray(t.to(dev)))
            return out
        if host_bytes:
            staged, ev = self._copies.run(dev, put_all)
        else:
            # made on the device (the JPEG route's batches carry their
            # event) or already there
            staged, ev = put_all(), getattr(batch, "ready", None)
        nd = len(batch.data or [])
        n = staged[0].shape[0] if nd else 0
        dt = time.perf_counter() - t0
        self._h2d.add_items(int(n), dt)
        _trace.complete("feed:h2d_stage", t0, dt, cat="feed", items=int(n))
        self._h2d.add_bytes(host_bytes + getattr(batch, "crossed_bytes", 0))
        out = DataBatch(data=staged[:nd], label=staged[nd:], pad=batch.pad,
                        index=batch.index,
                        provide_data=getattr(batch, "provide_data", None),
                        provide_label=getattr(batch, "provide_label", None))
        out.rows_cut = cut
        return out, ev

    def _stage_mega(self, group):
        """Stack K host batches into one (K, B, ...) staged copy per
        input -- issued while the CURRENT superstep runs, so the next
        megabatch's copy overlaps device compute."""
        from ..ndarray import NDArray
        dev = self._resolve_device(mega=True)
        k = len(group)
        t0 = time.perf_counter()
        nd = len(group[0].data or [])
        per = [list(b.data or []) + list(b.label or []) for b in group]
        cut = None
        if isinstance(dev, RowShard):
            cuts = [dev.cut(arrs) for arrs in per]
            per, cut = [c[0] for c in cuts], cuts[0][1]
            dev = dev.device
        cols = [[arrs[i] for arrs in per] for i in range(nd)]
        lcols = [[arrs[i] for arrs in per]
                 for i in range(nd, len(per[0]))]
        host_bytes = sum(_tensor(a).nbytes for col in cols + lcols
                         for a in col if _tensor(a).device != dev)
        for b, arrs in zip(group, per):
            # batches made on the device: stacked on this stream after
            # their event
            ev = getattr(b, "ready", None)
            if ev is not None:
                claim_tensors([_tensor(a) for a in arrs], ev)

        def put_all():
            return ([NDArray(stack_batch_arrays(c, dev)) for c in cols],
                    [NDArray(stack_batch_arrays(c, dev)) for c in lcols])
        if host_bytes:
            (data, label), ev = self._copies.run(dev, put_all)
        else:
            (data, label), ev = put_all(), None
        n = data[0].shape[0] * data[0].shape[1] if data else 0
        dt = time.perf_counter() - t0
        self._h2d.add_items(int(n), dt)
        _trace.complete("feed:h2d_stage_mega", t0, dt, cat="feed", k=k,
                        items=int(n))
        self._h2d.add_bytes(host_bytes + sum(
            getattr(b, "crossed_bytes", 0) for b in group))
        return MegaBatch(data=data, label=label, k=k, rows_cut=cut), ev


def device_feed(data_iter, module=None, sharding=None, depth: int = 2,
                megabatch: int = 1):
    """Wrap ``data_iter`` so batches arrive pre-staged on the device.

    ``module``: resolve the device lazily from the module's fused train
    step (call AFTER init_optimizer); ``sharding``: an explicit Context
    or ``torch.device``; neither: the current context.  ``megabatch=K``:
    assemble stacked K-batch megabatches for the fused superstep
    (fit(superstep=K) wires this through automatically)."""
    return DevicePrefetchIter(data_iter, sharding=sharding, module=module,
                              depth=depth, megabatch=megabatch)
