# lint: allow-file(unseeded-fork-rng) — single-process iterators draw from
# the mx.random.seed-seeded global stream on purpose, as the reference's do
# (one numpy seed, one order in both packages); the forked readers
# (feed/parallel.py) reseed per (seed, shard, epoch, seq) before drawing
"""Data iterators (counterpart of ``mxnet_tpu/io.py``).

``DataDesc``, ``DataBatch``, the ``DataIter`` protocol (with ``feed()``,
the device prefetcher), ``NDArrayIter`` (in-memory numpy data with
shuffle and the pad, discard and roll_over last-batch modes),
``ResizeIter``, ``PrefetchingIter`` (thread prefetch, the reference's
iter_prefetcher.h), ``MNISTIter`` (idx files), ``CSVIter`` and
``ImageRecordIter`` (RecordIO with packed images: a lazy offset index,
threaded decode, the reference's default augmenters drawn from numpy's
global stream), as in the reference.  Batches are NDArrays on the host
(``cpu()``): the module copies each into its bound arrays on the device,
or ``DataIter.feed()`` / ``fit(prefetch_to_device=True)`` stage them
ahead.  ``shuffle`` draws its order from numpy's global stream, as the
reference does, so one numpy seed gives one order in both packages.

``ImageRecordIter(...)`` returns the native loader
(:class:`NativeImageRecordIter`, over :mod:`native_io` and the port's
``csrc/native/data_loader.cc``) whenever its knobs allow it and the
first record holds a 3-channel JPEG or a raw CHW payload, as the
reference's does (``MXNET_NATIVE_IO=0`` turns that off); otherwise the
Python path below.  There raw CHW-packed payloads (exactly
``prod(data_shape)`` bytes) decode without PIL; JPEG/PNG payloads need
PIL and raise without it.  The native loader's JPEG records wrapped for
a CUDA device are decoded on the card (``feed.staging.JpegDeviceRoute``).
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
from collections import namedtuple
from typing import List, Tuple

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array as _array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "ImageRecordIter",
           "NativeImageRecordIter",
           "resize_shorter_edge", "crop_mirror_normalize",
           "decode_to_hwc_u8"]


def nd_array(a):
    """A host NDArray holding a copy of ``a``."""
    return _array(a, ctx=cpu())


DataDesc = namedtuple("DataDesc", ["name", "shape"])


class DataBatch:
    """One batch (reference io.py DataBatch)."""

    def __init__(self, data, label, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator protocol (reference io.py:64)."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError()

    def getdata(self):
        raise NotImplementedError()

    def getlabel(self):
        raise NotImplementedError()

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError()

    def feed(self, depth=2, module=None, sharding=None):
        """Wrap this iterator with the staged device prefetcher
        (``feed.device_feed``): the next batch's copy to the device is
        issued under the current step.  The device is ``sharding`` (a
        Context or ``torch.device``), else ``module``'s, else the
        current context."""
        from . import feed as _feed
        return _feed.device_feed(self, module=module, sharding=sharding,
                                 depth=depth)


def _pil_image():
    """PIL's ``Image`` module, or a clear error: decoding JPEG/PNG
    payloads needs PIL (pillow); raw CHW-packed records do not."""
    try:
        from PIL import Image
    except ImportError as e:
        raise MXNetError(
            "decoding a JPEG/PNG record needs PIL (pillow), which is not "
            "installed; raw CHW-packed uint8 records decode without it "
            "(%s)" % e)
    return Image


def resize_shorter_edge(pil_img, resize):
    """Scale a PIL image so its shorter edge equals ``resize`` (aspect
    preserved) -- shared by ImageRecordIter's augmenter and the feed
    decode workers."""
    Image = _pil_image()
    w0, h0 = pil_img.size
    if w0 < h0:
        return pil_img.resize((resize, max(1, int(h0 * resize / w0))),
                              Image.BILINEAR)
    return pil_img.resize((max(1, int(w0 * resize / h0)), resize),
                          Image.BILINEAR)


def crop_mirror_normalize(img, data_shape, rand_crop=False,
                          rand_mirror=False, mean=None, scale=1.0):
    """Shared augment tail over a CHW float image -- min-size check,
    random/center crop to ``data_shape``, horizontal mirror, mean
    subtract, scale, the draws from numpy's global stream.  Both decode
    paths (ImageRecordIter and the feed decode workers) end here."""
    _, h, w = data_shape
    _, ih, iw = img.shape
    if ih < h or iw < w:
        raise MXNetError("image %s smaller than data_shape %s"
                         % (img.shape, tuple(data_shape)))
    if rand_crop:
        dy = np.random.randint(0, ih - h + 1)
        dx = np.random.randint(0, iw - w + 1)
    else:
        dy, dx = (ih - h) // 2, (iw - w) // 2
    img = img[:, dy:dy + h, dx:dx + w]
    if rand_mirror and np.random.rand() < 0.5:
        img = img[:, :, ::-1]
    if mean is not None:
        img = img - mean
    return img * scale


def decode_to_hwc_u8(payload, pre_shape, resize=0):
    """Decode an image payload to a FIXED ``(Hp, Wp, C)`` uint8 HWC
    buffer -- the compact wire format of the device-augment feed path
    (crop/flip/cast/normalize then run inside the fused train step; see
    feed.augment).  JPEG/PNG payloads decode via PIL, resize (shorter
    edge to ``resize`` when given, scaled up further if still smaller
    than the envelope) and CENTER-crop to ``pre_shape`` -- the random
    crop happens on the device, out of the envelope's margin.  Raw
    payloads whose size matches are accepted as packed CHW uint8 and
    transposed (numpy only: the forked reader workers run this)."""
    import io as _io
    hp, wp, c = pre_shape
    if len(payload) == hp * wp * c:
        # raw CHW-packed record
        return np.frombuffer(payload, np.uint8).reshape(
            (c, hp, wp)).transpose(1, 2, 0).copy()
    Image = _pil_image()
    pil = Image.open(_io.BytesIO(payload)).convert("RGB")
    if resize:
        pil = resize_shorter_edge(pil, resize)
    w0, h0 = pil.size
    if h0 < hp or w0 < wp:
        # envelope not covered (tiny image or no resize given): scale up
        # so BOTH dims reach it, preserving aspect
        s = max(hp / h0, wp / w0)
        pil = pil.resize((max(wp, int(round(w0 * s))),
                          max(hp, int(round(h0 * s)))), Image.BILINEAR)
        w0, h0 = pil.size
    dy, dx = (h0 - hp) // 2, (w0 - wp) // 2
    img = np.asarray(pil, np.uint8)[dy:dy + hp, dx:dx + wp, :]
    return np.ascontiguousarray(img)


def _init_data(data, allow_empty, default_name):
    """Normalize input to list of (name, numpy) (reference io.py:219)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out[k] = np.ascontiguousarray(np.asarray(v, dtype=np.float32))
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """In-memory iterator with shuffle/pad (reference io.py:319)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.batch_size = batch_size

        self.num_data = self.data[0][1].shape[0]
        assert self.num_data >= batch_size, \
            "batch_size need to be smaller than data size."

        if shuffle:
            idx = np.arange(self.num_data)
            np.random.shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]

        if last_batch_handle == "discard":
            new_n = self.num_data - self.num_data % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
            self.num_data = new_n

        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.last_batch_handle = last_batch_handle
        # Epoch position: `_batch_start` is the first row of the batch most
        # recently handed out (None before the epoch's first batch), and
        # `_wrap_carry` counts head rows a wrapped final batch has already
        # served, so roll_over mode can begin the next epoch past them.
        self._batch_start = None
        self._wrap_carry = 0

    @property
    def provide_data(self):
        return [(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.data]

    @property
    def provide_label(self):
        return [(k, tuple([self.batch_size] + list(v.shape[1:])))
                for k, v in self.label]

    def hard_reset(self):
        """Forget the epoch position entirely, including any roll-over."""
        self._batch_start = None
        self._wrap_carry = 0

    def reset(self):
        # After exhaustion, `_batch_start` sits one batch stride past the
        # last served batch; its overshoot beyond the data end equals the
        # head rows a wrapped final batch already consumed.  roll_over
        # starts the next epoch after them; a mid-epoch reset (no
        # overshoot) starts from the top.
        carry = 0
        if self.last_batch_handle == "roll_over" and \
                self._batch_start is not None:
            carry = max(0, self._batch_start - self.num_data)
        self._wrap_carry = carry
        self._batch_start = None

    def iter_next(self):
        if self._batch_start is None:
            self._batch_start = self._wrap_carry
        elif self._batch_start < self.num_data:
            self._batch_start += self.batch_size
        # once exhausted, further probes are no-ops: a consumer retrying
        # next() after StopIteration must not inflate the roll_over carry
        return self._batch_start < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _overhang(self):
        """Rows by which the current batch sticks out past the data end."""
        if self._batch_start is None:
            return 0
        return max(0, self._batch_start + self.batch_size - self.num_data)

    def _getdata(self, data_source):
        start = self._batch_start
        assert start is not None and start < self.num_data, \
            "DataIter need reset."
        if not self._overhang():
            return [nd_array(v[start:start + self.batch_size])
                    for _, v in data_source]
        rows = np.arange(start, start + self.batch_size)
        return [nd_array(v.take(rows, axis=0, mode="wrap"))
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        return self._overhang() if self.last_batch_handle == "pad" else 0


class ResizeIter(DataIter):
    """Resize the epoch length of an iterator (reference io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Thread-based prefetcher (reference io.py:171, iter_prefetcher.h)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()
        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i], daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def dispose(self):
        """Stop and join the prefetch threads.  ``__del__`` alone cannot
        be relied on: the threads' args reference ``self``, so the iter
        sits in a reference cycle and only a full GC pass would finalize
        it — meanwhile the daemon threads linger (the tier-1 leak guard
        flags exactly that)."""
        if not getattr(self, "started", False):
            return          # never started (failed __init__) or disposed
        self.started = False
        # a thread mid-fetch in iters[i].next() will clear() its event
        # after we set it and park in wait() forever — keep re-arming
        # the event until the thread actually exits
        for thread, e in zip(self.prefetch_threads, self.data_taken):
            deadline = 100            # 5s at 50ms per join attempt
            while thread.is_alive() and deadline > 0:
                e.set()
                thread.join(timeout=0.05)
                deadline -= 1

    def __del__(self):
        self.dispose()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[(r[n], s) for n, s in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[(r[n], s) for n, s in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, "Number of entry mismatches between iterators"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, "not an idx image file: %s" % path
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(num, rows, cols)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        assert magic == 2049, "not an idx label file: %s" % path
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.float32)


class MNISTIter(NDArrayIter):
    """MNIST idx-file iterator (reference src/io/iter_mnist.cc)."""

    def __init__(self, image="train-images-idx3-ubyte", label="train-labels-idx1-ubyte",
                 batch_size=128, shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, part_index=0, num_parts=1, **kwargs):
        for path in (image, label):
            if not os.path.exists(path) and not os.path.exists(path + ".gz"):
                raise MXNetError("MNIST file %s not found" % path)
        if not os.path.exists(image):
            image += ".gz"
        if not os.path.exists(label):
            label += ".gz"
        images = _read_idx_images(image).astype(np.float32) / 255.0
        labels = _read_idx_labels(label)
        # distributed sharding (reference iter_mnist.cc part_index/num_parts)
        if num_parts > 1:
            n = images.shape[0] // num_parts
            images = images[part_index * n:(part_index + 1) * n]
            labels = labels[part_index * n:(part_index + 1) * n]
        if flat or (input_shape is not None and len(input_shape) == 1):
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1,
                                    images.shape[1], images.shape[2])
        super().__init__(images, labels, batch_size=batch_size, shuffle=shuffle,
                         label_name="softmax_label")


class CSVIter(NDArrayIter):
    """CSV iterator (reference src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[1:] == (1,):
                label = label.reshape(-1)
        super().__init__(data, label, batch_size=batch_size, shuffle=False,
                         last_batch_handle="pad" if round_batch else "discard")


class NativeImageRecordIter(DataIter):
    """Native (C++) threaded RecordIO batch iterator — the fast path for
    JPEG-packed and raw-CHW-packed .rec files (``csrc/native/
    data_loader.cc``: mmapped record index, N decode threads off the GIL,
    bounded double-buffer queue; reference iter_image_recordio.cc +
    iter_prefetcher.h equivalent).  Batches are host NDArrays, decoded
    with libjpeg; without it a JPEG record raises naming libjpeg.

    ``records`` says what the first record holds ("jpeg" or "raw").
    Wrapped by ``feed.DevicePrefetchIter`` for a CUDA device (as
    ``fit(prefetch_to_device=True)`` and ``feed.device_feed`` wrap it),
    JPEG records take the route on the card instead
    (``feed.staging.JpegDeviceRoute``: this iterator's parameters, a
    loader that plans without decoding, nvjpeg, the ``jpeg_color`` and
    ``image_augment`` kernels), with the host loader's batches but for
    nvjpeg's IDCT.  The host loader starts at the first
    ``next()``, so a wrapped iterator decodes nothing on the host."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean_r=0, mean_g=0, mean_b=0, scale=1.0,
                 rand_crop=False, rand_mirror=False, part_index=0,
                 num_parts=1, preprocess_threads=4, seed=0, resize=0,
                 **kwargs):
        super().__init__()
        self.mean_rgb = (mean_r, mean_g, mean_b) \
            if (mean_r or mean_g or mean_b) else None
        self.scale = scale
        self.path_imgrec = path_imgrec
        self._loader_kw = dict(
            label_width=label_width, threads=preprocess_threads,
            shuffle=shuffle, rand_crop=rand_crop, rand_mirror=rand_mirror,
            mean_rgb=self.mean_rgb, scale=scale, part_index=part_index,
            num_parts=num_parts, seed=seed, resize=resize)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.records = _first_record_kind(path_imgrec)
        self._loader = None
        self._first = True

    def make_loader(self, plan=False):
        """A native loader with this iterator's parameters; ``plan=True``
        gives the plan loader of the route on the card."""
        from .native_io import NativeBatchLoader
        return NativeBatchLoader(self.path_imgrec, self.batch_size,
                                 self.data_shape, plan=plan,
                                 **self._loader_kw)

    @property
    def provide_data(self):
        return [("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        if self.label_width == 1:
            return [("softmax_label", (self.batch_size,))]
        return [("softmax_label", (self.batch_size, self.label_width))]

    def _host_loader(self):
        if self._loader is None:
            self._loader = self.make_loader()
        return self._loader

    def reset(self):
        if not self._first:
            self._host_loader().reset()
        self._first = False

    def next(self):
        self._first = False
        out = self._host_loader().next()
        if out is None:
            raise StopIteration
        data, label, pad = out
        if self.label_width == 1:
            label = label.reshape(-1)
        return DataBatch(data=[nd_array(data)], label=[nd_array(label)],
                         pad=pad, index=None)


_JPEG_MAGIC = b"\xff\xd8\xff"


def _first_payload(path):
    """The payload of the first record of ``path``, None for an empty
    file (raises when the file cannot be read)."""
    from . import recordio as _recordio
    rec = _recordio.MXRecordIO(path, "r")
    try:
        s = rec.read()
    finally:
        rec.close()
    return None if s is None else _recordio.unpack(s)[1]


def _first_record_kind(path) -> str:
    """"jpeg" when the first record of ``path`` holds a JPEG, else "raw"
    (raises when the file cannot be read)."""
    payload = _first_payload(path)
    return "jpeg" if payload is not None and \
        payload[:3] == _JPEG_MAGIC else "raw"


def _native_io_delegable(kwargs) -> bool:
    """True when ImageRecordIter can hand the workload to the native C++
    loader: every requested knob is implemented natively (JPEG/raw decode,
    shorter-edge resize, crop/mirror/mean/scale, sharding, threads) AND the
    records actually hold JPEG or raw-CHW payloads (sniffed from the first
    record — PNG and other formats stay on the Python path)."""
    from .base import get_env as _get_env
    if not _get_env("MXNET_NATIVE_IO", True, bool):
        return False
    from .native_io import lib_available
    if not lib_available():
        return False
    unsupported = ("mean_img", "max_rotate_angle", "max_random_contrast",
                   "max_random_illumination", "random_h", "random_s",
                   "random_l", "pad")
    if any(kwargs.get(k) for k in unsupported):
        return False
    # round_batch=False asks for discard-last-partial semantics; the
    # native loader always pads the final batch — stay on the Python path
    # rather than deliver a padded batch the caller said not to want
    if not kwargs.get("round_batch", True):
        return False
    path = kwargs.get("path_imgrec")
    shape = kwargs.get("data_shape")
    if not path or not shape:
        return False
    try:
        payload = _first_payload(path)
        if payload is None:
            return False
        if payload[:3] == _JPEG_MAGIC:
            # the native JPEG path decodes to 3-channel RGB and strides
            # by shape[0]; only 3-channel shapes delegate (data_loader.cc
            # fails loud as defense in depth).  Raw-CHW payloads below
            # handle any channel count natively.
            return shape[0] == 3
        want = int(np.prod(shape))
        # raw-CHW: exact size, or the 2x-uint16 (src_h, src_w) prefix form
        return len(payload) == want or (
            len(payload) > want + 4 and
            (payload[0] | (payload[1] << 8)) * (payload[2] | (payload[3] << 8))
            * shape[0] + 4 == len(payload))
    except Exception:
        return False


class ImageRecordIter(DataIter):
    """Packed image RecordIO iterator (reference src/io/iter_image_recordio.cc).

    Construction returns the native C++ path (:class:`NativeImageRecordIter`)
    whenever the requested augmenter knobs are natively supported and the
    records hold JPEG or raw CHW payloads — matching the reference, whose
    ImageRecordIter IS the C++ pipeline.  A native library that fails to
    build, or a file the native loader cannot open, raises; it does not
    fall back.  Wrapped for a CUDA device (``fit(prefetch_to_device=
    True)``, ``feed.device_feed``), the native iterator's JPEG records
    are decoded and augmented on the card (``feed.staging.
    JpegDeviceRoute``), with the batches the host loader gives; no
    keyword selects that.  Otherwise this Python implementation covers
    the full augmenter set (PIL decode -> resize/rotate/HSL ->
    mean/scale -> crop/mirror -> batch) while streaming records through a
    lazy offset index in O(batch) memory; decode runs on a thread pool of
    ``preprocess_threads``.  Sharding via part_index/num_parts as in the
    reference.  A raw CHW-packed payload (``prod(data_shape)`` bytes)
    decodes without PIL; a JPEG/PNG payload needs PIL.
    """

    def __new__(cls, *args, **kwargs):
        if cls is ImageRecordIter:
            # FULL positional order of __init__ — truncating this list
            # would drop positionally-passed knobs on delegation
            names = ("path_imgrec", "data_shape", "batch_size",
                     "label_width", "shuffle", "mean_img", "mean_r",
                     "mean_g", "mean_b", "scale", "rand_crop",
                     "rand_mirror", "part_index", "num_parts",
                     "round_batch", "preprocess_threads",
                     "prefetch_buffer", "resize", "max_rotate_angle",
                     "max_random_contrast", "max_random_illumination",
                     "random_h", "random_s", "random_l", "pad")
            merged = dict(zip(names, args))
            merged.update(kwargs)
            if _native_io_delegable(merged):
                return NativeImageRecordIter(**merged)
        return super().__new__(cls)

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean_img=None, mean_r=0, mean_g=0, mean_b=0,
                 scale=1.0, rand_crop=False, rand_mirror=False,
                 part_index=0, num_parts=1, round_batch=True,
                 preprocess_threads=4, prefetch_buffer=4, resize=0,
                 max_rotate_angle=0, max_random_contrast=0.0,
                 max_random_illumination=0.0, random_h=0, random_s=0,
                 random_l=0, pad=0, **kwargs):
        super().__init__()
        from . import recordio as _recordio
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.scale = scale
        # round_batch=False: discard-last-partial (NDArrayIter's
        # last_batch_handle="discard"); True: wrap into the epoch head
        # and report the wrapped rows via pad
        self.round_batch = bool(round_batch)
        # reference default augmenter knobs (src/io/image_aug_default.cc):
        # resize shorter edge, random rotation, contrast/illumination
        # jitter, HSL channel shifts
        self.resize = resize
        # zero-pad each side before cropping (reference image_aug_default
        # pad param — the CIFAR 4-pixel-pad + random-crop recipe)
        self.pad_pixels = int(pad)
        self.max_rotate_angle = max_rotate_angle
        self.max_random_contrast = max_random_contrast
        self.max_random_illumination = max_random_illumination
        self.random_h = random_h
        self.random_s = random_s
        self.random_l = random_l
        # multi-threaded decode (reference ImageRecordIOParser's OMP decode
        # threads, iter_image_recordio.cc:139-291): PIL decode drops the
        # GIL, so a thread pool overlaps JPEG decode across the batch
        self.preprocess_threads = max(1, int(preprocess_threads))
        self._pool = None
        self.mean = None
        if mean_img is not None and os.path.exists(mean_img):
            from .ndarray import load as nd_load
            self.mean = list(nd_load(mean_img, ctx=cpu()).values())[0] \
                .asnumpy()
        elif mean_r or mean_g or mean_b:
            self.mean = np.array([mean_r, mean_g, mean_b],
                                 dtype=np.float32).reshape(3, 1, 1)
        # Lazy streaming: one index pass over the file (8-byte frame headers
        # only), then records are pread() on demand per batch — O(batch)
        # resident memory for ImageNet-scale .rec files, like the
        # reference's bounded chunk stream (iter_image_recordio.cc:311-395).
        self._unpack = _recordio.unpack
        self._fd = os.open(path_imgrec, os.O_RDONLY)
        self._index: List[Tuple[int, int]] = []   # payload (offset, length)
        fsize = os.fstat(self._fd).st_size
        pos = 0
        while pos + 8 <= fsize:
            head = os.pread(self._fd, 8, pos)
            if len(head) < 8:
                break
            magic, lrec = np.frombuffer(head, "<u4")
            if int(magic) != _recordio._MAGIC:
                raise MXNetError("corrupt RecordIO frame at byte %d of %s"
                                 % (pos, path_imgrec))
            length = int(lrec) & ((1 << 29) - 1)
            pos += 8
            self._index.append((pos, length))
            pos += length + ((4 - length % 4) % 4)
        if num_parts > 1:
            n = len(self._index) // num_parts
            self._index = self._index[part_index * n:(part_index + 1) * n]
        self._order = np.arange(len(self._index))
        self.cursor = -batch_size
        self.reset()

    def __del__(self):
        fd = getattr(self, "_fd", None)
        if fd is not None:
            try:
                os.close(fd)
            except Exception:   # interpreter teardown may have torn os down
                pass
            self._fd = None

    def _fetch(self, i: int):
        """Read record i from disk: (label ndarray, payload bytes)."""
        off, length = self._index[i]
        header, img = self._unpack(os.pread(self._fd, length, off))
        return np.asarray(header.label, dtype=np.float32), img

    @property
    def provide_data(self):
        return [("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        if self.label_width == 1:
            return [("softmax_label", (self.batch_size,))]
        return [("softmax_label", (self.batch_size, self.label_width))]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._order)
        self.cursor = -self.batch_size

    def _augment_pil(self, pil_img):
        """Reference default-augmenter steps that need the decoded image
        (image_aug_default.cc): shorter-edge resize, random rotation, HSL
        channel jitter."""
        Image = _pil_image()
        if self.resize:
            pil_img = resize_shorter_edge(pil_img, self.resize)
        if self.max_rotate_angle:
            angle = np.random.uniform(-self.max_rotate_angle,
                                      self.max_rotate_angle)
            pil_img = pil_img.rotate(angle, resample=Image.BILINEAR)
        if self.random_h or self.random_s or self.random_l:
            hsv = np.asarray(pil_img.convert("HSV"), dtype=np.int16)
            for ch, amp in enumerate((self.random_h, self.random_s,
                                      self.random_l)):
                if amp:
                    delta = int(np.random.uniform(-amp, amp))
                    if ch == 0:       # hue wraps
                        hsv[..., 0] = (hsv[..., 0] + delta) % 256
                    else:
                        hsv[..., ch] = np.clip(hsv[..., ch] + delta, 0, 255)
            pil_img = Image.fromarray(hsv.astype(np.uint8),
                                      "HSV").convert("RGB")
        return pil_img

    def _decode(self, raw: bytes) -> np.ndarray:
        if len(raw) == int(np.prod(self.data_shape)):
            # raw-packed record: flattened CHW uint8
            arr = np.frombuffer(raw, dtype=np.uint8)
            img = arr.astype(np.float32).reshape(self.data_shape)
        else:
            import io as _io
            pil_img = _pil_image().open(_io.BytesIO(raw)).convert("RGB")
            pil_img = self._augment_pil(pil_img)
            img = np.asarray(pil_img, dtype=np.float32)
            img = img.transpose(2, 0, 1)  # HWC -> CHW
            # photometric jitter (contrast around the mean, illumination
            # shift), both on the 0-255 scale like the reference
            if self.max_random_contrast:
                alpha = 1.0 + np.random.uniform(-self.max_random_contrast,
                                                self.max_random_contrast)
                img = (img - img.mean()) * alpha + img.mean()
            if self.max_random_illumination:
                img = img + np.random.uniform(
                    -self.max_random_illumination,
                    self.max_random_illumination)
        if self.pad_pixels:
            p = self.pad_pixels
            img = np.pad(img, ((0, 0), (p, p), (p, p)))
        return crop_mirror_normalize(img, self.data_shape,
                                     rand_crop=self.rand_crop,
                                     rand_mirror=self.rand_mirror,
                                     mean=self.mean, scale=self.scale)

    def iter_next(self):
        self.cursor += self.batch_size
        if not self.round_batch:
            return self.cursor + self.batch_size <= len(self._index)
        return self.cursor < len(self._index)

    def _fetch_decode(self, i: int):
        """pread + JPEG decode + augment one record (thread-pool task: both
        the disk read and PIL decode drop the GIL)."""
        label, raw = self._fetch(i)
        return self._decode(raw), label

    def next(self):
        if not self.iter_next():
            raise StopIteration
        idxs = [self._order[(self.cursor + i) % len(self._index)]
                for i in range(self.batch_size)]
        if self.preprocess_threads > 1 and len(idxs) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.preprocess_threads)
            results = list(self._pool.map(self._fetch_decode, idxs))
        else:
            results = [self._fetch_decode(i) for i in idxs]
        data = np.stack([r[0] for r in results])
        labels = np.stack([r[1] for r in results])
        if self.label_width == 1:
            labels = labels.reshape(-1)
        pad = max(0, self.cursor + self.batch_size - len(self._index))
        return DataBatch(data=[nd_array(data)], label=[nd_array(labels)],
                         pad=pad, index=None)

    def getpad(self):
        return max(0, self.cursor + self.batch_size - len(self._index))
