"""ctypes bindings for the port's native I/O core (counterpart of
``mxnet_tpu/native_io.py``), over the I/O library built from
``csrc/native/recordio.cc``, ``image_decode.cc`` and ``data_loader.cc``
(:mod:`native_build`, object ``io``).

Reference analogue: the C++ src/io/ pipeline reached through the C ABI +
ctypes, as the reference's python package reached libmxnet.so.  The
loader runs N decode threads off the GIL and double-buffers float32
batches; the module copies each batch to the card.  A seed gives the
same batches at every thread count (the crop and mirror draws come from
one stream an epoch, drawn in batch order), and at one thread those of
the JAX package's loader.  Where the library was built without libjpeg
(``native_build.have_jpeg()``), a JPEG record raises an error that names
libjpeg when the loader decodes on the host.

A loader made with ``plan=True`` decodes nothing: it is the host half of
the JPEG records route on the card (``feed.staging.JpegDeviceRoute``,
taken when ``DevicePrefetchIter`` wraps a JPEG ``NativeImageRecordIter``
for a CUDA device).  Its workers read each record's JPEG frame header
(``jpeg_dims``, no libjpeg needed), size its shorter-edge resize and draw
its crop and mirror as the decoding loader does, from the same stream in
the same order, and :meth:`NativeBatchLoader.next_plan` hands out a
batch's JPEG payloads back to back with a row of :data:`PLAN_FIELDS` a
record; nvjpeg and the ``jpeg_color`` and ``image_augment`` kernels do
the rest on the card.
"""
from __future__ import annotations

import ctypes
from collections import namedtuple
from typing import Tuple

import numpy as np

from . import native_build

__all__ = ["NativeBatchLoader", "NativeRecordWriter", "BatchPlan",
           "PLAN_FIELDS", "JPEG_SAMPLINGS", "lib_available",
           "jpeg_available", "jpeg_dims", "decode_jpeg",
           "decode_jpeg_planes"]

# a planned record's row (csrc/native/data_loader.cc PlanField): its
# payload's offset and length in the batch's payload, its record number,
# whether it was read (0: its image is zeros), the decoded size, the size
# after the shorter-edge resize, the crop's offset and the mirror bit
PLAN_FIELDS = ("offset", "length", "record", "ok", "src_h", "src_w",
               "res_h", "res_w", "dy", "dx", "mirror")

_LIB = None


def _load():
    """The I/O library, built at first use (raises if the build fails)."""
    global _LIB
    if _LIB is None:
        _LIB = declare(native_build.load("io"))
    return _LIB


def declare(lib):
    """Set the argument and result types of the I/O library's C ABI on
    ``lib``; returns it."""
    i, f, vp = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fp = ctypes.POINTER(ctypes.c_float)
    lib.mxtpu_loader_create.restype = vp
    ll = ctypes.c_longlong
    lib.mxtpu_loader_create.argtypes = [
        ctypes.c_char_p, i, i, i, i, i, i, i, i, i, fp, f, i, i, i, i, i, i]
    lib.mxtpu_loader_num_records.restype = ctypes.c_long
    lib.mxtpu_loader_num_records.argtypes = [vp]
    lib.mxtpu_loader_last_error.restype = ctypes.c_char_p
    lib.mxtpu_loader_last_error.argtypes = [vp]
    lib.mxtpu_loader_next.restype = i
    lib.mxtpu_loader_next.argtypes = [vp, fp, fp, ctypes.POINTER(i)]
    lib.mxtpu_loader_next_plan.restype = i
    lib.mxtpu_loader_next_plan.argtypes = [vp, ctypes.POINTER(ll)]
    lib.mxtpu_loader_take_plan.restype = None
    lib.mxtpu_loader_take_plan.argtypes = [vp, vp, ctypes.POINTER(ll), fp,
                                           ctypes.POINTER(i)]
    lib.mxtpu_plan_fields.restype = i
    lib.mxtpu_plan_fields.argtypes = []
    ip = ctypes.POINTER(i)
    lib.mxtpu_jpeg_dims.restype = i
    lib.mxtpu_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_long, ip, ip,
                                    ip]
    lib.mxtpu_jpeg_decode.restype = i
    lib.mxtpu_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, vp,
                                      ctypes.c_long, ip, ip]
    lib.mxtpu_jpeg_decode_planes.restype = i
    lib.mxtpu_jpeg_decode_planes.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                             vp, ctypes.c_long, ip]
    lib.mxtpu_have_jpeg.restype = i
    lib.mxtpu_have_jpeg.argtypes = []
    lib.mxtpu_loader_reset.argtypes = [vp]
    lib.mxtpu_loader_free.argtypes = [vp]
    lib.mxtpu_writer_create.restype = vp
    lib.mxtpu_writer_create.argtypes = [ctypes.c_char_p]
    lib.mxtpu_writer_write_image.argtypes = [
        vp, f, ctypes.c_ulong, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    lib.mxtpu_writer_free.argtypes = [vp]
    return lib


def lib_available() -> bool:
    """Whether the I/O library is built or can be built here."""
    return native_build.available("io")


def jpeg_available() -> bool:
    """Whether the I/O library decodes JPEG records (libjpeg found)."""
    return native_build.have_jpeg()


def jpeg_dims(payload: bytes) -> Tuple[int, int, int]:
    """(height, width, components) of a JPEG from its SOF0/1/2 frame
    header, read without decoding (and without libjpeg).  Raises on a
    header that cannot be read or a frame of another coding process."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = _load().mxtpu_jpeg_dims(payload, len(payload), ctypes.byref(h),
                                 ctypes.byref(w), ctypes.byref(c))
    if rc != 0:
        raise RuntimeError("JPEG header: %s" % (
            "a frame other than SOF0/1/2" if rc == 2 else "cannot be read"))
    return h.value, w.value, c.value


def decode_jpeg(payload: bytes, record=None) -> np.ndarray:
    """The host loader's decode of a JPEG: (h, w, 3) uint8 RGB from the I/O
    library's libjpeg (a grayscale JPEG's luma in all three channels).
    Raises naming libjpeg where the library was built without it, and on a
    corrupt JPEG (naming ``record`` when given)."""
    lib = _load()
    if not lib.mxtpu_have_jpeg():
        raise RuntimeError("this I/O library was built without libjpeg "
                           "(jpeglib.h was not found): no host JPEG decode")
    h, w, _ = jpeg_dims(payload)
    out = np.empty((h, w, 3), np.uint8)
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = lib.mxtpu_jpeg_decode(payload, len(payload), out.ctypes.data,
                               out.nbytes, ctypes.byref(oh),
                               ctypes.byref(ow))
    if rc != 0 or (oh.value, ow.value) != (h, w):
        raise RuntimeError("corrupt JPEG%s" % (
            "" if record is None else " at record %d" % record))
    return out


# a JPEG's chroma sampling, as decode_jpeg_planes reports it (csrc/native/
# image_decode.h JpegSampling): the luma alone, full-size chroma, chroma
# halved across, chroma halved across and down
JPEG_SAMPLINGS = ("gray", "4:4:4", "4:2:2", "4:2:0")


def decode_jpeg_planes(payload: bytes, record=None):
    """The host decode's components before libjpeg's chroma upsampling and
    colour conversion: -> (planes, (h, w, cw, ch, kind)), ``planes`` a 1-D
    uint8 array of Y (h x w) then, for a colour JPEG, Cb and Cr (ch x cw
    each), ``kind`` an index of :data:`JPEG_SAMPLINGS`.  Raises as
    :func:`decode_jpeg` does, and for another sampling."""
    lib = _load()
    if not lib.mxtpu_have_jpeg():
        raise RuntimeError("this I/O library was built without libjpeg "
                           "(jpeglib.h was not found): no host JPEG decode")
    h, w, _ = jpeg_dims(payload)
    out = np.empty(h * w * 3, np.uint8)
    info = (ctypes.c_int * 5)()
    rc = lib.mxtpu_jpeg_decode_planes(payload, len(payload),
                                      out.ctypes.data, out.nbytes, info)
    if rc != 0:
        raise RuntimeError("corrupt JPEG%s, or a sampling other than %s" % (
            "" if record is None else " at record %d" % record,
            ", ".join(JPEG_SAMPLINGS)))
    h, w, cw, ch, kind = list(info)
    n = h * w + (2 * cw * ch if kind else 0)
    return out[:n], (h, w, cw, ch, kind)


# one batch's plan (NativeBatchLoader.next_plan): the payload buffer (the
# JPEGs back to back in its first ``nbytes`` bytes), the (B,
# len(PLAN_FIELDS)) int64 rows, the labels and the pad
BatchPlan = namedtuple("BatchPlan", ["payload", "nbytes", "geom", "label",
                                     "pad"])


class NativeBatchLoader:
    """Threaded native batch loader over a JPEG- or raw-packed .rec
    file."""

    def __init__(self, path: str, batch_size: int,
                 data_shape: Tuple[int, ...], label_width: int = 1,
                 threads: int = 4, shuffle: bool = False,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 mean_rgb=None, scale: float = 1.0, part_index: int = 0,
                 num_parts: int = 1, seed: int = 0, queue_depth: int = 4,
                 resize: int = 0, plan: bool = False):
        lib = _load()
        if lib.mxtpu_plan_fields() != len(PLAN_FIELDS):
            raise RuntimeError("the I/O library's plan has %d fields, this "
                               "module %d" % (lib.mxtpu_plan_fields(),
                                              len(PLAN_FIELDS)))
        c, h, w = data_shape
        mean_ptr = None
        if mean_rgb is not None:
            self._mean = (ctypes.c_float * 3)(*[float(x) for x in mean_rgb])
            mean_ptr = ctypes.cast(self._mean, ctypes.POINTER(ctypes.c_float))
        self._lib = lib
        self._h = lib.mxtpu_loader_create(
            path.encode(), batch_size, c, h, w, label_width, threads,
            int(shuffle), int(rand_crop), int(rand_mirror), mean_ptr,
            float(scale), part_index, num_parts, seed, queue_depth,
            int(resize), int(bool(plan)))
        if not self._h:
            raise RuntimeError("failed to open %s" % path)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.plan = bool(plan)
        self._data_buf = None if plan else np.empty(
            (batch_size,) + self.data_shape, np.float32)
        self._label_buf = np.empty((batch_size, label_width), np.float32)

    @property
    def num_records(self) -> int:
        return int(self._lib.mxtpu_loader_num_records(self._h))

    def _raise(self):
        msg = self._lib.mxtpu_loader_last_error(self._h) or b""
        raise RuntimeError("native loader: %s" % msg.decode())

    def next(self):
        """Return (data, label, pad) numpy copies, None at epoch end.
        A decode failure in any worker (corrupt JPEG, undersized image, a
        JPEG without libjpeg) raises — garbage batches are never
        delivered."""
        if self.plan:
            raise RuntimeError("a plan loader decodes nothing: use "
                               "next_plan()")
        pad = ctypes.c_int(0)
        rc = self._lib.mxtpu_loader_next(
            self._h,
            self._data_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._label_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(pad))
        if rc == 2:
            self._raise()
        if rc != 0:
            return None
        return (self._data_buf.copy(), self._label_buf.copy(), pad.value)

    def next_plan(self, buffer):
        """The next batch's plan (a :class:`BatchPlan`), None at epoch
        end.  ``buffer(nbytes)`` gives a contiguous uint8 tensor or array
        of at least ``nbytes`` bytes (the route's pinned buffer) into
        which the batch's JPEG payloads are copied.  A record that fails
        a check (not a JPEG, an unreadable frame header, smaller than the
        crop, a data_shape of other than 3 channels) raises, as the
        decoding loader does."""
        nbytes = ctypes.c_longlong(0)
        rc = self._lib.mxtpu_loader_next_plan(self._h, ctypes.byref(nbytes))
        if rc == 2:
            self._raise()
        if rc != 0:
            return None
        buf = buffer(int(nbytes.value))
        if hasattr(buf, "data_ptr"):
            ptr, size = buf.data_ptr(), buf.numel() * buf.element_size()
        else:
            ptr, size = buf.ctypes.data, buf.nbytes
        if size < nbytes.value:
            raise RuntimeError("plan buffer of %d bytes for %d" % (
                size, nbytes.value))
        geom = np.empty((self.batch_size, len(PLAN_FIELDS)), np.int64)
        pad = ctypes.c_int(0)
        self._lib.mxtpu_loader_take_plan(
            self._h, ptr,
            geom.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            self._label_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(pad))
        return BatchPlan(buf, int(nbytes.value), geom,
                         self._label_buf.copy(), pad.value)

    def reset(self):
        self._lib.mxtpu_loader_reset(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mxtpu_loader_free(self._h)
            self._h = None


class NativeRecordWriter:
    """Native RecordIO image writer (im2rec core)."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.mxtpu_writer_create(path.encode())
        if not self._h:
            raise RuntimeError("cannot open %s" % path)

    def write_image(self, label: float, idx: int, payload: bytes):
        buf = (ctypes.c_ubyte * len(payload)).from_buffer_copy(payload)
        self._lib.mxtpu_writer_write_image(self._h, float(label), idx,
                                           buf, len(payload))

    def close(self):
        if self._h:
            self._lib.mxtpu_writer_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
