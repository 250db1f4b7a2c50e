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
libjpeg.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import native_build

__all__ = ["NativeBatchLoader", "NativeRecordWriter", "lib_available",
           "jpeg_available"]

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
    lib.mxtpu_loader_create.argtypes = [
        ctypes.c_char_p, i, i, i, i, i, i, i, i, i, fp, f, i, i, i, i, i]
    lib.mxtpu_loader_num_records.restype = ctypes.c_long
    lib.mxtpu_loader_num_records.argtypes = [vp]
    lib.mxtpu_loader_last_error.restype = ctypes.c_char_p
    lib.mxtpu_loader_last_error.argtypes = [vp]
    lib.mxtpu_loader_next.restype = i
    lib.mxtpu_loader_next.argtypes = [vp, fp, fp, ctypes.POINTER(i)]
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


class NativeBatchLoader:
    """Threaded native batch loader over a JPEG- or raw-packed .rec
    file."""

    def __init__(self, path: str, batch_size: int,
                 data_shape: Tuple[int, ...], label_width: int = 1,
                 threads: int = 4, shuffle: bool = False,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 mean_rgb=None, scale: float = 1.0, part_index: int = 0,
                 num_parts: int = 1, seed: int = 0, queue_depth: int = 4,
                 resize: int = 0):
        lib = _load()
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
            int(resize))
        if not self._h:
            raise RuntimeError("failed to open %s" % path)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_buf = np.empty((batch_size,) + self.data_shape,
                                  np.float32)
        self._label_buf = np.empty((batch_size, label_width), np.float32)

    @property
    def num_records(self) -> int:
        return int(self._lib.mxtpu_loader_num_records(self._h))

    def next(self):
        """Return (data, label, pad) numpy copies, None at epoch end.
        A decode failure in any worker (corrupt JPEG, undersized image, a
        JPEG without libjpeg) raises — garbage batches are never
        delivered."""
        pad = ctypes.c_int(0)
        rc = self._lib.mxtpu_loader_next(
            self._h,
            self._data_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._label_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(pad))
        if rc == 2:
            msg = self._lib.mxtpu_loader_last_error(self._h) or b""
            raise RuntimeError("native loader: %s" % msg.decode())
        if rc != 0:
            return None
        return (self._data_buf.copy(), self._label_buf.copy(), pad.value)

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
