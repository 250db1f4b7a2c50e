"""NDArray over a ``torch.Tensor``, and the ``MXTPU001`` NDArray file.

The counterpart of ``mxnet_tpu/ndarray.py`` for the slice the port
carries: creation (``array``/``zeros``/``empty``), the host copy
(``asnumpy``), whole-array writes (``arr[:] = value``, in place, so a
buffer shared by several executors stays shared), and ``save``/
``load``/``loads`` in the file format both packages read and write:

    b"MXTPU001" | <Q meta length | pickle({"names", "dtypes"}) | npz

bfloat16 entries are stored as their uint16 bits with the dtype tag
``"bfloat16"``; reading and writing them needs no numpy bfloat16 type.
"""
from __future__ import annotations

import io as _io
import pickle
import struct
from typing import List, Optional

import numpy as np
import torch

from .base import MXNetError, atomic_local_write, numeric_types
from .context import Context, context_of, current_context

__all__ = ["NDArray", "array", "zeros", "empty", "concatenate", "save",
           "load", "loads", "torch_dtype", "numpy_dtype"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# The reference runs with jax's 64-bit types off, so its arrays narrow
# int64 to int32 and float64 to float32; the port's arrays do the same.
_NARROWED = {torch.int64: torch.int32, torch.float64: torch.float32}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype, dtype name or torch dtype -> the torch dtype an
    NDArray holds it in (64-bit types narrowed to 32 bits)."""
    if not isinstance(dtype, torch.dtype):
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        if name not in _TORCH_DTYPES:
            raise MXNetError("unsupported dtype %r" % (dtype,))
        dtype = _TORCH_DTYPES[name]
    return _NARROWED.get(dtype, dtype)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """torch dtype -> numpy dtype (bfloat16 needs ``ml_dtypes``)."""
    if dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError as e:
            raise MXNetError("a bfloat16 array has no numpy dtype without "
                             "the ml_dtypes package") from e
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(_DTYPE_NAMES[dtype])


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """Copy a numpy array into a new CPU tensor (bfloat16 by its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor (any device) into a new numpy array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(numpy_dtype(t.dtype)).copy()
    return t.numpy().copy()


def _as_tensor(value, dtype: torch.dtype, device: torch.device):
    if isinstance(value, NDArray):
        value = value._get()
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    if isinstance(value, np.ndarray) and value.dtype.name == "bfloat16":
        return _tensor_from_numpy(value).to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(value)).to(device=device, dtype=dtype)


class NDArray:
    """A tensor with the reference's NDArray surface."""

    __slots__ = ("_data",)

    def __init__(self, data: torch.Tensor):
        self._data = data

    def _get(self) -> torch.Tensor:
        """The underlying ``torch.Tensor``."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self) -> int:
        return int(self._data.numel())

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._data.dtype)

    @property
    def context(self) -> Context:
        return context_of(self._data.device)

    def asnumpy(self) -> np.ndarray:
        return _tensor_to_numpy(self._data)

    def __getitem__(self, key):
        """``arr[i]`` or ``arr[start:stop]`` along the first axis: a view
        that shares this array's buffer, as the reference's slice does."""
        if isinstance(key, slice) and key.step not in (None, 1):
            raise MXNetError("NDArray slices take no step; got %r" % (key,))
        if not isinstance(key, (slice, int, np.integer)):
            raise MXNetError("NDArray in the port supports arr[i] and "
                             "arr[start:stop]; got key %r" % (key,))
        return NDArray(self._data[key])

    def copy(self) -> "NDArray":
        """A new array with a copy of the data, on the same device."""
        return NDArray(self._data.detach().clone())

    def copyto(self, other) -> "NDArray":
        """Copy into ``other``: an NDArray (written in place, cast to its
        dtype) or a Context (a new array there)."""
        if isinstance(other, NDArray):
            if other is self:
                return other
            other[:] = self
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(
                other.torch_device(), copy=True))
        raise TypeError("copyto does not support type %s" % type(other))

    def __setitem__(self, key, value):
        """``arr[:] = value``: write in place, casting to this array's
        dtype and device (the buffer itself never changes)."""
        if not (isinstance(key, slice) and key.start is None
                and key.stop is None and key.step is None):
            raise MXNetError("NDArray in the port supports only arr[:] = "
                             "value writes; got key %r" % (key,))
        if isinstance(value, numeric_types):
            self._data.fill_(value)
            return
        if not isinstance(value, (NDArray, torch.Tensor, np.ndarray,
                                  np.generic, list, tuple)):
            raise TypeError("type %s not supported" % str(type(value)))
        src = _as_tensor(value, self._data.dtype, self._data.device)
        if tuple(src.shape) != self.shape:
            if src.numel() != self.size:
                raise MXNetError("shape mismatch: cannot assign %s to "
                                 "NDArray of shape %s"
                                 % (tuple(src.shape), self.shape))
            src = src.reshape(self.shape)
        self._data.copy_(src)

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)


# ---------------------------------------------------------------------------
# creation

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(ctx: Optional[Context]) -> torch.device:
    return (ctx if ctx is not None else current_context()).torch_device()


def empty(shape, ctx: Optional[Context] = None, dtype=np.float32) -> NDArray:
    return NDArray(torch.empty(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def zeros(shape, ctx: Optional[Context] = None, dtype=np.float32) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def array(source_array, ctx: Optional[Context] = None,
          dtype=np.float32) -> NDArray:
    """A new array holding a copy of ``source_array`` (numpy, list,
    NDArray or tensor) on ``ctx`` (default: the current context)."""
    device = _device(ctx)
    if isinstance(source_array, NDArray):
        source_array = source_array._get()
    if isinstance(source_array, torch.Tensor):
        t = source_array.detach().to(device=device, dtype=torch_dtype(dtype),
                                     copy=True)
        return NDArray(t)
    t = _tensor_from_numpy(np.asarray(source_array))
    return NDArray(t.to(device=device, dtype=torch_dtype(dtype)))


def concatenate(arrays, axis: int = 0) -> NDArray:
    """Join arrays of one device along ``axis`` into a new array."""
    return NDArray(torch.cat([a._get() for a in arrays], dim=axis))


# ---------------------------------------------------------------------------
# save / load

_SAVE_MAGIC = b"MXTPU001"


class _MetaUnpickler(pickle.Unpickler):
    """The meta block holds only dicts, lists, strings and None: refuse
    any global a crafted file might name."""

    def find_class(self, module, name):
        raise MXNetError("NDArray file meta names a global %s.%s"
                         % (module, name))


def save(fname: str, data) -> None:
    """Save a list or dict of NDArray, published atomically."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names: Optional[List[str]] = list(data.keys())
        arrays = [data[k] for k in names]
    elif isinstance(data, (list, tuple)):
        names = None
        arrays = list(data)
    else:
        raise TypeError("save only accepts dict or list of NDArray")
    for a in arrays:
        if not isinstance(a, NDArray):
            raise TypeError("save only accepts dict or list of NDArray")
    dtypes, raw = [], []
    for a in arrays:
        t = a._get().detach().cpu()
        dtypes.append(_DTYPE_NAMES[t.dtype])
        raw.append(t.view(torch.int16).numpy().view(np.uint16)
                   if t.dtype == torch.bfloat16 else t.numpy())
    np_bytes = _io.BytesIO()
    np.savez(np_bytes, *raw)
    meta = pickle.dumps({"names": names, "dtypes": dtypes})
    with atomic_local_write(fname, "wb") as f:
        f.write(_SAVE_MAGIC)
        f.write(struct.pack("<Q", len(meta)))
        f.write(meta)
        f.write(np_bytes.getvalue())


def load(fname: str, ctx: Optional[Context] = None):
    """Load NDArrays saved by :func:`save` (either package's) onto
    ``ctx`` (default: the current context)."""
    with open(fname, "rb") as f:
        return loads(f.read(), name=fname, ctx=ctx)


def loads(buf: bytes, name: str = "<bytes>", ctx: Optional[Context] = None):
    """Load NDArrays from an in-memory :func:`save` blob."""
    stream = _io.BytesIO(buf)
    if stream.read(len(_SAVE_MAGIC)) != _SAVE_MAGIC:
        raise MXNetError("invalid NDArray file %s" % name)
    (meta_len,) = struct.unpack("<Q", stream.read(8))
    meta = _MetaUnpickler(_io.BytesIO(stream.read(meta_len))).load()
    if isinstance(meta, dict):
        names, dtypes = meta["names"], meta.get("dtypes")
    else:                      # blobs from older saves: names only
        names, dtypes = meta, None
    npz = np.load(_io.BytesIO(stream.read()))
    device = _device(ctx)
    arrays = []
    for i in range(len(npz.files)):
        a = npz["arr_%d" % i]
        dt = dtypes[i] if dtypes else a.dtype.name
        if dt == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True)).to(torch_dtype(dt))
        arrays.append(NDArray(t.to(device)))
    if names is None:
        return arrays
    return dict(zip(names, arrays))
