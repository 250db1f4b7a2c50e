"""NDArray over a ``torch.Tensor``, and the ``MXTPU001`` NDArray file.

The counterpart of ``mxnet_tpu/ndarray.py``: creation (``array``/
``zeros``/``ones``/``full``/``arange``/``empty``), the host copy
(``asnumpy``), views that write through (``arr[i]``, ``arr[a:b]``,
``reshape``: tensor views of one buffer), writes in place (``arr[key] =
value`` for an int, a basic slice or a tuple of them, so a buffer shared
by several executors stays shared), arithmetic with
arrays and scalars (the in-place forms write into the buffer), the
reference's registered functions (``dot``, ``sum``, ``onehot_encode``
...; ``ops/nd_bridge.py`` adds an imperative form of every aux-free
op), and ``save``/``load``/``loads`` in the file format both packages
read and write:

    b"MXTPU001" | <Q meta length | pickle({"names", "dtypes"}) | npz

bfloat16 entries are stored as their uint16 bits with the dtype tag
``"bfloat16"``; reading and writing them needs no numpy bfloat16 type.
"""
from __future__ import annotations

import io as _io
import operator
import pickle
import struct
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError, atomic_local_write, numeric_types, open_stream
from .context import Context, context_of, current_context
from . import engine as _engine

__all__ = ["NDArray", "array", "zeros", "ones", "full", "arange", "empty",
           "concatenate", "concat", "onehot_encode", "clip", "dot",
           "batch_dot", "transpose", "sum", "max", "min", "norm",
           "argmax_channel", "choose_element_0index", "imdecode", "waitall",
           "save",
           "load", "loads", "torch_dtype", "numpy_dtype",
           "register_ndarray_fn", "list_functions"]

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

    # _shard: (mesh, cuts, whole shape) of an array an executor placed
    # on a mesh as this rank's shard (Executor.set_mesh), else None
    __slots__ = ("_data", "writable", "_ctx", "_shard")

    def __init__(self, data: torch.Tensor, writable: bool = True,
                 ctx: Optional[Context] = None):
        self._data = data
        self._shard = None
        self.writable = writable
        # a host context other than cpu(0): the reference's fake devices
        # (several cpu(i) stand for several cards on one host)
        self._ctx = ctx if ctx is not None and ctx.device_typeid == 1 \
            and ctx.device_id != 0 else None

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
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._data.dtype)

    @property
    def context(self) -> Context:
        if self._ctx is not None:
            return self._ctx
        return context_of(self._data.device)

    ctx = context

    @property
    def T(self) -> "NDArray":
        """A new array with the axes reversed."""
        return NDArray(self._data.permute(
            *reversed(range(self._data.dim()))).contiguous())

    @property
    def handle(self) -> torch.Tensor:
        """The underlying tensor (the reference exposed a C handle)."""
        return self._data

    def wait_to_read(self) -> None:
        """Wait until the work queued on this array's stream is done."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self) -> np.ndarray:
        return _tensor_to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def astype(self, dtype) -> "NDArray":
        """A new array of ``dtype`` (64-bit types narrowed)."""
        return NDArray(self._data.to(torch_dtype(dtype), copy=True))

    def as_in_context(self, context: Context) -> "NDArray":
        """This array if it lives on ``context``, else a copy there."""
        if self.context == context:
            return self
        return self.copyto(context)

    def reshape(self, new_shape) -> "NDArray":
        """A view of the same buffer in ``new_shape``: writes go through
        to this array, as the reference's reshape view."""
        new_shape = tuple(int(x) for x in new_shape)
        if int(np.prod(new_shape)) != self.size:
            raise MXNetError("reshape size mismatch %s -> %s"
                             % (self.shape, new_shape))
        try:
            view = self._data.view(new_shape)
        except RuntimeError as e:
            raise MXNetError("reshape of a strided view %s -> %s: copy it "
                             "first" % (self.shape, new_shape)) from e
        return NDArray(view, writable=self.writable)

    def broadcast_to(self, shape) -> "NDArray":
        """A new array broadcast to ``shape`` (same ndim, each dim equal
        or 1, the reference's rule)."""
        shape = tuple(int(x) for x in shape)
        cur = self.shape
        if len(cur) != len(shape):
            raise MXNetError("Broadcasting needs same ndim: %s vs %s"
                             % (cur, shape))
        for c, s in zip(cur, shape):
            if c != s and c != 1:
                raise MXNetError("cannot broadcast %s to %s" % (cur, shape))
        return NDArray(self._data.expand(shape).contiguous())

    def _check_key(self, key):
        """An int in [0, n) or a basic slice within [0, n] (no step, no
        negative bounds, as the reference's views) per axis, or a tuple
        of them."""
        keys = key if isinstance(key, tuple) else (key,)
        if len(keys) > self._data.dim():
            raise MXNetError("too many indices %r for shape %s"
                             % (key, self.shape))
        for k, n in zip(keys, self._data.shape):
            if isinstance(k, slice):
                start = 0 if k.start is None else k.start
                stop = n if k.stop is None else k.stop
                if k.step not in (None, 1) or not 0 <= start <= stop <= n:
                    raise MXNetError("invalid slice %r for shape %s"
                                     % (key, self.shape))
            elif isinstance(k, (int, np.integer)):
                if not 0 <= k < n:
                    raise MXNetError("index %d out of range for shape %s"
                                     % (k, self.shape))
            else:
                raise MXNetError("NDArray takes int, basic-slice or tuple "
                                 "keys; got %r" % (key,))

    def __getitem__(self, key):
        """``arr[i]``, ``arr[start:stop]`` or a tuple of them: a view
        that shares this array's buffer, as the reference's slice does."""
        self._check_key(key)
        return NDArray(self._data[key], writable=self.writable,
                       ctx=self._ctx)

    def copy(self) -> "NDArray":
        """A new array with a copy of the data, on the same device."""
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

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
                other.torch_device(), copy=True), ctx=other)
        raise TypeError("copyto does not support type %s" % type(other))

    def __setitem__(self, key, value):
        """``arr[key] = value``: write in place through ``key`` (an int,
        a basic slice or a tuple of them), casting to this array's dtype
        and device (the buffer itself never changes)."""
        if not self.writable:
            raise MXNetError("trying to write to a read-only NDArray")
        self._check_key(key)
        target = self._data[key]
        if isinstance(value, numeric_types):
            target.fill_(value)
            return
        if not isinstance(value, (NDArray, torch.Tensor, np.ndarray,
                                  np.generic, list, tuple)):
            raise TypeError("type %s not supported" % str(type(value)))
        src = _as_tensor(value, target.dtype, target.device)
        if tuple(src.shape) != tuple(target.shape):
            if src.numel() != target.numel():
                raise MXNetError("shape mismatch: cannot assign %s to "
                                 "NDArray of shape %s"
                                 % (tuple(src.shape), tuple(target.shape)))
            src = src.reshape(target.shape)
        target.copy_(src)

    # -- arithmetic (reference ndarray.py:320-333) ----------------------------
    def _binary(self, other, fn, reverse=False) -> "NDArray":
        a = self._data
        if isinstance(other, NDArray):
            b = other._data
        elif isinstance(other, numeric_types):
            # a numpy scalar as the python number it holds: torch takes
            # a python number as a scalar of the array's type, as jnp
            # takes a weak-typed one
            b = other.item() if isinstance(other, np.generic) else other
        else:
            raise TypeError("type %s not supported" % str(type(other)))
        return NDArray(_engine.track(fn(b, a) if reverse else fn(a, b)))

    def _inplace(self, other, fn) -> "NDArray":
        """``self op= other``, written into this array's buffer in its
        dtype (a shared buffer stays shared), as the reference's write."""
        self[:] = self._binary(other, fn)
        return self

    def __add__(self, other):
        return self._binary(other, operator.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, operator.sub)

    def __rsub__(self, other):
        return self._binary(other, operator.sub, reverse=True)

    def __mul__(self, other):
        return self._binary(other, operator.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, operator.truediv)

    def __rtruediv__(self, other):
        return self._binary(other, operator.truediv, reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, other):
        return self._binary(other, operator.pow)

    def __rpow__(self, other):
        return self._binary(other, operator.pow, reverse=True)

    def __mod__(self, other):
        return self._binary(other, operator.mod)

    def __neg__(self):
        return NDArray(_engine.track(-self._data))

    def __iadd__(self, other):
        return self._inplace(other, operator.add)

    def __isub__(self, other):
        return self._inplace(other, operator.sub)

    def __imul__(self, other):
        return self._inplace(other, operator.mul)

    def __itruediv__(self, other):
        return self._inplace(other, operator.truediv)

    __idiv__ = __itruediv__

    def __len__(self):
        return self.shape[0]

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
                               device=_device(ctx)), ctx=ctx)


def zeros(shape, ctx: Optional[Context] = None, dtype=np.float32) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)), ctx=ctx)


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
        return NDArray(t, ctx=ctx)
    t = _tensor_from_numpy(np.asarray(source_array))
    return NDArray(t.to(device=device, dtype=torch_dtype(dtype)), ctx=ctx)


def ones(shape, ctx: Optional[Context] = None, dtype=np.float32) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx: Optional[Context] = None,
         dtype=np.float32) -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, ctx: Optional[Context] = None,
           dtype=np.float32) -> NDArray:
    """[start, stop) in steps of ``step``; ``arange(n)`` is [0, n)."""
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                                device=_device(ctx)))


def concatenate(arrays, axis: int = 0, always_copy: bool = True) -> NDArray:
    """Join arrays of one device along ``axis`` into a new array."""
    if not arrays:
        raise MXNetError("need at least one array")
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    return NDArray(torch.cat([a._get() for a in arrays], dim=axis))


def concat(*arrays, **kwargs) -> NDArray:
    return concatenate(list(arrays), axis=kwargs.get("dim", 1))


def onehot_encode(indices: NDArray, out: NDArray) -> NDArray:
    """out[i, indices[i]] = 1 and 0 elsewhere, written into ``out``; an
    index outside [0, k) gives a row of zeros, as ``jax.nn.one_hot``."""
    k = out.shape[1]
    idx = indices._get().to(torch.int64)
    classes = torch.arange(k, device=idx.device)
    out[:] = (idx[:, None] == classes[None, :])
    return out


def clip(arr: NDArray, a_min, a_max) -> NDArray:
    return NDArray(torch.clamp(arr._get(), a_min, a_max))


def dot(lhs: NDArray, rhs: NDArray) -> NDArray:
    return NDArray(torch.matmul(lhs._get(), rhs._get()))


def batch_dot(lhs: NDArray, rhs: NDArray) -> NDArray:
    return NDArray(torch.matmul(lhs._get(), rhs._get()))


def transpose(arr: NDArray, axes=None) -> NDArray:
    x = arr._get()
    axes = tuple(axes) if axes else tuple(reversed(range(x.dim())))
    return NDArray(x.permute(*axes).contiguous())


def _reduction(fn, arr: NDArray, axis, keepdims) -> NDArray:
    """The reference's reductions: over every axis a (1,) array, unless
    ``keepdims``; ``axis`` an int or a tuple."""
    x = arr._get()
    if axis is None:
        dims = tuple(range(x.dim()))
        return NDArray(fn(x, dim=dims, keepdim=True) if keepdims
                       else fn(x, dim=dims).reshape(-1))
    return NDArray(fn(x, dim=axis, keepdim=keepdims))


def sum(arr: NDArray, axis=None, keepdims=False) -> NDArray:  # noqa: A001
    return _reduction(torch.sum, arr, axis, keepdims)


def max(arr: NDArray, axis=None, keepdims=False) -> NDArray:  # noqa: A001
    return _reduction(torch.amax, arr, axis, keepdims)


def min(arr: NDArray, axis=None, keepdims=False) -> NDArray:  # noqa: A001
    return _reduction(torch.amin, arr, axis, keepdims)


def norm(arr: NDArray) -> NDArray:
    return NDArray(torch.sqrt(torch.sum(torch.square(arr._get())))
                   .reshape(1))


def argmax_channel(arr: NDArray) -> NDArray:
    x = arr._get()
    return NDArray(torch.argmax(x, dim=1).to(x.dtype))


def choose_element_0index(lhs: NDArray, rhs: NDArray) -> NDArray:
    """out[i] = lhs[i, rhs[i]]."""
    a = lhs._get()
    idx = rhs._get().to(torch.int64)
    return NDArray(a[torch.arange(a.shape[0], device=a.device), idx])


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0,
             channels=3, mean=None):
    """Decode an image (reference plugin/opencv): raises, as the
    reference's build without the opencv plugin does.  Decode JPEG/PNG
    records with ``io.ImageRecordIter`` or ``feed.record_pipeline``."""
    raise MXNetError("imdecode requires the opencv plugin; not available "
                     "in this build")


def waitall() -> None:
    """Wait for the work queued on every card the port has used
    (MXNDArrayWaitAll)."""
    _engine.wait_for_all()


# ---------------------------------------------------------------------------
# the registry of NDArray functions (reference NDArrayFunctionReg): the
# functions above and, from ``ops/nd_bridge.py``, every aux-free op

_NDARRAY_FUNCS: Dict[str, Any] = {}


def register_ndarray_fn(name: str, fn):
    """Expose ``fn`` as ``nd.<name>`` (and without leading underscores,
    unless that name is taken)."""
    _NDARRAY_FUNCS[name] = fn
    mod = sys.modules[__name__]
    public = name.lstrip("_")
    if not hasattr(mod, public):
        setattr(mod, public, fn)
    setattr(mod, name, fn)
    return fn


def list_functions() -> List[str]:
    return sorted(_NDARRAY_FUNCS)


for _name, _fn in [("_plus", operator.add), ("_minus", operator.sub),
                   ("_mul", operator.mul), ("_div", operator.truediv),
                   ("clip", clip), ("dot", dot), ("batch_dot", batch_dot),
                   ("onehot_encode", onehot_encode), ("sum", sum),
                   ("max", max), ("min", min), ("norm", norm),
                   ("argmax_channel", argmax_channel),
                   ("choose_element_0index", choose_element_0index),
                   ("transpose", transpose)]:
    register_ndarray_fn(_name, _fn)


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
    with open_stream(fname, "rb") as f:
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
