"""Handle-table bridge backing the port's C ABI (counterpart of
``mxnet_tpu/capi_bridge.py``).

Reference analogue: src/c_api/c_api.cc (1543 LoC) marshals every MX* call
onto the C++ core; here the core is PyTorch on the card, reached through
this package, so the port's C ABI library (``csrc/capi/c_api.cc``, built
by :mod:`native_build` against the repository's ``include/c_api.h``)
embeds CPython and forwards each MX* function to one of the plain-typed
functions below, imported as ``mxnet_tpu_torch.capi_bridge``.  Every
object crossing the ABI (NDArray, Symbol, Executor, DataIter, KVStore,
Optimizer, RecordIO, Rtc, Predictor) is held in a process-wide handle
table keyed by integer id; the C side treats ids as opaque ``void*``
handles exactly like the reference's opaque pointers
(include/mxnet/c_api.h:37-66).

All arguments/returns are ints, floats, strs, bytes, or flat lists thereof
so the C++ marshalling layer stays mechanical.  Where the port differs
from the JAX package's bridge (ROADMAP.md, "Recorded differences"):

* dtype code 5 is ``torch.bfloat16``; its bytes cross as they are
  (numpy has no bfloat16, so they are read and written through torch);
* device code 1 is ``cpu``, 2 ``gpu`` (the card), 3 ``cpu_pinned``; code 4
  (``tpu``, which ``cpp-package``'s ``Context::tpu()`` sends) raises an
  error that names code 2.  A code-2 request on a machine with no card
  raises; it never runs on the CPU;
* ``rtc_create`` takes CUDA source, as ``mx.rtc`` does and as the
  original ``MXRtcCreate`` did (the JAX bridge takes Python source), and
  ``rtc_push`` takes the block dimensions as well as the grid.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError, make_lock

_TABLE: Dict[int, Any] = {}
_NEXT = [1]
_LOCK = make_lock("capi_bridge.handles")

# reference dtype codes (mshadow type flags used across the C ABI)
_DTYPE_TO_CODE = {"float32": 0, "float64": 1, "float16": 2, "uint8": 3,
                  "int32": 4, "bfloat16": 5}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}
_CODE_TO_TORCH = {0: torch.float32, 1: torch.float64, 2: torch.float16,
                  3: torch.uint8, 4: torch.int32, 5: torch.bfloat16}

_DEVSTR_TO_CODE = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}
_CODE_TO_DEVSTR = {v: k for k, v in _DEVSTR_TO_CODE.items()}

_GRAD_REQ = {0: "null", 1: "write", 2: "inplace", 3: "add"}


def _put(obj) -> int:
    with _LOCK:
        h = _NEXT[0]
        _NEXT[0] += 1
        _TABLE[h] = obj
    return h


def _get(h: int):
    return _TABLE[h]


def free_handle(h: int) -> None:
    with _LOCK:
        _TABLE.pop(h, None)


def _devstr(dev_type: int) -> str:
    if dev_type not in _CODE_TO_DEVSTR:
        raise MXNetError(
            "device type code %d is not carried by the PyTorch port: ask "
            "for code 2 (gpu, the card) or 1 (cpu)%s"
            % (dev_type, " — code 4 is the JAX package's tpu"
               if dev_type == 4 else ""))
    return _CODE_TO_DEVSTR[dev_type]


def _ctx(dev_type: int, dev_id: int):
    from . import context
    ctx = context.Context(_devstr(dev_type), dev_id)
    ctx.torch_device()      # no card -> raise now, never run on the CPU
    return ctx


def _nd():
    from . import ndarray
    return ndarray


def _dtype_code(dtype) -> int:
    """The ABI code of a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    return _DTYPE_TO_CODE[dtype if isinstance(dtype, str)
                          else np.dtype(dtype).name]


def _to_bytes(arr, as_float32: bool = False) -> bytes:
    """An array's elements as C-order bytes, through torch (bfloat16 by
    its bits)."""
    t = arr._get().detach()
    if as_float32:
        t = t.to(torch.float32)
    t = t.contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(data: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """A host tensor of ``dtype`` and ``shape`` over a copy of ``data``."""
    if not data:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.frombuffer(bytearray(data), dtype=dtype).view(tuple(shape))


def _assign(arr, value) -> None:
    """Write ``value`` (a tensor or a numpy array) into ``arr``'s buffer in
    place, on its device."""
    t = arr._get()
    src = value if isinstance(value, torch.Tensor) else \
        torch.as_tensor(np.ascontiguousarray(value))
    t.copy_(src.to(device=t.device, dtype=t.dtype).view(t.shape))


# ---------------------------------------------------------------------------
# misc

def random_seed(seed: int) -> None:
    from . import random as rnd
    rnd.seed(seed)


def notify_shutdown() -> None:
    from . import engine
    engine.wait_for_all()


# ---------------------------------------------------------------------------
# NDArray (reference c_api.cc MXNDArray*)

def ndarray_create_none() -> int:
    from .context import cpu
    return _put(_nd().zeros((), ctx=cpu()))


def ndarray_create(shape: List[int], dev_type: int, dev_id: int,
                   dtype_code: int = 0) -> int:
    arr = _nd().zeros(tuple(shape), ctx=_ctx(dev_type, dev_id),
                      dtype=_CODE_TO_TORCH[dtype_code])
    return _put(arr)


def ndarray_sync_copy_from(h: int, data: bytes, size: int = -1) -> None:
    """size is the element count (reference MXNDArraySyncCopyFromCPU
    convention); -1 skips the check (internal callers)."""
    arr = _get(h)
    n = int(np.prod(arr.shape)) if arr.shape else 1
    if size >= 0 and size != n:
        raise ValueError(
            "SyncCopyFromCPU size mismatch: array has %d elements, got %d"
            % (n, size))
    _assign(arr, _from_bytes(data, arr._get().dtype, arr.shape))


def ndarray_sync_copy_to(h: int, size: int = -1) -> bytes:
    """size is the element count; -1 skips the check (internal callers)."""
    arr = _get(h)
    n = int(np.prod(arr.shape)) if arr.shape else 1
    if size >= 0 and size != n:
        raise ValueError(
            "SyncCopyToCPU size mismatch: array has %d elements, got %d"
            % (n, size))
    return _to_bytes(arr)


def ndarray_wait_to_read(h: int) -> None:
    _get(h).wait_to_read()


def ndarray_wait_to_write(h: int) -> None:
    _get(h).wait_to_read()


def ndarray_wait_all() -> None:
    from . import engine
    engine.wait_for_all()


def ndarray_slice(h: int, start: int, stop: int) -> int:
    return _put(_get(h)[int(start):int(stop)])


def ndarray_at(h: int, idx: int) -> int:
    return _put(_get(h)[int(idx)])


def ndarray_reshape(h: int, shape: List[int]) -> int:
    return _put(_get(h).reshape(tuple(shape)))


def ndarray_get_shape(h: int) -> List[int]:
    return list(_get(h).shape)


def ndarray_get_dtype(h: int) -> int:
    return _dtype_code(_get(h)._get().dtype)


def ndarray_get_itemsize(h: int) -> int:
    return _get(h)._get().element_size()


def ndarray_check_copy_size(h: int, size: int) -> int:
    """Validate an element count against the array BEFORE the C side reads
    the caller's buffer; returns the dtype itemsize on success."""
    arr = _get(h)
    n = int(np.prod(arr.shape)) if arr.shape else 1
    if size != n:
        raise ValueError(
            "SyncCopy size mismatch: array has %d elements, got %d"
            % (n, size))
    return ndarray_get_itemsize(h)


def ndarray_get_context(h: int) -> List[int]:
    c = _get(h).context
    return [_DEVSTR_TO_CODE.get(c.device_type, 1), c.device_id]


def ndarray_save(fname: str, handles: List[int], keys: List[str]) -> None:
    nd = _nd()
    if keys:
        nd.save(fname, {k: _get(h) for k, h in zip(keys, handles)})
    else:
        nd.save(fname, [_get(h) for h in handles])


def ndarray_load(fname: str):
    from .context import cpu
    data = _nd().load(fname, ctx=cpu())   # host arrays, as the reference's
    if isinstance(data, dict):
        names = list(data.keys())
        handles = [_put(data[k]) for k in names]
    else:
        names = []
        handles = [_put(v) for v in data]
    return handles, names


# ---------------------------------------------------------------------------
# NDArray function registry (reference MXListFunctions/MXFuncInvoke)

def list_functions() -> List[str]:
    return _nd().list_functions()


# hand-written ndarray functions whose positional scalars are not visible to
# registry introspection: name -> (num_use_vars, num_scalars, num_mutate_vars)
_FUNC_SIGNATURES = {
    "clip": (1, 2, 1),
    "onehot_encode": (1, 1, 1),
    "choose_element_0index": (2, 0, 1),
    "fill_element_0index": (3, 0, 1),
}


def _scalar_params(op) -> List[str]:
    """Params of a registry op passable as positional ABI scalars: the
    SimpleOp scalar-family convention (Param("scalar", float,
    required=True)), else every float-typed param in declared order
    (the sample/clip families: low/high, loc/scale, a_min/a_max)."""
    named = [x.name for x in op.params
             if x.required and x.name == "scalar"]
    if named:
        return named
    return [x.name for x in op.params if x.typ is float]


def func_describe(name: str) -> List[int]:
    """[num_use_vars, num_scalars, num_mutate_vars, type_mask]; mirrors
    MXFuncDescribe (c_api.h:299-312)."""
    if name in _FUNC_SIGNATURES:
        nuse, nscalar, nmutate = _FUNC_SIGNATURES[name]
        return [nuse, nscalar, nmutate, 1]
    from .ops.registry import get_op
    try:
        op = get_op(name)
        scalars = _scalar_params(op)
        try:
            p = op.parse_params({s: 0.0 for s in scalars})
            nin = len(op.list_arguments(p))
        except Exception:
            # params beyond the scalars (e.g. the sample family's
            # required `shape`, supplied at invoke time from the mutate
            # target) block a dry parse; fall back to the declared arity
            nin = getattr(op, "_nin", 1)
        return [nin, len(scalars), 1, 1]
    except Exception:
        return [1, 0, 1, 1]


def func_get_info(name: str):
    fn = _nd()._NDARRAY_FUNCS[name]
    doc = fn.__doc__ or ""
    return [name, doc]


_ACCEPTS_OUT_CACHE: Dict[Any, bool] = {}


def _accepts_out(fn) -> bool:
    """True if fn can take an out= kwarg (named param or **kwargs).
    Signature inspection instead of try/except so a TypeError raised INSIDE
    the function body is never mistaken for 'no out kwarg' (which would
    re-execute fn and apply side effects twice).  Cached per function
    (keyed by the function OBJECT — an id() key could be recycled after a
    re-registration GCs the old fn): MXFuncInvoke is the operator hot
    path."""
    cached = _ACCEPTS_OUT_CACHE.get(fn)
    if cached is not None:
        return cached
    import inspect
    try:
        params = inspect.signature(fn).parameters
        result = "out" in params or any(
            p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())
    except (TypeError, ValueError):
        result = True  # builtins without signatures: assume out= works
    _ACCEPTS_OUT_CACHE[fn] = result
    return result


def _parse_param_str(v: str):
    """str -> int/float/tuple/str, the dmlc-parameter coercion used across
    the string-typed ABI channels (data iterators, MXFuncInvokeEx)."""
    def scalar(x):
        for conv in (int, float):
            try:
                return conv(x)
            except ValueError:
                continue
        return x
    if v.startswith("("):
        return tuple(scalar(x) for x in v.strip("()").split(",") if x)
    return scalar(v)


def func_invoke(name: str, use_handles: List[int], scalars: List[float],
                mutate_handles: List[int],
                param_keys: List[str] = (), param_vals: List[str] = ()) -> None:
    """param_keys/param_vals carry MXFuncInvokeEx's string kwargs
    (reference c_api.h:464-470); plain MXFuncInvoke passes none."""
    nd = _nd()
    fn = nd._NDARRAY_FUNCS[name]
    ins = [_get(h) for h in use_handles]
    outs = [_get(h) for h in mutate_handles]
    args = ins + list(scalars)
    kwargs = {k: _parse_param_str(v) for k, v in zip(param_keys, param_vals)}
    if name not in _FUNC_SIGNATURES and scalars:
        # registry ops take their scalars as named params (SimpleOp
        # scalar family); map the positional ABI scalars onto them
        from .ops.registry import get_op
        try:
            names = _scalar_params(get_op(name))
        except Exception:
            names = []
        if names:
            args = list(ins)
            kwargs.update(zip(names, scalars))
    if name not in _FUNC_SIGNATURES and mutate_handles:
        # ops with a required `shape` param and no inputs (the sample
        # family) take it from the destination: the ABI's scalar channel
        # cannot carry tuples
        from .ops.registry import get_op
        try:
            op = get_op(name)
            needs_shape = any(x.name == "shape" and x.required
                              for x in op.params)
        except Exception:
            needs_shape = False
        if needs_shape and "shape" not in kwargs:
            kwargs["shape"] = tuple(outs[0].shape)
    if not outs:
        fn(*args, **kwargs)
        return
    if _accepts_out(fn):
        fn(*args, out=outs[0], **kwargs)
        return
    res = fn(*args, **kwargs)
    if isinstance(res, (list, tuple)):
        res = res[0]
    if isinstance(res, nd.NDArray):
        res.copyto(outs[0])
    else:
        _assign(outs[0], np.asarray(res))


# ---------------------------------------------------------------------------
# Symbol (reference MXSymbol*)

def _sym():
    from . import symbol
    return symbol


def symbol_list_creators() -> List[str]:
    from .ops.registry import list_ops
    return list(list_ops())


def symbol_get_creator_info(name: str):
    """[name, description, key_var_num_args, arg_names..., arg_types...,
    arg_descs...] flattened with counts on the C side."""
    from .ops.registry import get_op
    op = get_op(name)
    schema = getattr(op, "param_schema", None) or {}
    arg_names, arg_types, arg_descs = [], [], []
    for pname, field in schema.items():
        arg_names.append(pname)
        arg_types.append(str(getattr(field, "type_str", "any")))
        arg_descs.append(str(getattr(field, "doc", "")))
    desc = (op.__doc__ or "").strip()
    kvar = op.variable_args or ""
    return [name, desc, kvar], arg_names, arg_types, arg_descs


def symbol_create_atomic(op_name: str, keys: List[str],
                         vals: List[str]) -> int:
    creator = getattr(_sym(), op_name, None)
    if creator is None:
        from .symbol import _make_atomic_symbol_function
        creator = _make_atomic_symbol_function(op_name)
    kwargs = dict(zip(keys, vals))
    return _put(creator(**kwargs))


def symbol_create_variable(name: str) -> int:
    return _put(_sym().Variable(name))


def symbol_create_group(handles: List[int]) -> int:
    return _put(_sym().Group([_get(h) for h in handles]))


def symbol_from_json(js: str) -> int:
    return _put(_sym().load_json(js))


def symbol_from_file(fname: str) -> int:
    return _put(_sym().load(fname))


def symbol_to_json(h: int) -> str:
    return _get(h).tojson()


def symbol_save_file(h: int, fname: str) -> None:
    _get(h).save(fname)


def symbol_copy(h: int) -> int:
    import copy
    return _put(copy.deepcopy(_get(h)))


def symbol_print(h: int) -> str:
    return _get(h).debug_str()


def symbol_get_attr(h: int, key: str) -> Optional[str]:
    return _get(h).attr(key)


def symbol_set_attr(h: int, key: str, value: str) -> None:
    for node, _ in _get(h)._heads:
        node.attrs[key] = value


def symbol_list_attr(h: int, recursive: bool) -> List[str]:
    """Flattened [k0, v0, k1, v1, ...]."""
    if recursive:
        flat = []
        for name, attrs in _get(h).attr_dict().items():
            for k, v in attrs.items():
                flat += ["%s$%s" % (name, k), str(v)]
        return flat
    out = []
    for k, v in _get(h).list_attr().items():
        out += [k, str(v)]
    return out


def symbol_list_arguments(h: int) -> List[str]:
    return _get(h).list_arguments()


def symbol_list_outputs(h: int) -> List[str]:
    return _get(h).list_outputs()


def symbol_list_aux(h: int) -> List[str]:
    return _get(h).list_auxiliary_states()


def symbol_get_internals(h: int) -> int:
    return _put(_get(h).get_internals())


def symbol_get_output(h: int, idx: int) -> int:
    return _put(_get(h)[idx])


def symbol_compose(h: int, name: str, keys: List[str],
                   arg_handles: List[int]) -> None:
    """MXSymbolCompose: reference atomic symbols expose raw argument names
    (``data``/``weight``) until composed; ours auto-prefix on creation, so
    map caller keys onto the prefixed names by suffix and re-prefix the
    remaining auto variables when compose assigns a new node name (matching
    reference compose+rename semantics, symbolic.h:77-142)."""
    from .symbol import _topo
    sym = _get(h)
    args = [_get(a) for a in arg_handles]
    arg_names = sym.list_arguments()
    head = sym._heads[0][0] if len(sym._heads) == 1 else None
    old_name = head.name if head is not None else None
    if keys:
        kwargs = {}
        for k, a in zip(keys, args):
            if k in arg_names:
                kwargs[k] = a
            else:
                matches = [an for an in arg_names if an.endswith("_" + k)]
                if len(matches) != 1:
                    raise ValueError("cannot map compose key %r onto %s"
                                     % (k, arg_names))
                kwargs[matches[0]] = a
        sym._compose(name=name or None, **kwargs)
    else:
        sym._compose(*args, name=name or None)
    if name and head is not None and old_name and name != old_name:
        prefix = old_name + "_"
        for node in _topo(sym._heads):
            for inp, _ in node.inputs:
                if inp.is_variable and inp.name.startswith(prefix):
                    inp.name = name + "_" + inp.name[len(prefix):]


def symbol_grad(h: int, wrt: List[str]) -> int:
    return _put(_get(h).grad(wrt))


def symbol_infer_shape(h: int, keys: List[str], shapes: List[List[int]],
                       partial: bool):
    """Returns (arg_shapes, out_shapes, aux_shapes, complete) with each group
    a list of int lists; raises on inference failure like the reference."""
    sym = _get(h)
    kwargs = {k: tuple(s) for k, s in zip(keys, shapes)}
    if partial:
        arg, out, aux = sym.infer_shape_partial(**kwargs)
    else:
        arg, out, aux = sym.infer_shape(**kwargs)
    if arg is None:
        return [], [], [], 0
    tolist = lambda group: [list(s) if s is not None else [] for s in group]
    return tolist(arg), tolist(out), tolist(aux), 1


def symbol_infer_type(h: int, keys: List[str], types: List[int]):
    sym = _get(h)
    kwargs = {k: _CODE_TO_DTYPE[t] for k, t in zip(keys, types)}
    arg, out, aux = sym.infer_type(**kwargs)
    if arg is None:
        return [], [], [], 0
    code = lambda group: [_dtype_code(t) if t is not None else -1
                          for t in group]
    return code(arg), code(out), code(aux), 1


# ---------------------------------------------------------------------------
# Executor (reference MXExecutor*)

def executor_bind(sym_h: int, dev_type: int, dev_id: int,
                  g2c_keys: List[str], g2c_dev_types: List[int],
                  g2c_dev_ids: List[int],
                  arg_handles: List[int], grad_handles: List[int],
                  grad_reqs: List[int], aux_handles: List[int],
                  shared_exec_h: int = 0) -> int:
    sym = _get(sym_h)
    ctx = _ctx(dev_type, dev_id)
    names = sym.list_arguments()
    args = [_get(h) for h in arg_handles]
    args_grad = {n: _get(h) for n, h in zip(names, grad_handles) if h}
    grad_req = {n: _GRAD_REQ[r] for n, r in zip(names, grad_reqs)}
    aux = [_get(h) for h in aux_handles]
    group2ctx = {k: _ctx(t, i) for k, t, i in
                 zip(g2c_keys, g2c_dev_types, g2c_dev_ids)} or None
    shared = _get(shared_exec_h) if shared_exec_h else None
    exe = sym.bind(ctx, args, args_grad=args_grad or None, grad_req=grad_req,
                   aux_states=aux or None, group2ctx=group2ctx,
                   shared_exec=shared)
    return _put(exe)


def executor_forward(h: int, is_train: int) -> None:
    _get(h).forward(is_train=bool(is_train))


def executor_backward(h: int, head_grad_handles: List[int]) -> None:
    grads = [_get(g) for g in head_grad_handles]
    _get(h).backward(grads if grads else None)


def executor_outputs(h: int) -> List[int]:
    return [_put(o) for o in _get(h).outputs]


def executor_print(h: int) -> str:
    return _get(h).debug_str()


# ---------------------------------------------------------------------------
# Data iterators (reference MXDataIter*)

_ITER_REGISTRY = ["MNISTIter", "CSVIter", "ImageRecordIter", "NDArrayIter"]


def list_data_iters() -> List[str]:
    return list(_ITER_REGISTRY)


def data_iter_create(name: str, keys: List[str], vals: List[str]) -> int:
    from . import io
    cls = getattr(io, name)
    kwargs = {k: _parse_param_str(v) for k, v in zip(keys, vals)}
    return _put(cls(**kwargs))


def data_iter_next(h: int) -> int:
    it = _get(h)
    try:
        batch = it.next()
    except StopIteration:
        return 0
    it._capi_batch = batch
    return 1


def data_iter_before_first(h: int) -> None:
    _get(h).reset()


def data_iter_get_data(h: int) -> int:
    return _put(_get(h)._capi_batch.data[0])


def data_iter_get_label(h: int) -> int:
    return _put(_get(h)._capi_batch.label[0])


def data_iter_get_pad(h: int) -> int:
    return int(_get(h)._capi_batch.pad or 0)


def data_iter_get_index(h: int) -> List[int]:
    idx = _get(h)._capi_batch.index
    return [int(i) for i in idx] if idx is not None else []


# ---------------------------------------------------------------------------
# KVStore (reference MXKVStore*)

def kvstore_create(type_str: str) -> int:
    from . import kvstore
    return _put(kvstore.create(type_str))


def kvstore_init(h: int, keys: List[int], val_handles: List[int]) -> None:
    _get(h).init(keys, [_get(v) for v in val_handles])


def kvstore_push(h: int, keys: List[int], val_handles: List[int],
                 priority: int) -> None:
    _get(h).push(keys, [_get(v) for v in val_handles], priority=priority)


def kvstore_pull(h: int, keys: List[int], out_handles: List[int],
                 priority: int) -> None:
    _get(h).pull(keys, [_get(v) for v in out_handles], priority=priority)


def kvstore_set_updater_addr(h: int, fn_addr: int, ctx_addr: int = 0) -> None:
    """Wrap a C callback ``void (*)(int key, NDArrayHandle recv,
    NDArrayHandle local, void*)`` (c_api.h MXKVStoreUpdater) via ctypes;
    ctx_addr is the caller's opaque updater_handle, passed back verbatim."""
    import ctypes
    cb_type = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p)
    cfn = cb_type(fn_addr)

    def updater(key, recv, local):
        hrecv, hlocal = _put(recv), _put(local)
        try:
            cfn(int(key), hrecv, hlocal, ctx_addr or None)
        finally:
            # handles are lent to the callback for its duration only
            # (reference engine frees them after the updater returns)
            free_handle(hrecv)
            free_handle(hlocal)

    kv = _get(h)
    kv._capi_updater_ref = cfn  # keep callback alive
    kv.set_updater(updater)


def kvstore_get_type(h: int) -> str:
    return _get(h).type


def kvstore_get_rank(h: int) -> int:
    return _get(h).rank


def kvstore_get_group_size(h: int) -> int:
    return _get(h).num_workers


def kvstore_barrier(h: int) -> None:
    _get(h)._barrier()


def kvstore_send_command(h: int, head: int, body: str) -> None:
    _get(h)._send_command_to_servers(head, body)


def kvstore_run_server(h: int) -> None:
    from .kvstore_server import KVStoreServer
    KVStoreServer(_get(h)).run()


# ---------------------------------------------------------------------------
# RecordIO (reference MXRecordIO*)

def recordio_writer_create(uri: str) -> int:
    from . import recordio
    return _put(recordio.MXRecordIO(uri, "w"))


def recordio_reader_create(uri: str) -> int:
    from . import recordio
    return _put(recordio.MXRecordIO(uri, "r"))


def recordio_close(h: int) -> None:
    _get(h).close()
    free_handle(h)


def recordio_write(h: int, buf: bytes) -> None:
    _get(h).write(buf)


def recordio_read(h: int) -> Optional[bytes]:
    return _get(h).read()


# ---------------------------------------------------------------------------
# Optimizer (reference MXOptimizer*; src/optimizer C++ registry analogue)

def optimizer_find_creator(name: str) -> int:
    from .optimizer import Optimizer
    key = name.lower()
    return 1 if key in Optimizer.opt_registry else 0


def optimizer_create(name: str, keys: List[str], vals: List[str]) -> int:
    from .optimizer import Optimizer
    kwargs: Dict[str, Any] = {}
    for k, v in zip(keys, vals):
        try:
            kwargs[k] = float(v)
        except ValueError:
            kwargs[k] = v
    opt = Optimizer.create_optimizer(name, **kwargs)
    opt._capi_states: Dict[int, Any] = {}
    return _put(opt)


def optimizer_update(h: int, index: int, weight_h: int, grad_h: int,
                     lr: float, wd: float) -> None:
    opt = _get(h)
    weight, grad = _get(weight_h), _get(grad_h)
    if index not in opt._capi_states:
        opt._capi_states[index] = opt.create_state(index, weight)
    opt.lr = lr
    opt.wd = wd
    opt.update(index, weight, grad, opt._capi_states[index])


# ---------------------------------------------------------------------------
# Rtc (reference MXRtc* — users' CUDA source, mx.rtc over nvcc)

def rtc_create(name: str, input_names: List[str], input_handles: List[int],
               output_names: List[str], output_handles: List[int],
               kernel_src: str) -> int:
    """kernel_src is the CUDA body of the ``__global__`` function, as the
    reference's MXRtcCreate took it (c_api.h); ``mx.rtc`` decorates and
    builds it."""
    from .rtc import Rtc
    ins = list(zip(input_names, [_get(h) for h in input_handles]))
    outs = list(zip(output_names, [_get(h) for h in output_handles]))
    return _put(Rtc(name, ins, outs, kernel_src))


def rtc_push(h: int, in_handles: List[int], out_handles: List[int],
             grid: List[int], block: List[int] = ()) -> None:
    rtc = _get(h)
    rtc.push([_get(i) for i in in_handles], [_get(o) for o in out_handles],
             tuple(grid) if grid else None, tuple(block) if block else None)


# ---------------------------------------------------------------------------
# Predict mini-ABI (reference include/mxnet/c_predict_api.h, 8 MXPred* +
# 3 MXNDList* functions — the deployment/amalgamation surface)

def pred_create(symbol_json: str, param_blob: bytes, dev_type: int,
                dev_id: int, input_keys: List[str],
                input_shapes: List[List[int]],
                output_keys: Optional[List[str]] = None) -> int:
    from . import ndarray as nd
    from .context import cpu
    from .predictor import Predictor, strip_param_prefixes
    from .symbol import load_json, Group
    devstr = _devstr(dev_type)
    params = nd.loads(param_blob, ctx=cpu())
    if isinstance(params, dict):
        params = strip_param_prefixes(params)
    sym = load_json(symbol_json)
    if output_keys:
        internals = sym.get_internals()
        outs = internals.list_outputs()
        picked = []
        for key in output_keys:
            want = key if key.endswith("_output") else key + "_output"
            if want not in outs:
                raise ValueError("unknown output %r" % key)
            picked.append(internals[outs.index(want)])
        sym = picked[0] if len(picked) == 1 else Group(picked)
    shapes = {k: tuple(s) for k, s in zip(input_keys, input_shapes)}
    pred = Predictor(sym.tojson(), params, shapes, devstr, dev_id)
    return _put(pred)


def pred_get_output_shape(h: int, index: int) -> List[int]:
    return list(_get(h).get_output_shape(index))


def pred_set_input(h: int, name: str, data: bytes) -> None:
    pred = _get(h)
    shape = pred._input_shapes[name]
    pred.set_input(name, np.frombuffer(bytearray(data),
                                       np.float32).reshape(shape))


def pred_forward(h: int) -> None:
    _get(h).forward()


def pred_partial_forward(h: int, step: int) -> int:
    """Reference MXPredPartialForward walks the graph one monitored step at
    a time; as in the JAX package's bridge, step 0 runs the whole forward
    and 0 steps remain (documented divergence)."""
    if step == 0:
        _get(h).forward()
    return 0


def pred_get_output(h: int, index: int) -> bytes:
    out = _get(h).get_output(index)
    return np.ascontiguousarray(out, dtype=np.float32).tobytes()


def ndlist_create(param_blob: bytes):
    """Returns (handle, names); MXNDListCreate."""
    from . import ndarray as nd
    from .context import cpu
    params = nd.loads(param_blob, ctx=cpu())
    if isinstance(params, dict):
        names = list(params.keys())
        arrays = [params[k] for k in names]
    else:
        names = ["" for _ in params]
        arrays = params
    return _put((names, arrays)), names


def ndlist_get(h: int, index: int):
    """Returns (name, data_bytes, shape); MXNDListGet."""
    names, arrays = _get(h)
    arr = arrays[index]
    return names[index], _to_bytes(arr, as_float32=True), list(arr.shape)


# ---------------------------------------------------------------------------
# Raw-byte NDArray serialization (reference MXNDArraySaveRawBytes /
# MXNDArrayLoadFromRawBytes, c_api.h:218-230 — the kvstore/cross-process
# send format).  Self-describing little-endian framing:
#   u32 magic | i32 dtype_code | u32 ndim | u32 dims[ndim] | payload

_RAW_MAGIC = 0x4D585452  # "MXTR"


def ndarray_save_raw(h: int) -> bytes:
    arr = _get(h)
    code = _dtype_code(arr._get().dtype)
    head = np.array([_RAW_MAGIC, code & 0xFFFFFFFF, len(arr.shape)]
                    + list(arr.shape), dtype="<u4").tobytes()
    return head + _to_bytes(arr)


def ndarray_load_raw(buf: bytes) -> int:
    head = np.frombuffer(buf[:12], dtype="<u4")
    if len(head) < 3 or head[0] != _RAW_MAGIC:
        raise ValueError("corrupt NDArray raw-bytes header")
    code, ndim = int(head[1]), int(head[2])
    dims = np.frombuffer(buf[12:12 + 4 * ndim], dtype="<u4")
    shape = tuple(int(d) for d in dims)
    dtype = _CODE_TO_TORCH[code]
    payload = buf[12 + 4 * ndim:]
    n = int(np.prod(shape)) if shape else 1
    if len(payload) != n * torch.empty((), dtype=dtype).element_size():
        raise ValueError("raw-bytes payload size mismatch")
    from .context import cpu
    arr = _nd().zeros(shape, ctx=cpu(), dtype=dtype)
    _assign(arr, _from_bytes(payload, arr._get().dtype, shape))
    return _put(arr)


# ---------------------------------------------------------------------------
# Symbol name introspection (reference MXSymbolGetName /
# MXSymbolGetAtomicSymbolName, c_api.h:488-604)

def symbol_get_name(h: int) -> Optional[str]:
    return _get(h).name


# ---------------------------------------------------------------------------
# Executor monitor from non-python frontends
# (reference MXExecutorSetMonitorCallback, c_api.h:991-993)

def executor_set_monitor_addr(h: int, fn_addr: int, ctx_addr: int = 0) -> None:
    """Wrap a C callback ``void (*)(const char*, NDArrayHandle, void*)``
    (ExecutorMonitorCallback) and install it as the executor's per-op
    monitor.  The NDArray handle is lent for the callback's duration only,
    like the kvstore updater's."""
    import ctypes
    cb_type = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_void_p)
    cfn = cb_type(fn_addr)

    def monitor(name, arr):
        hnd = _put(arr)
        try:
            cfn(name.encode(), hnd, ctx_addr or None)
        finally:
            free_handle(hnd)

    exe = _get(h)
    exe._capi_monitor_ref = cfn  # keep the callback alive
    exe.set_monitor_callback(monitor)


# ---------------------------------------------------------------------------
# ABI-registered custom operators (reference MXCustomOpRegister,
# c_api.h:1375 + the CustomOpPropInfo/CustomOpInfo callback structs at
# c_api.h:96-135).  A frontend registers a creator; each sym.Custom
# instantiation calls it and drives the returned callback table.  The
# Python-side mirror of this dance is reference python/mxnet/operator.py
# register(); here the roles flip: C is the producer, Python the consumer.

def _custom_ctypes():
    import ctypes

    class CustomOpInfo(ctypes.Structure):
        _fields_ = [
            ("forward", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_void_p)),
            ("backward", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_void_p)),
            ("del_", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)),
            ("p_forward", ctypes.c_void_p),
            ("p_backward", ctypes.c_void_p),
            ("p_del", ctypes.c_void_p),
        ]

    class CustomOpPropInfo(ctypes.Structure):
        _fields_ = [
            ("list_arguments", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),
                ctypes.c_void_p)),
            ("list_outputs", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),
                ctypes.c_void_p)),
            ("infer_shape", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint)),
                ctypes.c_void_p)),
            ("declare_backward_dependency", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
                ctypes.c_void_p)),
            ("create_operator", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(CustomOpInfo), ctypes.c_void_p)),
            ("list_auxiliary_states", ctypes.CFUNCTYPE(
                ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p)),
                ctypes.c_void_p)),
            ("del_", ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)),
            ("p_list_arguments", ctypes.c_void_p),
            ("p_list_outputs", ctypes.c_void_p),
            ("p_infer_shape", ctypes.c_void_p),
            ("p_declare_backward_dependency", ctypes.c_void_p),
            ("p_create_operator", ctypes.c_void_p),
            ("p_list_auxiliary_states", ctypes.c_void_p),
            ("p_del", ctypes.c_void_p),
        ]

    return CustomOpInfo, CustomOpPropInfo


def _read_null_terminated(pp) -> List[str]:
    """Read a NULL-terminated char** the callee handed back."""
    out = []
    i = 0
    while pp[i]:
        out.append(pp[i].decode())
        i += 1
    return out


def _safe_c_del(del_fn, state) -> None:
    """Invoke a frontend del_ callback, swallowing failures (destructor
    context: nothing useful can be raised)."""
    try:
        del_fn(state)
    except Exception:
        pass


def custom_op_register(op_type: str, creator_addr: int) -> None:
    """MXCustomOpRegister: wrap the frontend's CustomOpPropCreator in a
    CustomOpProp subclass and place it in the sym.Custom registry.  The
    callback tag protocol (0=in_data 1=out_data 2=in_grad 3=out_grad
    4=aux) and req encoding (0=null 1=write 2=inplace 3=add) match the
    reference custom-inl.h dispatch."""
    import ctypes
    from . import operator as _op
    from .base import MXNetError
    CustomOpInfo, CustomOpPropInfo = _custom_ctypes()
    creator_t = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(CustomOpPropInfo))
    creator = creator_t(creator_addr)

    class _CBackedOp(_op.CustomOp):
        def __init__(self, info):
            self._info = info
            # the frontend's del_ releases per-operator state; fire it when
            # the Python wrapper dies (the reference frees on operator
            # destruction, custom-inl.h)
            if info.del_:
                import weakref
                weakref.finalize(self, _safe_c_del, info.del_, info.p_del)

        def _drive(self, fn, state, groups, reqs, is_train):
            """groups: list of (tag, [NDArray...]) in protocol order."""
            flat, tags = [], []
            for tag, arrs in groups:
                for a in arrs:
                    flat.append(a)
                    tags.append(tag)
            handles = [_put(a) for a in flat]
            try:
                n = len(flat)
                ptrs = (ctypes.c_void_p * n)(*handles)
                tarr = (ctypes.c_int * n)(*tags)
                rarr = (ctypes.c_int * max(1, len(reqs)))(*(reqs or [1]))
                if not fn(n, ptrs, tarr, rarr, bool(is_train), state):
                    raise MXNetError("custom op %r C callback failed"
                                     % op_type)
            finally:
                for hh in handles:
                    free_handle(hh)

        def forward(self, is_train, req, in_data, out_data, aux):
            reqs = [_REQ_CODE.get(r, 1) for r in req]
            self._drive(self._info.forward, self._info.p_forward,
                        [(0, in_data), (1, out_data), (4, aux)], reqs,
                        is_train)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            reqs = [_REQ_CODE.get(r, 1) for r in req]
            # backward only ever runs under gradient computation, i.e.
            # training: the reference forwards its ctx.is_train here
            self._drive(self._info.backward, self._info.p_backward,
                        [(0, in_data), (1, out_data), (2, in_grad),
                         (3, out_grad), (4, aux)], reqs, True)

    # One creator call per distinct kwargs set, cached for the process:
    # CustomSymbolOp re-derives the prop on every graph query, and
    # re-invoking a C creator that allocates state each time would leak.
    # Cached infos are released through del_ at interpreter exit.
    _prop_info_cache: Dict[tuple, Any] = {}

    def _prop_info_for(kwargs):
        key = tuple(sorted(kwargs.items()))
        info = _prop_info_cache.get(key)
        if info is not None:
            return info
        info = CustomOpPropInfo()
        keys = [k.encode() for k in kwargs]
        vals = [str(kwargs[k]).encode() for k in kwargs]
        karr = (ctypes.c_char_p * max(1, len(keys)))(*(keys or [b""]))
        varr = (ctypes.c_char_p * max(1, len(vals)))(*(vals or [b""]))
        if not creator(op_type.encode(), len(keys), karr, varr,
                       ctypes.byref(info)):
            raise MXNetError("custom op creator for %r failed" % op_type)
        _prop_info_cache[key] = info
        if info.del_:
            import atexit
            atexit.register(_safe_c_del, info.del_, info.p_del)
        return info

    class _CBackedProp(_op.CustomOpProp):
        def __init__(self, **kwargs):
            super().__init__(need_top_grad=True)
            self._info = _prop_info_for(kwargs)
            # derive need_top_grad from the frontend's dependency
            # declaration (reference custom-inl.h consumes it the same
            # way: out_grad absent from deps => loss-style op)
            if self._info.declare_backward_dependency:
                n_out = len(self.list_outputs())
                n_in = len(self.list_arguments())
                og = list(range(n_out))
                ind = list(range(n_out, n_out + n_in))
                od = list(range(n_out + n_in, 2 * n_out + n_in))
                deps = set(self.declare_backward_dependency(og, ind, od))
                self.need_top_grad_ = any(i in deps for i in og)

        def list_arguments(self):
            pp = ctypes.POINTER(ctypes.c_char_p)()
            if not self._info.list_arguments(ctypes.byref(pp),
                                             self._info.p_list_arguments):
                raise MXNetError("%s.list_arguments failed" % op_type)
            return _read_null_terminated(pp)

        def list_outputs(self):
            pp = ctypes.POINTER(ctypes.c_char_p)()
            if not self._info.list_outputs(ctypes.byref(pp),
                                           self._info.p_list_outputs):
                raise MXNetError("%s.list_outputs failed" % op_type)
            return _read_null_terminated(pp)

        def list_auxiliary_states(self):
            if not self._info.list_auxiliary_states:
                return []
            pp = ctypes.POINTER(ctypes.c_char_p)()
            if not self._info.list_auxiliary_states(
                    ctypes.byref(pp), self._info.p_list_auxiliary_states):
                raise MXNetError("%s.list_auxiliary_states failed" % op_type)
            return _read_null_terminated(pp)

        def declare_backward_dependency(self, out_grad, in_data, out_data):
            """Drive the frontend's dependency declaration (ids in, ids
            out).  Falls back to the base-class superset when the frontend
            left the slot empty."""
            if not self._info.declare_backward_dependency:
                return super().declare_backward_dependency(
                    out_grad, in_data, out_data)
            og = (ctypes.c_int * max(1, len(out_grad)))(*(out_grad or [0]))
            ind = (ctypes.c_int * max(1, len(in_data)))(*(in_data or [0]))
            od = (ctypes.c_int * max(1, len(out_data)))(*(out_data or [0]))
            num = ctypes.c_int(0)
            deps = ctypes.POINTER(ctypes.c_int)()
            if not self._info.declare_backward_dependency(
                    og, ind, od, ctypes.byref(num), ctypes.byref(deps),
                    self._info.p_declare_backward_dependency):
                raise MXNetError("%s.declare_backward_dependency failed"
                                 % op_type)
            return [int(deps[i]) for i in range(num.value)]

        def infer_shape(self, in_shape):
            n_in = len(self.list_arguments())
            n_out = len(self.list_outputs())
            n_aux = len(self.list_auxiliary_states())
            n = n_in + n_out + n_aux
            ndims = (ctypes.c_int * n)()
            shapes = (ctypes.POINTER(ctypes.c_uint) * n)()
            keep = []  # input dim buffers stay alive across the call
            for i, s in enumerate(in_shape):
                buf = (ctypes.c_uint * max(1, len(s)))(*[int(x) for x in s])
                keep.append(buf)
                ndims[i] = len(s)
                shapes[i] = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint))
            if not self._info.infer_shape(n, ndims, shapes,
                                          self._info.p_infer_shape):
                raise MXNetError("%s.infer_shape failed" % op_type)
            read = lambda i: [int(shapes[i][j]) for j in range(ndims[i])]
            return ([read(i) for i in range(n_in)],
                    [read(n_in + i) for i in range(n_out)],
                    [read(n_in + n_out + i) for i in range(n_aux)])

        def create_operator(self, ctx, in_shapes, in_dtypes):
            n = len(in_shapes)
            ndims = (ctypes.c_int * max(1, n))()
            shapes = (ctypes.POINTER(ctypes.c_uint) * max(1, n))()
            keep = []
            for i, s in enumerate(in_shapes):
                buf = (ctypes.c_uint * max(1, len(s)))(*[int(x) for x in s])
                keep.append(buf)
                ndims[i] = len(s)
                shapes[i] = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint))
            dtypes = (ctypes.c_int * max(1, n))(
                *[_dtype_code(t) for t in in_dtypes])
            info = CustomOpInfo()
            if not self._info.create_operator(
                    str(ctx or "cpu").encode(), n, shapes, ndims, dtypes,
                    ctypes.byref(info), self._info.p_create_operator):
                raise MXNetError("%s.create_operator failed" % op_type)
            op = _CBackedOp(info)
            op._keep = keep
            return op

    _REQ_CODE = {"null": 0, "write": 1, "inplace": 2, "add": 3}
    _CBackedProp.__name__ = "_CBackedProp_%s" % op_type
    _op._CUSTOM_REGISTRY[op_type] = _CBackedProp
    # the frontend owns the creator's lifetime (reference keeps it in its
    # own ref_holder); ours pins the ctypes wrapper for the process
    _CUSTOM_CREATOR_REFS[op_type] = creator


_CUSTOM_CREATOR_REFS: Dict[str, Any] = {}
