"""ctypes bindings for the port's native dependency engine and pooled host
storage (counterpart of ``mxnet_tpu/native_engine.py``), over the host
library built from ``csrc/native/engine.cc`` and ``storage.cc``
(:mod:`native_build`, object ``host``).

Reference analogue: the C++ async dataflow scheduler src/engine/
(ThreadedEnginePerDevice, threaded_engine_perdevice.cc:26-183) and the
pooled storage manager src/storage/pooled_storage_manager.h, reached
through a C ABI as the reference's python package reached libmxnet.so.

CUDA streams already order the card's work, so the engine schedules
host closures on C++ worker threads with the reference's Var semantics:
serialized writes, batched reads, WaitForVar/WaitForAll.  A closure runs
on the stream (and so the device) that was current on the pushing thread
when CUDA was in use there.  The C++ engine marks a var done when the
closure returns, which for a closure that queues card work is before the
work ends; so after the native wait, :meth:`NativeEngine.wait_for_var`
and :meth:`NativeEngine.wait_for_all` also wait for the streams the
closures ran on, and a host read after them sees every write.
"""
from __future__ import annotations

import ctypes
import traceback
from typing import Callable, Dict, Optional, Sequence

import torch

from . import native_build
from .base import get_env, make_lock

__all__ = ["NativeEngine", "NativeStorage", "FnProperty", "VarHandle",
           "lib_available"]

_LIB = None
_TRAMPOLINE = None
_FNTY = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class VarHandle(int):
    """Opaque dependency token from Engine.new_var (reference engine.h
    VarHandle).  A distinct type (not a bare int) so facade APIs can tell
    a var token apart from scalars and arrays."""
    __slots__ = ()

    def __repr__(self):
        return "VarHandle(%d)" % int(self)


class FnProperty:
    """Scheduling hints (reference include/mxnet/engine.h:58-69)."""
    kNormal = 0
    kCopyFromDevice = 1
    kCopyToDevice = 2
    kPrioritized = 3
    kAsync = 4


def _declare(lib) -> None:
    u64 = ctypes.c_uint64
    u64p = ctypes.POINTER(u64)
    vp = ctypes.c_void_p
    lib.mxtpu_engine_create.restype = vp
    lib.mxtpu_engine_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mxtpu_engine_free.argtypes = [vp]
    lib.mxtpu_engine_new_var.restype = u64
    lib.mxtpu_engine_new_var.argtypes = [vp]
    lib.mxtpu_engine_delete_var.argtypes = [vp, u64]
    lib.mxtpu_engine_push.restype = ctypes.c_int
    lib.mxtpu_engine_push.argtypes = [
        vp, _FNTY, vp, u64p, ctypes.c_int, u64p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.mxtpu_engine_wait_for_var.argtypes = [vp, u64]
    lib.mxtpu_engine_wait_for_all.argtypes = [vp]
    lib.mxtpu_engine_num_pending.restype = ctypes.c_long
    lib.mxtpu_engine_num_pending.argtypes = [vp]
    lib.mxtpu_storage_create.restype = vp
    lib.mxtpu_storage_create.argtypes = [ctypes.c_double]
    lib.mxtpu_storage_destroy.argtypes = [vp]
    lib.mxtpu_storage_alloc.restype = vp
    lib.mxtpu_storage_alloc.argtypes = [vp, u64]
    lib.mxtpu_storage_free.argtypes = [vp, vp]
    lib.mxtpu_storage_direct_free.argtypes = [vp, vp]
    lib.mxtpu_storage_release_all.argtypes = [vp]
    for sym in ("pool_bytes", "used_bytes", "num_allocs", "pool_hits"):
        f = getattr(lib, "mxtpu_storage_" + sym)
        f.restype = ctypes.c_long
        f.argtypes = [vp]


def _tramp(token):
    """The one C-callable trampoline: C passes back the token of a queued
    closure.  ctypes takes the GIL for the call, so closures run safely on
    the C++ worker threads."""
    with _CLOSURES_LOCK:
        item = _CLOSURES.pop(token, None)
    if item is None:
        return
    fn, stream = item
    try:
        if stream is None:
            fn()
        else:
            with torch.cuda.stream(stream):
                fn()
    except Exception:  # an engine closure must never unwind into C++
        traceback.print_exc()


def _load():
    """The host library, built at first use (raises if the build fails)."""
    global _LIB, _TRAMPOLINE
    if _LIB is None:
        lib = native_build.load("host")
        _declare(lib)
        _TRAMPOLINE = _FNTY(_tramp)
        _LIB = lib
    return _LIB


_CLOSURES: Dict[int, tuple] = {}
_CLOSURES_LOCK = make_lock("native_engine.closures")
_NEXT_TOKEN = [1]


def lib_available() -> bool:
    """Whether the host library is built or can be built here (``g++`` is
    on PATH).  Loading it raises if its build fails."""
    return native_build.available("host")


def _pushing_stream():
    """The pushing thread's current CUDA stream, when this process uses
    CUDA (never initializes it)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_stream()
    return None


class NativeEngine:
    """The C++ dependency engine (reference Engine,
    include/mxnet/engine.h:74-223)."""

    def __init__(self, num_workers: Optional[int] = None,
                 num_prio_workers: Optional[int] = None):
        lib = _load()
        if num_workers is None:
            num_workers = int(get_env("MXNET_CPU_WORKER_NTHREADS", "4"))
        if num_prio_workers is None:
            num_prio_workers = int(get_env("MXNET_CPU_PRIORITY_NTHREADS",
                                           "2"))
        self._lib = lib
        self._h = lib.mxtpu_engine_create(num_workers, num_prio_workers)
        # the CUDA streams closures ran on, waited for after native waits
        self._streams: Dict[tuple, torch.cuda.Stream] = {}

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and self._lib:
            self._lib.mxtpu_engine_free(h)

    # -- vars ---------------------------------------------------------------
    def new_var(self) -> VarHandle:
        return VarHandle(self._lib.mxtpu_engine_new_var(self._h))

    def delete_var(self, var: int) -> None:
        self._lib.mxtpu_engine_delete_var(self._h, var)

    # -- push ---------------------------------------------------------------
    def push(self, fn: Callable[[], None],
             const_vars: Sequence[int] = (),
             mutable_vars: Sequence[int] = (),
             prop: int = FnProperty.kNormal,
             priority: int = 0) -> None:
        """PushAsync (reference engine.h:129): run fn on a worker thread
        once every const/mutable dependency is satisfied, on the pushing
        thread's CUDA stream.  Raises on duplicate or deleted vars
        (reference CheckDuplicate aborts; we raise)."""
        stream = _pushing_stream()
        if stream is not None:
            self._streams.setdefault(
                (stream.device_index, stream.stream_id), stream)
        with _CLOSURES_LOCK:
            token = _NEXT_TOKEN[0]
            _NEXT_TOKEN[0] += 1
            _CLOSURES[token] = (fn, stream)
        nc, nm = len(const_vars), len(mutable_vars)
        cv = (ctypes.c_uint64 * max(nc, 1))(*const_vars)
        mv = (ctypes.c_uint64 * max(nm, 1))(*mutable_vars)
        rc = self._lib.mxtpu_engine_push(
            self._h, _TRAMPOLINE, ctypes.c_void_p(token), cv, nc, mv, nm,
            prop, priority)
        if rc != 0:
            with _CLOSURES_LOCK:
                _CLOSURES.pop(token, None)
            raise ValueError("engine push rejected: duplicate or deleted "
                             "vars")

    # -- waits --------------------------------------------------------------
    def _wait_card(self) -> None:
        for stream in list(self._streams.values()):
            stream.synchronize()

    def wait_for_var(self, var: int) -> None:
        """WaitForVar: the var's pending writes have run, and the card work
        they queued is done."""
        self._lib.mxtpu_engine_wait_for_var(self._h, var)
        self._wait_card()

    def wait_for_all(self) -> None:
        self._lib.mxtpu_engine_wait_for_all(self._h)
        self._wait_card()

    def num_pending(self) -> int:
        return self._lib.mxtpu_engine_num_pending(self._h)


class NativeStorage:
    """Pooled host storage manager (reference
    pooled_storage_manager.h:23-47).

    MXNET_EXEC_MATCH_RANGE bounds how much larger a recycled block may be
    than the request (reference graph_memory_allocator.h match_range_).
    """

    def __init__(self, match_range: Optional[float] = None):
        lib = _load()
        if match_range is None:
            match_range = float(get_env("MXNET_EXEC_MATCH_RANGE", "16"))
        self._lib = lib
        self._h = lib.mxtpu_storage_create(float(match_range))

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and self._lib:
            self._lib.mxtpu_storage_destroy(h)

    def alloc(self, size: int) -> int:
        p = self._lib.mxtpu_storage_alloc(self._h, size)
        if not p:
            raise MemoryError("native storage alloc of %d bytes failed"
                              % size)
        return p

    def free(self, ptr: int) -> None:
        self._lib.mxtpu_storage_free(self._h, ctypes.c_void_p(ptr))

    def direct_free(self, ptr: int) -> None:
        self._lib.mxtpu_storage_direct_free(self._h, ctypes.c_void_p(ptr))

    def release_all(self) -> None:
        self._lib.mxtpu_storage_release_all(self._h)

    @property
    def pool_bytes(self) -> int:
        return self._lib.mxtpu_storage_pool_bytes(self._h)

    @property
    def used_bytes(self) -> int:
        return self._lib.mxtpu_storage_used_bytes(self._h)

    @property
    def num_allocs(self) -> int:
        return self._lib.mxtpu_storage_num_allocs(self._h)

    @property
    def pool_hits(self) -> int:
        return self._lib.mxtpu_storage_pool_hits(self._h)
