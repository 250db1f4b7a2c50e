"""Execution engine facade (counterpart of ``mxnet_tpu/engine.py``).

The reference's dependency engine orders asynchronous work on mutable
buffers.  On the card, CUDA streams give the same guarantees: every op
of the port is queued on the current stream of its device, in program
order, and a read of an array on the host waits for the writes queued
before it.  So:

* WaitToRead / WaitToWrite -> ``NDArray.wait_to_read``: a synchronize of
  the array's stream;
* WaitForAll               -> :func:`wait_for_all`: a synchronize of
  every CUDA device the port has used;
* NaiveEngine              -> ``MXNET_ENGINE_TYPE=NaiveEngine`` or
  :class:`naive_mode`: a synchronize after every op (the executor's node
  walk, the imperative ``mx.nd`` ops, NDArray arithmetic), the
  reference's deterministic-debugging mode.  Off, the hook costs one
  attribute check per op.

Host closures pushed with dependency variables run on the port's native
C++ engine (:mod:`native_engine`, built from ``csrc/native/engine.cc``):
:meth:`Engine.new_var`, :meth:`Engine.push` with ``const_vars`` /
``mutable_vars``, :meth:`Engine.wait_for_var` on a
:class:`~native_engine.VarHandle`.  A closure runs on the pushing
thread's CUDA stream (so with its device current), and the waits also
wait for the card work the closures queued, so a host read after them
sees every write.  A push with no vars runs ``fn`` now and tracks its
result; so does every push in naive mode, which drains the native engine
first.
"""
from __future__ import annotations

import atexit
from typing import Any, Callable, Sequence

import torch

from .base import get_env, make_lock
from .context import used_cuda_devices

__all__ = ["Engine", "engine", "naive_mode", "wait_for_all", "track"]


def _sync(value) -> None:
    """Wait for the stream of every CUDA tensor in ``value`` (a tensor,
    an object holding one in ``_get()``, or a list/tuple of them)."""
    if isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)
        return
    get = getattr(value, "_get", None)
    t = get() if callable(get) else value
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class Engine:
    """The process's engine facade."""

    def __init__(self):
        self._naive = get_env("MXNET_ENGINE_TYPE",
                              "ThreadedEnginePerDevice") == "NaiveEngine"
        self._native = None  # the C++ engine, created at first use
        self._native_lock = make_lock("engine.native")

    # -- native host-side engine ---------------------------------------------
    @property
    def native(self):
        """The C++ dependency engine for host closures (built at first
        use; raises if its build fails), or None where no compiler can
        build it."""
        if self._native is None:
            with self._native_lock:
                if self._native is None:
                    from . import native_engine
                    if native_engine.lib_available():
                        eng = native_engine.NativeEngine()
                        atexit.register(eng.wait_for_all)
                        self._native = eng
        return self._native

    def new_var(self):
        """NewVariable (reference engine.h:104): a dependency token for
        host closures, or None without the native engine."""
        native = self.native
        return native.new_var() if native is not None else None

    def delete_var(self, var) -> None:
        if var is not None and self._native is not None:
            self._native.delete_var(var)

    @property
    def is_naive(self) -> bool:
        return self._naive

    def set_naive(self, value: bool) -> None:
        # drains in-flight native closures first: naive-mode pushes run
        # inline and must not race still-queued writes on the same vars
        if value:
            self.wait_for_all()
        self._naive = bool(value)

    def track(self, arr: Any) -> Any:
        """The op-dispatch hook: in naive mode wait for ``arr``'s stream
        before returning it."""
        if self._naive:
            _sync(arr)
        return arr

    def wait_for_var(self, arr: Any) -> None:
        """WaitForVar (reference engine.h:191): for a
        :class:`~native_engine.VarHandle`, the var's pending closures and
        the card work they queued; for an array (or a list of them), the
        work queued on its stream."""
        if arr is None:
            return
        from .native_engine import VarHandle
        if isinstance(arr, VarHandle):
            if self._native is not None:
                self._native.wait_for_var(arr)
            return
        _sync(arr)

    def push(self, fn: Callable[[], Any], const_vars: Sequence[int] = (),
             mutable_vars: Sequence[int] = (), prop: int = 0,
             priority: int = 0) -> Any:
        """Push (reference engine.h:129-163).  With vars from
        :meth:`new_var`, ``fn`` is scheduled on the native engine's worker
        pool once its dependencies are satisfied (serialized writes,
        batched reads) and None is returned; with no vars, or in naive
        mode, ``fn`` runs now and its result is tracked and returned."""
        if (const_vars or mutable_vars) and not self._naive:
            native = self.native
            if native is not None:
                native.push(fn, const_vars, mutable_vars, prop, priority)
                return None
        return self.track(fn())

    def wait_for_all(self) -> None:
        """WaitForAll: the native engine's closures, then the work queued
        on every CUDA device the port has used, and on the current one."""
        if self._native is not None:
            self._native.wait_for_all()
        devs = set(used_cuda_devices())
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            devs.add(torch.cuda.current_device())
        for dev in sorted(devs):
            torch.cuda.synchronize(dev)


_ENGINE = Engine()


def engine() -> Engine:
    return _ENGINE


def track(arr):
    return _ENGINE.track(arr)


def wait_for_all() -> None:
    _ENGINE.wait_for_all()


class naive_mode:
    """Context manager forcing synchronous execution (debugging aid)."""

    def __enter__(self):
        self._old = _ENGINE.is_naive
        _ENGINE.set_naive(True)
        return self

    def __exit__(self, *exc):
        _ENGINE.set_naive(self._old)
