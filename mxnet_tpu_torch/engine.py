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

Pushing host closures onto dependency variables needs the native engine
(``native_engine.py`` in the JAX package), which waits for ROADMAP.md
queue 1 item 14.
"""
from __future__ import annotations

from typing import Any

import torch

from .base import get_env
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

    @property
    def is_naive(self) -> bool:
        return self._naive

    def set_naive(self, value: bool) -> None:
        if value:
            self.wait_for_all()
        self._naive = bool(value)

    def track(self, arr: Any) -> Any:
        """The op-dispatch hook: in naive mode wait for ``arr``'s stream
        before returning it."""
        if self._naive:
            _sync(arr)
        return arr

    def wait_for_all(self) -> None:
        """WaitForAll: wait for the work queued on every CUDA device the
        port has used, and on the current one."""
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
