"""Async snapshot: the save off the training thread's critical path
(counterpart of ``mxnet_tpu/checkpoint/snapshot.py``).

A save has three phases:

1. **snapshot** (train thread): every device tensor is cloned on the
   device and copied, ``non_blocking``, into a pinned host buffer, all
   on the current stream, so the copies run before the next replay of
   the captured step overwrites the state in place; one CUDA event
   recorded after them marks the end.  Host tensors and arrays are
   copied at once.
2. **serialize** (writer thread): waits on the event, then writes the
   host buffers.  The writer never reads a live device buffer.
3. **commit** (writer thread): the layout.py rename + marker protocol.

:class:`AsyncWriter` is one daemon thread draining a bounded queue of
save jobs; a save issued while ``max_pending`` are in flight blocks the
caller.  A writer exception is re-raised on the next ``submit``/``wait``.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..base import make_rlock

__all__ = ["snapshot_tree", "HostSnapshot", "AsyncWriter", "map_structure"]


def map_structure(fn, node):
    """Structure-preserving map over the dict/tuple/list/None trees of a
    train state."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: map_structure(fn, v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        vals = [map_structure(fn, v) for v in node]
        return tuple(vals) if isinstance(node, tuple) else vals
    return fn(node)


class HostSnapshot:
    """A snapshot tree of host tensors/arrays, valid once ``ready()``
    returned (the device-to-host copies behind it have landed)."""

    def __init__(self, tree, event, pinned_bytes: int):
        self.tree = tree
        self._event = event
        self.pinned_bytes = pinned_bytes

    def ready(self):
        if self._event is not None:
            self._event.synchronize()
        return self.tree


def snapshot_tree(tree) -> HostSnapshot:
    """Device tensors: clone, then a non-blocking copy into pinned host
    memory, then one event after them all; host tensors and arrays are
    copied so that later writes by the caller cannot race the writer."""
    from ..ndarray import NDArray
    from .sharded import ShardedLeaf
    pinned = [0]
    used_cuda = []

    def snap(x):
        if isinstance(x, ShardedLeaf):
            # a shard another rank writes: its dtype only
            local = snap(x.local) if x.writes else \
                x.local.new_empty(0, device="cpu")
            return ShardedLeaf(local, x.shape, x.index, x.writes)
        if isinstance(x, NDArray):
            x = x._get()
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                dev = x.clone()
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(dev, non_blocking=True)
                pinned[0] += host.numel() * host.element_size()
                if x.device not in used_cuda:
                    used_cuda.append(x.device)
                return host
            return x.clone()
        return np.array(x, copy=True)

    out = map_structure(snap, tree)
    event = None
    if used_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(used_cuda[0]))
        for dev in used_cuda[1:]:
            torch.cuda.current_stream(dev).synchronize()
    return HostSnapshot(out, event, pinned[0])


class AsyncWriter:
    """One background writer thread with bounded in-flight saves."""

    def __init__(self, name: str = "ckpt-writer", max_pending: int = 2):
        assert max_pending >= 1
        self._max_pending = max_pending
        self._jobs: List[Callable[[], None]] = []
        # an RLock: a SIGTERM handler runs on the main thread between
        # bytecodes, may interrupt submit() while it holds the lock, and
        # re-enters wait()/submit() for its blocking save
        self._lock = make_rlock("checkpoint.async_writer")
        self._cv = threading.Condition(self._lock)
        self._error: Optional[BaseException] = None
        self._closed = False
        self._busy = False
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            with self._cv:
                while not self._jobs and not self._closed:
                    self._cv.wait(0.1)
                if not self._jobs:
                    return
                job = self._jobs.pop(0)
                self._busy = True
            try:
                job()
            except BaseException as exc:   # noqa: BLE001 re-raised at caller
                with self._cv:
                    self._error = exc
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _raise_pending(self):
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue a save job; blocks while ``max_pending`` are in
        flight.  Re-raises an earlier job's failure."""
        with self._cv:
            self._raise_pending()
            if self._closed:
                raise RuntimeError("AsyncWriter is closed")
            while len(self._jobs) + (1 if self._busy else 0) \
                    >= self._max_pending:
                self._cv.wait(0.1)
                self._raise_pending()
            self._jobs.append(job)
            self._cv.notify_all()

    def wait(self) -> None:
        """Drain every queued job; re-raise a writer failure."""
        with self._cv:
            while self._jobs or self._busy:
                self._cv.wait(0.1)
            self._raise_pending()

    def close(self, join: bool = True) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if join and self._thread.is_alive():
            self._thread.join(30.0)
        with self._cv:
            self._raise_pending()
