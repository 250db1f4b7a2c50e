"""Bounded-parallel warm-up: build program grids off the hot loop
(counterpart of ``mxnet_tpu/compile_cache/warmup.py``).

Host work (binds, ``nvcc`` builds, the autotune store's reads, an eager
walk's first use of cuBLAS/cuDNN) goes through a thread pool, so a
bucketing module's buckets or a predictor's shape sets warm with their
host work overlapped.  Tasks are (label, thunk); the
first failure is raised again as a :class:`WarmupError` that carries the
label, so a caller names the bucket or shape that failed.

CUDA graph captures are the exception.  A capture in PyTorch's default
("global") error mode makes a CUDA call from any other thread fail, and
two captures on one device would interleave.  So every capture takes
:func:`capture_lock` of its device and runs in the "thread_local" mode:
the captures of one device run one at a time, and the pool's other
threads keep their host and device work.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, make_lock

__all__ = ["WarmupError", "parallel_warm", "default_warmup_threads",
           "capture_lock", "capture"]


class WarmupError(MXNetError):
    """One warm-up task failed; ``label`` names it, ``__cause__`` is the
    original exception."""

    def __init__(self, label: str, cause: BaseException):
        super().__init__("warmup of %s failed: %s: %s"
                         % (label, type(cause).__name__, cause))
        self.label = label


def default_warmup_threads(ntasks: int) -> int:
    return max(1, min(ntasks, os.cpu_count() or 1))


_capture_locks: Dict[int, threading.Lock] = {}
_capture_locks_lock = make_lock("compile_cache.capture_locks")


def capture_lock(device) -> threading.Lock:
    """The lock every CUDA graph capture on ``device`` (a
    ``torch.device``) holds."""
    idx = device.index if getattr(device, "index", None) is not None else 0
    with _capture_locks_lock:
        return _capture_locks.setdefault(int(idx), threading.Lock())


def capture(device, body: Callable[[], object]):
    """Capture ``body`` into a new ``torch.cuda.CUDAGraph`` on
    ``device``, under the device's capture lock; -> (graph, what body
    returned)."""
    import torch
    with capture_lock(device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = body()
    return graph, out


def parallel_warm(tasks: Sequence[Tuple[str, Callable[[], object]]],
                  threads: Optional[int] = None) -> List[str]:
    """Run every thunk through a bounded pool; -> the labels in completion
    order.  Every task is attempted even after a failure (builds are
    idempotent and the others stay warm); the first failure is then
    raised as WarmupError."""
    tasks = list(tasks)
    if not tasks:
        return []
    if threads is None:
        threads = default_warmup_threads(len(tasks))
    threads = max(1, min(int(threads), len(tasks)))
    done: List[str] = []
    first_err = None
    if threads == 1:
        for label, thunk in tasks:
            try:
                thunk()
                done.append(label)
            except Exception as e:
                if first_err is None:
                    first_err = (label, e)
    else:
        with ThreadPoolExecutor(max_workers=threads,
                                thread_name_prefix="mx-compile-warm") as pool:
            futs = {pool.submit(thunk): label for label, thunk in tasks}
            for fut in as_completed(futs):
                label = futs[fut]
                try:
                    fut.result()
                    done.append(label)
                except Exception as e:
                    if first_err is None:
                        first_err = (label, e)
    if first_err is not None:
        raise WarmupError(first_err[0], first_err[1]) from first_err[1]
    return done
