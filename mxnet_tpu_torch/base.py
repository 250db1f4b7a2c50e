"""Base types and helpers for mxnet_tpu_torch.

The PyTorch counterpart of ``mxnet_tpu/base.py``: the error type, the
environment accessor and the attribute bag that op parameters live in.
Locks are plain ``threading`` locks.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable

import numpy as np

__all__ = ["MXNetError", "numeric_types", "get_env", "atomic_local_write",
           "make_lock"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch functions."""


numeric_types = (float, int, np.generic)


def get_env(name: str, default: Any = None, typ: Callable = str) -> Any:
    """Typed environment read with a default (dmlc::GetEnv semantics)."""
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        if typ is bool:
            return val not in ("0", "false", "False", "")
        return typ(val)
    except (TypeError, ValueError):
        return default


def make_lock(name: str) -> threading.Lock:
    """A ``threading.Lock``.  ``name`` is the lock's class, dotted
    ``subsystem.role`` as in the JAX package, kept so that call sites read
    the same; it is not recorded."""
    return threading.Lock()


@contextlib.contextmanager
def atomic_local_write(fname: str, mode: str = "wb"):
    """Crash-safe publish of a local file: write a temp name in the same
    directory, flush + fsync, then ``os.replace`` onto ``fname``.  The
    published name is either absent or complete, never truncated."""
    tmp = "%s.tmp-%d" % (fname, os.getpid())
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, fname)
    except BaseException:
        f.close()
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _AttrDict(dict):
    """dict allowing attribute access, used for op parameter bags."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value
