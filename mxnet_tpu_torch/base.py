"""Base types and helpers for mxnet_tpu_torch.

The PyTorch counterpart of ``mxnet_tpu/base.py``: the error type, the
environment accessor, local paths with an optional ``file://`` scheme,
the attribute bag that op parameters live in, and the named lock
factories: plain ``threading`` primitives, or with ``MXNET_LOCK_CHECK=1``
the lock-order recorder's (``analysis.lockcheck``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Callable

import numpy as np

__all__ = ["MXNetError", "numeric_types", "get_env", "atomic_local_write",
           "make_lock", "make_rlock", "make_condition", "is_local_path",
           "local_path", "open_stream", "fsync_dir"]


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch functions."""


numeric_types = (float, int, np.generic)


def get_env(name: str, default: Any = None, typ: Callable = str) -> Any:
    """Typed environment read with a default (dmlc::GetEnv semantics)."""
    # lint: allow(raw-env) — this IS the accessor every other read routes
    # through; the rule exists to funnel reads here
    val = os.environ.get(name)
    if val is None:
        return default
    try:
        if typ is bool:
            return val not in ("0", "false", "False", "")
        return typ(val)
    except (TypeError, ValueError):
        return default


def make_lock(name: str):
    """Named ``threading.Lock`` for the lock-order recorder.

    Every lock in mxnet_tpu_torch is created through this factory (or
    :func:`make_rlock` / :func:`make_condition`).  ``name`` is the lock
    CLASS, dotted ``subsystem.role`` as in the JAX package:
    ``"serve.swap"`` names every engine's swap lock, not one instance.
    With ``MXNET_LOCK_CHECK=1`` the returned lock records the
    per-process acquisition graph and reports order cycles (potential
    deadlocks) through ``mxnet_tpu_torch.analysis.lockcheck``; otherwise
    it is a plain ``threading.Lock``."""
    from .analysis.lockcheck import make_lock as _mk
    return _mk(name)


def make_rlock(name: str):
    """Named ``threading.RLock`` (see :func:`make_lock`)."""
    from .analysis.lockcheck import make_rlock as _mk
    return _mk(name)


def make_condition(name: str):
    """Named ``threading.Condition`` (see :func:`make_lock`); ``wait``
    releases the name in the order model."""
    from .analysis.lockcheck import make_condition as _mk
    return _mk(name)


def is_local_path(fname: str) -> bool:
    """Whether ``fname`` names the local filesystem: a bare path or a
    ``file://`` URI."""
    return "://" not in fname or fname.startswith("file://")


def local_path(fname: str) -> str:
    """Strip an optional ``file://`` scheme off a local path."""
    return fname[len("file://"):] if fname.startswith("file://") else fname


def open_stream(fname: str, mode: str = "r"):
    """Open a local path or a ``file://`` URI.  Other schemes (s3://,
    hdfs:// ...) need a protocol handler the port does not carry, and
    raise naming the scheme rather than writing a bogus local file."""
    if not is_local_path(fname):
        raise MXNetError(
            "URI %r: no protocol handler for %r in this build; copy the "
            "file locally" % (fname, fname.split("://", 1)[0]))
    return open(local_path(fname), mode)


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename or create inside it is durable
    before success is reported (the checkpoint commit protocol,
    ``checkpoint/layout.py``, depends on this order).  A filesystem that
    cannot fsync a directory fd makes this a no-op."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_local_write(fname: str, mode: str = "wb"):
    """Crash-safe publish of a local file (a path or a ``file://`` URI):
    write a temp name in the same directory, flush + fsync, then
    ``os.replace`` onto the name.  The published name is either absent
    or complete, never truncated."""
    if not is_local_path(fname):
        raise MXNetError("atomic_local_write needs a local path, got %r "
                         "(the %r protocol has no handler in this build)"
                         % (fname, fname.split("://", 1)[0]))
    fname = local_path(fname)
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
