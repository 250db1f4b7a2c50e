"""The compile cache and ``cached_program`` (counterpart of
``mxnet_tpu/compile_cache/cached.py``).

Two kinds of build cost a process start pays, and the cache treats them
apart:

* **Kernel libraries persist across processes.**  With
  ``MXNET_COMPILE_CACHE=<dir>`` (size bound ``MXNET_COMPILE_CACHE_SIZE_MB``,
  default 2048) ``ops.cuda_kernels.build`` publishes each ``nvcc`` output
  into the store under the library's digest and the environment
  fingerprint, and loads it from there in a later process: a warm start
  runs ``nvcc`` zero times.  A truncated or bit-flipped blob, or corrupt
  meta, warns once, is dropped and is built again by ``nvcc``; no path
  falls back to a kernel's plain version.  Without the variable the
  libraries go to ``mxnet_tpu_torch/_build`` as before.

* **In-process programs stay in the process.**  A CUDA graph holds the
  addresses of this process's tensors, and an executor's program is an
  eager walk over Python objects: neither has a serialized form.
  ``cached_program`` still counts, times and reports them (builds, the
  steady-state rebuild counter) and lets callers build them ahead
  (``warm``, ``compile_for``); with a cache configured each build is
  recorded as a bypass with :data:`IN_PROCESS_REASON`, which
  ``compile_report()`` shows, as the reference's ``bypass_reason`` does
  for what it cannot store.  A program's ``fast_key`` is the
  description of what built it (the reference's trace-free key);
  ``compile_report()`` counts the distinct ones built under a name
  (``variants``).

The trace spans are the reference's three (cat ``compile``, attribute
``program``): ``compile:deserialize`` is a library's load from the
store, ``compile:backend_compile`` an ``nvcc`` build
(``ops/cuda_kernels.py``), and ``compile:trace_lower`` the build of an
in-process program (a graph capture with its warm-up, or an eager
program's first run).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from .. import trace as _trace
from ..base import get_env, make_lock
from .fingerprint import environment_fingerprint, program_key
from .stats import get_stats
from .store import CacheStore, warn_once

__all__ = ["CachedFunction", "CompileCache", "cached_program", "get_cache",
           "configure", "reset", "IN_PROCESS_REASON"]

DEFAULT_SIZE_MB = 2048.0

IN_PROCESS_REASON = ("in-process: CUDA graphs and eager walks hold this "
                     "process's tensors and have no serialized form")


class CompileCache:
    """Persistent library store over one directory (see the module
    docstring).  Thread-safe; one per process via :func:`get_cache`."""

    def __init__(self, directory: str, size_mb: Optional[float] = None):
        if size_mb is None:
            size_mb = get_env("MXNET_COMPILE_CACHE_SIZE_MB",
                              DEFAULT_SIZE_MB, float)
        self.store = CacheStore(directory, size_mb)

    # -- kernel libraries ---------------------------------------------------
    def library_key(self, digest: str) -> str:
        """The store key of a library: its digest (compile line, source,
        headers) under the environment fingerprint."""
        return program_key(digest, extras=("library",),
                           env_fp=environment_fingerprint())

    def load_library(self, name: str, key: str) -> Optional[str]:
        """-> the path of a verified stored library, or None (a miss; a
        malformed entry warns once and is dropped by the store)."""
        t0 = time.perf_counter()
        res = self.store.load(key)
        stats = get_stats()
        if res is None:
            stats.note_miss("kernel:" + name)
            return None
        dt = time.perf_counter() - t0
        stats.note_hit("kernel:" + name, dt)
        _trace.complete("compile:deserialize", t0, dt, cat="compile",
                        program="kernel:" + name)
        return self.store.blob_path(key)

    def load_fast(self, fkey: str, name: str) -> Optional[str]:
        """Index lookup: fast key -> entry key -> the stored library's
        path.  A dangling index (its entry evicted or corrupt) is
        dropped and reads as a miss; the caller's digest-keyed lookup
        then takes over and heals it (``store.save_index``)."""
        key = self.store.load_index(fkey)
        if key is None:
            return None
        path = self.load_library(name, key)
        if path is None:
            self.store.drop_index(fkey)
        return path

    def store_library(self, name: str, key: str, path: str) -> int:
        """Publish a freshly built library; -> bytes written (0 when the
        store could not take it)."""
        with open(path, "rb") as f:
            blob = f.read()
        nbytes = self.store.save(key, blob, {"name": name, "kind": "library",
                                             "env": environment_fingerprint()})
        get_stats().note_store("kernel:" + name, nbytes)
        return nbytes

    def drop(self, key: str) -> None:
        self.store.invalidate(key)

    def describe(self) -> dict:
        return {"directory": self.store.directory,
                "entries": self.store.entry_count(),
                "disk_bytes": self.store.disk_bytes(),
                "size_mb": self.store.size_bytes / 2 ** 20,
                "persists": "kernel libraries",
                "in_process": IN_PROCESS_REASON}


# -- process-wide cache handle ------------------------------------------------

_cache: Optional[CompileCache] = None
_cache_resolved = False
_cache_lock = make_lock("compile_cache.configure")


def get_cache() -> Optional[CompileCache]:
    """The active cache, or None (``MXNET_COMPILE_CACHE`` names the
    directory; empty or unset: off)."""
    global _cache, _cache_resolved
    if _cache_resolved:
        return _cache
    with _cache_lock:
        if _cache_resolved:
            return _cache
        d = (get_env("MXNET_COMPILE_CACHE") or "").strip()
        cache = None
        if d:
            try:
                cache = CompileCache(d)
            except Exception as e:
                warn_once("cache-init",
                          "MXNET_COMPILE_CACHE=%r unusable (%s: %s); "
                          "running uncached" % (d, type(e).__name__, e))
        _cache = cache
        _cache_resolved = True
    return _cache


def configure(directory: Optional[str],
              size_mb: Optional[float] = None) -> Optional[CompileCache]:
    """Set the cache up in code (None turns it off).  Recomputes the
    environment fingerprint."""
    global _cache, _cache_resolved
    with _cache_lock:
        environment_fingerprint(refresh=True)
        _cache = CompileCache(directory, size_mb) if directory else None
        _cache_resolved = True
    return _cache


def reset() -> None:
    """Forget the configured cache (the next get_cache() reads the
    environment again)."""
    global _cache, _cache_resolved
    with _cache_lock:
        _cache = None
        _cache_resolved = False
        environment_fingerprint(refresh=True)


# -- in-process programs ------------------------------------------------------

def _sig_leaf(x) -> Any:
    import torch
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, (torch.dtype, torch.device)):
        return str(x)
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    return (type(x).__name__,)


def _signature(args) -> Tuple:
    """A hashable description of the arguments' structure, shapes, dtypes
    and devices (and the values of plain scalars and strings)."""
    def walk(x):
        if isinstance(x, dict):
            return ("D",) + tuple((k, walk(v)) for k, v in sorted(
                x.items(), key=lambda kv: str(kv[0])))
        if isinstance(x, (list, tuple)):
            return ("L",) + tuple(walk(v) for v in x)
        return _sig_leaf(x)
    return walk(tuple(args))


class CachedFunction:
    """A program built once per input signature and then run.

    ``build(*args)`` makes the program for the arguments' signature (the
    expensive part: a capture, a warm walk) and returns a callable that
    runs it; ``__call__(*args)`` runs the signature's program, building
    it first when it is new.  ``warm`` builds without running;
    ``compile_for`` returns the program.  A build for a new signature of
    a program object that had already built one counts as a steady-state
    rebuild in ``compile_report()``."""

    def __init__(self, build: Callable, name: Optional[str] = None,
                 fast_key: Optional[str] = None):
        self._build = build
        self.name = name or getattr(build, "__name__", "<fn>")
        # the description of what built the program (the symbol graph,
        # dtypes, the optimizer's values, remat, ...): its identity
        self.fast_key = fast_key
        self._entries: Dict[Tuple, Any] = {}
        self._called = False
        self._lock = make_lock("compile_cache.cached_fn")

    @property
    def has_compiled(self) -> bool:
        """Whether any program exists yet (built, warmed, or run)."""
        return self._called or bool(self._entries)

    def mark_called(self) -> None:
        """Record a first use that needed no build (an eager program's
        first run is its own warm-up)."""
        self._called = True

    def first_run(self, thunk: Callable[[], Any]) -> Any:
        """``thunk()``, an eager program's run.  Its first run is its
        build, timed and counted as one; later runs only run."""
        if self.has_compiled:
            return thunk()
        t0 = time.perf_counter()
        out = thunk()
        dt = time.perf_counter() - t0
        stats = get_stats()
        stats.note_build(self.name, dt, desc=self.fast_key)
        _trace.complete("compile:trace_lower", t0, dt, cat="compile",
                        program=self.name)
        if get_cache() is not None:
            stats.note_bypass(self.name, IN_PROCESS_REASON)
        self._called = True
        return out

    def __call__(self, *args):
        entry = self.compile_for(*args)
        self._called = True
        return entry(*args)

    def warm(self, *args) -> str:
        """Build the program for these arguments without running it;
        -> ``"present"`` or ``"compiled"``."""
        if _signature(args) in self._entries:
            return "present"
        self.compile_for(*args)
        return "compiled"

    def compile_for(self, *args):
        """The program for these arguments, built if needed."""
        sig = _signature(args)
        entry = self._entries.get(sig)
        if entry is not None:
            return entry
        with self._lock:
            entry = self._entries.get(sig)
            if entry is not None:
                return entry
            rebuild = self.has_compiled
            t0 = time.perf_counter()
            entry = self._build(*args)
            dt = time.perf_counter() - t0
            stats = get_stats()
            stats.note_build(self.name, dt, rebuild=rebuild,
                             desc=self.fast_key)
            _trace.complete("compile:trace_lower", t0, dt, cat="compile",
                            program=self.name, retrace=rebuild)
            if get_cache() is not None:
                stats.note_bypass(self.name, IN_PROCESS_REASON)
            self._entries[sig] = entry
            return entry

    def reset(self) -> None:
        """Forget every program: what is built next is a new program,
        not a rebuild (the state it captured was replaced)."""
        with self._lock:
            self._entries.clear()
            self._called = False


def cached_program(fn: Callable, name: Optional[str] = None,
                   fast_key: Optional[str] = None) -> CachedFunction:
    """``fn`` (a builder: arguments -> runnable program) through the
    build accounting of :class:`CachedFunction`."""
    return CachedFunction(fn, name=name, fast_key=fast_key)
