"""``mxnet_tpu_torch.trace``: always-on, low-overhead structured span
tracing (counterpart of ``mxnet_tpu/trace``, the same names, knobs and
event schema).

Every hot path (feed stages, the forked readers' decode loops, the fused
step's dispatch, superstep windows, checkpoint save and commit, the serve
request lifecycle, the kernels' builds and the graph captures) records
spans into per-thread ring buffers, and one
``mx.profiler.dump_trace(path)`` writes a Chrome/Perfetto timeline with
a lane per process and thread, including the spans of
``feed.ParallelReader``'s worker processes, which spill to per-worker
files the parent merges (surviving even a SIGKILL'd worker).

::

    with mx.trace.span("epoch", epoch=3):
        ... train ...
    mx.profiler.dump_trace("/tmp/step.trace.json")   # open in Perfetto

These spans are host time.  What the card ran, kernel by kernel, comes
from ``mx.profiler.profiler_set_state("run")``, which records PyTorch's
device timeline beside them.

Design points (see recorder.py): recording takes no lock on the hot path
(per-thread rings, GIL-atomic slot stores), is bounded (a full ring
drops its oldest events and counts them; dead threads' rings are pruned
past a cap), and monotonic (``perf_counter_ns``, the same
CLOCK_MONOTONIC timeline across forked processes).  ``MXNET_TRACE=0``
reduces ``complete``/``instant``/``async_*`` call sites to one predicate
check (a disabled ``span`` still costs its two clock reads).  A span
records nothing on the card: no synchronize, no device read.

Env knobs: ``MXNET_TRACE`` (default 1), ``MXNET_TRACE_BUF_EVENTS``
(ring capacity per thread, default 65536), ``MXNET_TRACE_JOURNAL`` /
``MXNET_TRACE_JOURNAL_EVERY`` (run-metrics JSONL, journal.py),
``MXNET_TRACE_SPILL_EVERY`` (worker flush cadence).
"""
from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

from ..base import make_lock as _make_lock
from .journal import (journal_every, journal_path, maybe_journal_step,
                      reset_journal, write_journal_line)
from .recorder import DEFAULT_BUF_EVENTS, Recorder

__all__ = ["span", "complete", "instant", "counter", "async_begin",
           "async_instant", "async_end", "next_async_id", "enabled",
           "set_enabled", "dump_trace", "add_spill_dir", "spill_dirs",
           "configure_spill", "flush_spill", "label_process",
           "event_count", "drop_count", "span_events", "instant_events",
           "trace_report",
           "reset", "maybe_journal_step", "write_journal_line",
           "journal_path", "journal_every", "reset_journal"]


def _env_enabled() -> bool:
    from ..base import get_env
    return bool(get_env("MXNET_TRACE", True, bool))


def _env_cap() -> int:
    from ..base import get_env
    return get_env("MXNET_TRACE_BUF_EVENTS", DEFAULT_BUF_EVENTS, int)


_enabled = _env_enabled()
_recorder = Recorder(_env_cap())
_spill_dirs: List[str] = []
_process_labels: Dict[int, str] = {}
_dirs_lock = _make_lock("trace.spill_dirs")
# registered spill dirs are bounded: a reader-per-job service must not
# make every dump re-read an ever-growing list of dead readers' files
MAX_SPILL_DIRS = 64
# async-span ids: process-unique; the pid salt keeps ids from forked
# workers from colliding with the parent's in a merged trace
_async_ids = itertools.count(1)


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Runtime switch (the env knob is read once at import)."""
    global _enabled
    _enabled = bool(on)


def reset(buf_events: Optional[int] = None) -> None:
    """Drop every recorded event and spill registration (test hook)."""
    global _recorder, _enabled
    _recorder = Recorder(buf_events if buf_events is not None
                         else _env_cap())
    with _dirs_lock:
        del _spill_dirs[:]
        _process_labels.clear()
    _enabled = _env_enabled()
    reset_journal()


# -- recording ------------------------------------------------------------
class _Span:
    """Context manager AND decorator for one named span."""

    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str, args):
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if _enabled:
            _recorder.add("X", self.name, self.cat, self._t0,
                          t1 - self._t0, None, self.args)
        return False

    def __call__(self, fn):
        name, cat, args = self.name, self.cat, self.args

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            if not _enabled:
                return fn(*a, **kw)
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                _recorder.add("X", name, cat, t0,
                              time.perf_counter_ns() - t0, None, args)
        return wrapped


def span(name: str, cat: str = "host", **attrs):
    """``with trace.span("decode", shard=0): ...`` — or use as a
    decorator: ``@trace.span("load")``.  The enabled check happens at
    record time, never at construction: a function decorated while
    ``MXNET_TRACE=0`` (or before ``set_enabled(True)``) still traces
    once tracing is switched on."""
    return _Span(name, cat, attrs or None)


def complete(name: str, start_s: float, dur_s: float, cat: str = "host",
             **attrs) -> None:
    """Record an already-measured interval (``start_s`` from
    ``time.perf_counter()`` — same CLOCK_MONOTONIC base as the ns
    clock), so call sites that already time their work pay no second
    pair of clock reads."""
    if not _enabled:
        return
    _recorder.add("X", name, cat, int(start_s * 1e9),
                  max(0, int(dur_s * 1e9)), None, attrs or None)


def instant(name: str, cat: str = "host", **attrs) -> None:
    if not _enabled:
        return
    _recorder.add("i", name, cat, time.perf_counter_ns(), 0, None,
                  attrs or None)


def counter(name: str, cat: str = "host", **values) -> None:
    """Record a Chrome counter sample (``ph: "C"``): each kwarg is one
    series, rendered by Perfetto as a stacked counter track.  The decode
    engine samples its slot occupancy here every step
    (``serve:decode_slots``), so the timeline shows batch fill as a
    graph alongside the step spans instead of one number in a report."""
    if not _enabled:
        return
    _recorder.add("C", name, cat, time.perf_counter_ns(), 0, None,
                  values or None)


def next_async_id() -> str:
    """Process-unique id for one async span chain (e.g. one serve
    request)."""
    return "%d.%d" % (os.getpid(), next(_async_ids))


def async_begin(name: str, async_id, cat: str = "async", **attrs) -> None:
    if not _enabled:
        return
    _recorder.add("b", name, cat, time.perf_counter_ns(), 0, async_id,
                  attrs or None)


def async_instant(name: str, async_id, cat: str = "async", **attrs) -> None:
    if not _enabled:
        return
    _recorder.add("n", name, cat, time.perf_counter_ns(), 0, async_id,
                  attrs or None)


def async_end(name: str, async_id, cat: str = "async", **attrs) -> None:
    if not _enabled:
        return
    _recorder.add("e", name, cat, time.perf_counter_ns(), 0, async_id,
                  attrs or None)


# -- cross-process spill ---------------------------------------------------
def configure_spill(path: str) -> None:
    """Worker-process side: append this process's events to ``path``."""
    _recorder.configure_spill(path)


def flush_spill() -> None:
    _recorder.flush_spill()


def add_spill_dir(directory: str) -> None:
    """Parent side: merge every ``*.jsonl`` under ``directory`` into
    future dumps (ParallelReader registers its per-worker span dir
    here).  Name the pid lanes with :func:`label_process`.  At most
    ``MAX_SPILL_DIRS`` stay registered — the oldest are unregistered
    (not deleted; their creator owns the files) so dump cost stays
    bounded in reader-per-job processes."""
    with _dirs_lock:
        if directory not in _spill_dirs:
            _spill_dirs.append(directory)
            del _spill_dirs[:-MAX_SPILL_DIRS]


def spill_dirs() -> List[str]:
    with _dirs_lock:
        return list(_spill_dirs)


def label_process(pid: int, label: str) -> None:
    """Name a pid's lane in the exported trace (e.g. ``feed-reader
    w0``)."""
    with _dirs_lock:
        _process_labels[pid] = label


# -- reading / export ------------------------------------------------------
def event_count() -> int:
    return _recorder.event_count()


def drop_count() -> int:
    return _recorder.drop_count()


def span_events(names=None, since_ns: Optional[int] = None,
                cat: Optional[str] = None) -> List[Dict]:
    """Matching complete-span event dicts from this process's rings
    (Chrome format: ``ts``/``dur`` in microseconds, perf_counter
    timeline).  ``names`` filters by span name, ``since_ns`` (a
    ``time.perf_counter_ns()`` watermark) keeps only spans that started
    at or after it.  This is how the autotuner reads candidate cost out
    of the same span timeline every hot path already records — the
    measurement the report shows IS the measurement the trace shows."""
    name_set = set(names) if names is not None else None
    out = []
    for e in _recorder.snapshot():
        if e.get("ph") != "X":
            continue
        if name_set is not None and e["name"] not in name_set:
            continue
        if cat is not None and e.get("cat") != cat:
            continue
        if since_ns is not None and e["ts"] * 1000.0 < since_ns:
            continue
        out.append(e)
    return out


def instant_events(names=None, cat: Optional[str] = None,
                   prefix: Optional[str] = None,
                   since_ns: Optional[int] = None) -> List[Dict]:
    """Matching instant-event dicts (``ph: "i"``) from this process's
    rings — the read side of :func:`instant`, same filters as
    :func:`span_events` plus a name ``prefix`` (the fault plane's
    injections are all ``fault:*`` instants; the chaos tests assert on
    exactly these)."""
    name_set = set(names) if names is not None else None
    out = []
    for e in _recorder.snapshot():
        if e.get("ph") != "i":
            continue
        if name_set is not None and e["name"] not in name_set:
            continue
        if prefix is not None and not e["name"].startswith(prefix):
            continue
        if cat is not None and e.get("cat") != cat:
            continue
        if since_ns is not None and e["ts"] * 1000.0 < since_ns:
            continue
        out.append(e)
    return out


def dump_trace(path: str) -> str:
    """Write the merged Chrome/Perfetto trace JSON to ``path`` (load it
    at chrome://tracing or https://ui.perfetto.dev); returns ``path``."""
    from .export import export_chrome
    with _dirs_lock:
        dirs = list(_spill_dirs)
        labels = dict(_process_labels)
    return export_chrome(path, _recorder, dirs, drops=drop_count(),
                         process_labels=labels)


def trace_report() -> Dict:
    """The trace runtime's own counters, for
    ``mx.profiler.unified_report()``."""
    return {"enabled": _enabled, "events": event_count(),
            "dropped": drop_count(), "buf_events": _recorder.buf_events,
            "spill_dirs": spill_dirs(),
            "journal": journal_path(), "journal_every": journal_every()}


# forked children inherit the parent's rings; their spans belong to a new
# pid and (for feed workers) a spill file — reset at fork
if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _recorder.reset_after_fork())
