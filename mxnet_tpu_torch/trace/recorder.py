"""The span recorder: lock-light per-thread ring buffers (counterpart of
``mxnet_tpu/trace/recorder.py``; events and spill files in the same
schema).

Every recording thread owns one :class:`_ThreadBuf` — a preallocated
fixed-size list used as a circular buffer.  Appending an event is a few
bytecodes (tuple build + slot store + index bump) with NO lock: the GIL
makes the single slot store atomic, and each thread only ever writes its
own buffer.  The only lock in the module guards buffer *creation* and
the spill file; the hot path never touches it.  A full ring overwrites
its oldest events and counts them as drops — recording can never block,
allocate unboundedly, or crash the traced program.

Timestamps are ``time.perf_counter_ns()`` (CLOCK_MONOTONIC on Linux),
which is system-wide: spans recorded in forked worker processes land on
the same timeline as the parent's, so a merged trace lines up without
clock translation.

Cross-process collection: a worker process calls
:meth:`Recorder.configure_spill` with a file path; from then on its
events are appended to that file as Chrome-trace JSON lines (flushed
every ``MXNET_TRACE_SPILL_EVERY`` events and at ``flush_spill``), so a
worker killed with SIGKILL loses at most one flush window of spans.  The
parent registers the spill *directory* with the exporter and the merged
dump shows every process under its real pid.  An ``os.register_at_fork``
hook resets the child's inherited buffers (they belong to the parent's
timeline) and re-reads the pid.  The recorder touches no CUDA, so a
forked reader (which must never create a CUDA context) records and
spills safely.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Dict, List, Optional

from ..base import make_lock as _make_lock

__all__ = ["Recorder", "DEFAULT_BUF_EVENTS"]

DEFAULT_BUF_EVENTS = 65536

# event tuples: (ph, name, cat, ts_ns, dur_ns, async_id, args)
#   ph "X" complete   (dur_ns set)
#   ph "i" instant
#   ph "b"/"n"/"e" async begin / instant / end (async_id set)


def _spill_every() -> int:
    from ..base import get_env
    return max(1, get_env("MXNET_TRACE_SPILL_EVERY", 64, int))


def _spill_max() -> int:
    """Per-process cap on spilled events (MXNET_TRACE_SPILL_MAX_EVENTS,
    default 200k ≈ 25MB of JSONL): the spill file must honor the same
    bounded-resources contract as the rings — a week-long reader run
    must not fill the disk with decode spans."""
    from ..base import get_env
    return max(1, get_env("MXNET_TRACE_SPILL_MAX_EVENTS", 200000, int))


# dead-thread rings kept for the dump (short-lived threads' spans are
# exactly what a timeline is for) — but only this many; beyond it the
# oldest dead rings are pruned so thread-per-request workloads cannot
# leak one ring per client thread forever
MAX_DEAD_BUFS = 64


class _ThreadBuf:
    """One thread's event ring.  Only its owner thread writes; readers
    snapshot-copy (a torn read can at worst see one freshly overwritten
    slot, which is a newer valid event)."""

    __slots__ = ("tid", "thread_name", "cap", "buf", "n", "spilled",
                 "owner")

    def __init__(self, tid: int, thread_name: str, cap: int, owner=None):
        self.tid = tid
        self.thread_name = thread_name
        self.cap = cap
        self.buf: List = [None] * cap
        self.n = 0          # events ever recorded
        self.spilled = 0    # events already written to the spill file
        # weakly track the owning thread: liveness decides prunability
        self.owner = weakref.ref(owner) if owner is not None else None

    def alive(self) -> bool:
        t = self.owner() if self.owner is not None else None
        return bool(t is not None and t.is_alive())

    def drops(self) -> int:
        """Events lost to ring overwrite (never spilled, never
        snapshot-able)."""
        return max(0, self.n - self.spilled - self.cap)

    def pending(self):
        """(start_index, [events]) still held in the ring, oldest
        first."""
        n = self.n
        start = max(self.spilled, n - self.cap)
        cap = self.cap
        return start, [self.buf[i % cap] for i in range(start, n)]


class Recorder:
    """Process-wide registry of per-thread rings + optional spill sink."""

    def __init__(self, buf_events: int = DEFAULT_BUF_EVENTS):
        self.buf_events = max(16, int(buf_events))
        self.pid = os.getpid()
        self._lock = _make_lock("trace.recorder")
        self._bufs: List[_ThreadBuf] = []
        self._tls = threading.local()
        self._spill_path: Optional[str] = None
        self._spill_every = _spill_every()
        self._spill_max = _spill_max()
        self._spill_total = 0
        self._pruned_drops = 0

    # -- recording (hot path) ---------------------------------------------
    def _buf(self) -> _ThreadBuf:
        b = getattr(self._tls, "buf", None)
        if b is None:
            t = threading.current_thread()
            b = _ThreadBuf(t.ident or 0, t.name, self.buf_events, owner=t)
            self._tls.buf = b
            with self._lock:
                self._bufs.append(b)
                dead = [x for x in self._bufs if not x.alive()]
                if len(dead) > MAX_DEAD_BUFS:
                    # prune oldest dead rings (registration order): their
                    # un-snapshot events count as drops, same contract as
                    # ring overwrite
                    for x in dead[:len(dead) - MAX_DEAD_BUFS]:
                        _, pend = x.pending()
                        self._pruned_drops += x.drops() + len(pend)
                        self._bufs.remove(x)
        return b

    def add(self, ph: str, name: str, cat: str, ts_ns: int, dur_ns: int,
            async_id, args) -> None:
        b = self._buf()
        i = b.n
        b.buf[i % b.cap] = (ph, name, cat, ts_ns, dur_ns, async_id, args)
        b.n = i + 1
        if self._spill_path is not None and \
                b.n - b.spilled >= self._spill_every:
            self._spill_flush(b)

    # -- spill (worker processes) -----------------------------------------
    def configure_spill(self, path: str) -> None:
        """Route this process's spans to ``path`` (JSON lines, Chrome
        event dicts) so a parent process can merge them into its dump
        even after this process dies."""
        with self._lock:
            self._spill_path = path
            self._spill_every = _spill_every()
            self._spill_max = _spill_max()
            self._spill_total = 0

    def _spill_flush(self, b: _ThreadBuf) -> None:
        # the WHOLE read-compute-write-advance sequence holds the lock:
        # the owner thread's cadence flush can race a flush_spill() from
        # another thread, and two flushes reading the same pending
        # window would write every span twice
        with self._lock:
            path = self._spill_path
            if path is None:
                return
            start, events = b.pending()
            if not events:
                return
            room = self._spill_max - self._spill_total
            truncating = len(events) > room
            if truncating:
                events = events[:max(0, room)]
            lines = []
            for ev in events:
                if ev is None:
                    continue
                lines.append(json.dumps(
                    chrome_event(ev, self.pid, b.tid),
                    separators=(",", ":"), default=str))
            if truncating:
                # the cap is the bounded-disk contract: stop spilling,
                # say so IN the file (the merged dump shows where it
                # stops and why), and let the ring's own overwrite
                # bound take over
                last_ts = events[-1][3] / 1000.0 if events else 0.0
                lines.append(json.dumps(
                    {"name": "trace:spill_truncated", "cat": "trace",
                     "ph": "i", "s": "p", "ts": last_ts, "pid": self.pid,
                     "tid": b.tid, "args": {"limit": self._spill_max}},
                    separators=(",", ":")))
            try:
                if lines:
                    with open(path, "a") as f:
                        f.write("\n".join(lines) + "\n")
                        f.flush()
            except OSError:
                # a vanished spill dir must not kill the traced worker
                self._spill_path = None
                return
            if truncating:
                self._spill_path = None
            self._spill_total += len(events)
            b.spilled += len(events)

    def flush_spill(self) -> None:
        """Flush every thread's un-spilled events (worker exit path)."""
        if self._spill_path is None:
            return
        with self._lock:
            bufs = list(self._bufs)
        for b in bufs:
            self._spill_flush(b)

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> List[Dict]:
        """Chrome-ready event dicts for every live ring (this process
        only; spill files are the other processes' halves)."""
        with self._lock:
            bufs = list(self._bufs)
        out = []
        for b in bufs:
            _, events = b.pending()
            for ev in events:
                if ev is not None:
                    out.append(chrome_event(ev, self.pid, b.tid))
        return out

    def thread_names(self) -> Dict[int, str]:
        with self._lock:
            return {b.tid: b.thread_name for b in self._bufs}

    def event_count(self) -> int:
        with self._lock:
            return sum(b.n for b in self._bufs)

    def drop_count(self) -> int:
        with self._lock:
            return self._pruned_drops + sum(b.drops() for b in self._bufs)

    # -- fork hygiene ------------------------------------------------------
    def reset_after_fork(self) -> None:
        """The child inherits the parent's rings and tls; its events must
        start fresh under its own pid (and never double-report the
        parent's)."""
        self.pid = os.getpid()
        self._lock = _make_lock("trace.recorder")
        self._bufs = []
        self._tls = threading.local()
        self._spill_path = None
        self._spill_total = 0
        self._pruned_drops = 0


def chrome_event(ev, pid: int, tid: int) -> Dict:
    """One recorder tuple -> one Chrome trace-event dict (ts/dur in
    microseconds, the format chrome://tracing and Perfetto load)."""
    ph, name, cat, ts_ns, dur_ns, async_id, args = ev
    d = {"name": name, "cat": cat, "ph": ph, "ts": ts_ns / 1000.0,
         "pid": pid, "tid": tid}
    if ph == "X":
        d["dur"] = dur_ns / 1000.0
    elif ph in ("b", "n", "e"):
        d["id"] = async_id
    elif ph == "i":
        d["s"] = "t"        # instant scope: thread
    if args:
        d["args"] = args
    return d


def now_ns() -> int:
    return time.perf_counter_ns()
