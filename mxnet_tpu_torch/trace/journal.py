"""Run-metrics journal (counterpart of ``mxnet_tpu/trace/journal.py``;
the line keys and the rotated files' names are the same, so either
package's :func:`tail` reads the other's journal): one JSONL line every N steps for long-run
dashboards.

``MXNET_TRACE_JOURNAL=path`` turns it on; every time the training
loop's global step crosses a multiple of ``MXNET_TRACE_JOURNAL_EVERY``
(default 50), one line is appended::

    {"ts": <unix seconds>, "step": S,
     "reports": mx.profiler.unified_report(), ...extra}

The write path opens/appends/closes per line (a crash loses nothing
already written) and the whole feature costs one ``os.environ.get`` per
step when disabled.  ``Module.fit`` calls :func:`maybe_journal_step`
from its per-batch bookkeeping; any other loop can do the same.

Rotation: under sustained serve load the journal grows
without bound, so ``MXNET_TRACE_JOURNAL_MAX_BYTES`` (> 0 to enable)
rotates it size-based — when the file would exceed the cap, it shifts
to ``path.1`` (prior generations to ``.2`` … ``.KEEP``, oldest
dropped), keeping ``MXNET_TRACE_JOURNAL_KEEP`` rotated generations
(default 3).  Rotation happens BETWEEN whole-line writes, under the
module lock, and shifts by ``os.replace`` — no line is ever torn,
which the online promotion gate depends on (it tails the journal for
its decision context).  :func:`tail` reads the last N lines across the
live file and, when it is short, the newest rotated generation.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["journal_path", "journal_every", "maybe_journal_step",
           "write_journal_line", "reset_journal", "journal_max_bytes",
           "journal_keep", "journal_files", "tail"]

_last_step: Optional[int] = None
_rotate_lock = None


def _lock():
    # created lazily so importing trace.journal never pulls the lockcheck
    # machinery before the env is settled
    global _rotate_lock
    if _rotate_lock is None:
        from ..base import make_lock
        _rotate_lock = make_lock("trace.journal")
    return _rotate_lock


def journal_path() -> Optional[str]:
    from ..base import get_env
    return get_env("MXNET_TRACE_JOURNAL") or None


def journal_every() -> int:
    from ..base import get_env
    return max(1, get_env("MXNET_TRACE_JOURNAL_EVERY", 50, int))


def journal_max_bytes() -> int:
    """Size cap that triggers rotation (``MXNET_TRACE_JOURNAL_MAX_BYTES``,
    default 0 = rotation off)."""
    from ..base import get_env
    return max(0, get_env("MXNET_TRACE_JOURNAL_MAX_BYTES", 0, int))


def journal_keep() -> int:
    """Rotated generations retained (``MXNET_TRACE_JOURNAL_KEEP``,
    default 3, minimum 1)."""
    from ..base import get_env
    return max(1, get_env("MXNET_TRACE_JOURNAL_KEEP", 3, int))


def reset_journal() -> None:
    """Forget the last journaled step (test hook / new run)."""
    global _last_step
    _last_step = None


def maybe_journal_step(step: int, **extra) -> bool:
    """Journal when ``(last, step]`` crosses a multiple of the cadence —
    crossing, not ``%``, so K-step superstep jumps can't skip a line
    forever.  Returns True when a line was written."""
    global _last_step
    path = journal_path()
    if path is None:
        return False
    every = journal_every()
    prev = _last_step if _last_step is not None else step - 1
    if step // every <= prev // every:
        return False
    _last_step = step
    write_journal_line(path, step, **extra)
    return True


def journal_files(path: str):
    """Existing journal generations, newest first: ``[path, path.1,
    ..., path.K]`` filtered to the ones on disk."""
    out = []
    if os.path.exists(path):
        out.append(path)
    i = 1
    while True:
        rot = "%s.%d" % (path, i)
        if not os.path.exists(rot):
            break
        out.append(rot)
        i += 1
    return out


def _rotate_locked(path: str, incoming: int) -> None:
    """Shift generations when the live file + the incoming line would
    exceed the cap.  ``os.replace`` per shift: every generation is at
    all times either the complete old file or the complete new one —
    a reader (the gate's :func:`tail`) never sees a torn line."""
    cap = journal_max_bytes()
    if cap <= 0:
        return
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0 or size + incoming <= cap:
        return
    keep = journal_keep()
    try:
        oldest = "%s.%d" % (path, keep)
        if os.path.exists(oldest):
            os.unlink(oldest)
        for i in range(keep - 1, 0, -1):
            src = "%s.%d" % (path, i)
            if os.path.exists(src):
                os.replace(src, "%s.%d" % (path, i + 1))
        os.replace(path, path + ".1")
    except OSError:
        pass


def write_journal_line(path: str, step: int, **extra) -> None:
    """Append one snapshot line; a journal failure must never take the
    training loop down, so I/O errors are swallowed.

    Each line carries BOTH clocks: ``ts`` is wall time (absolute, for
    humans and cross-host joins) and ``mono`` is ``perf_counter`` — the
    monotonic timeline step DURATIONS must be computed on.  An NTP step
    between two lines shifts ``ts`` arbitrarily (the exact hazard
    callback.py's Speedometer documents); ``mono`` deltas survive it."""
    from .. import profiler
    # ts is the absolute stamp for humans; durations must be computed
    # on the mono field next to it
    line = {"ts": time.time(),
            "mono": time.perf_counter(), "step": int(step),
            "reports": profiler.unified_report()}
    line.update(extra)
    try:
        payload = json.dumps(line, default=str) + "\n"
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with _lock():
            _rotate_locked(path, len(payload))
            with open(path, "a") as f:
                f.write(payload)
    except (OSError, TypeError, ValueError):
        pass


def tail(path: str, n: int = 1):
    """Last ``n`` parsed journal lines (oldest first), reading back
    through rotated generations when the live file is short.  Unparsable
    or missing files yield fewer (possibly zero) lines, never an
    error — the callers are decision paths (the online promotion gate)
    that must degrade, not crash."""
    if not path or n <= 0:
        return []
    lines = []
    for gen in journal_files(path):          # newest first
        try:
            with open(gen) as f:
                raw = f.readlines()
        except OSError:
            continue
        parsed = []
        for s in raw:
            try:
                parsed.append(json.loads(s))
            except ValueError:
                pass
        lines = parsed + lines
        if len(lines) >= n:
            break
    return lines[-n:]
