"""Thread / child-process leak detection for the tier-1 suite.

The counterpart of ``mxnet_tpu/analysis/leakguard.py``, stdlib only.

A test module that leaves a live worker thread or a forked child behind
taxes every module after it: the stray dispatcher keeps batching, the
orphan reader keeps a shared-memory ring mapped, and a later test's
"no stray compiles / no stray processes" assertion fails somewhere far
from the culprit.  The pytest plugin (``analysis/pytest_plugin.py``)
snapshots live threads and children at module start and fails the
module if new ones survive teardown past a grace window.

The checks are pure stdlib (``threading.enumerate``,
``multiprocessing.active_children``, a ``/proc`` ppid scan for
``subprocess`` children) so they cost nothing to ship in the library:
long-running services can call :func:`snapshot` / :func:`check` around
a request flood as a self-test.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Set, Tuple

__all__ = ["enabled", "snapshot", "check", "IGNORED_THREAD_PREFIXES"]

# infrastructure threads that live for the process by design
IGNORED_THREAD_PREFIXES = (
    "pydevd",            # debugger
    "IPythonHistory",    # repl
    "resource_sharer",   # multiprocessing infra, process-lifetime
    "QueueFeederThread",  # multiprocessing.Queue feeder, joins lazily
)


def enabled() -> bool:
    from ..base import get_env
    return bool(get_env("MXNET_LEAK_CHECK", True, bool))


def _ignored(t: threading.Thread) -> bool:
    name = t.name or ""
    return name.startswith(IGNORED_THREAD_PREFIXES)


def _proc_children() -> Set[int]:
    """PIDs of direct children (Linux /proc scan; catches subprocess.Popen
    the multiprocessing registry doesn't know).  Zombies count: an
    unreaped child is a leak too."""
    me = os.getpid()
    kids: Set[int] = set()
    try:
        entries = os.listdir("/proc")
    except OSError:
        return kids
    for e in entries:
        if not e.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % e, "rb") as f:
                stat = f.read().decode("ascii", "replace")
            # pid (comm) state ppid ... — comm may contain spaces/parens,
            # parse from the LAST ')'
            rest = stat.rsplit(")", 1)[1].split()
            if int(rest[1]) == me:
                kids.add(int(e))
        except (OSError, IndexError, ValueError):
            continue
    return kids


def _mp_children() -> Set[int]:
    import multiprocessing
    # active_children() also reaps finished children as a side effect
    return {p.pid for p in multiprocessing.active_children()
            if p.pid is not None}


def snapshot() -> Dict:
    """Live threads + children right now."""
    return {
        "threads": {t for t in threading.enumerate() if t.is_alive()},
        "children": _mp_children() | _proc_children(),
    }


def check(before: Dict, grace_s: float = 5.0) -> List[str]:
    """Leaks relative to ``before``: threads/children that appeared
    since and are still alive after up to ``grace_s`` of polling (clean
    shutdown paths get time to join).  Returns human-readable leak
    descriptions; empty means clean."""
    deadline = time.monotonic() + max(0.0, grace_s)
    leaked_threads: List[threading.Thread] = []
    leaked_children: Set[int] = set()
    while True:
        now = snapshot()
        leaked_threads = [
            t for t in now["threads"]
            if t not in before["threads"] and t.is_alive()
            and t is not threading.current_thread() and not _ignored(t)]
        leaked_children = now["children"] - before["children"]
        if not leaked_threads and not leaked_children:
            return []
        if time.monotonic() >= deadline:
            break
        # give stragglers a real chance to exit
        for t in leaked_threads:
            t.join(timeout=0.05)
        time.sleep(0.05)
    out = []
    for t in sorted(leaked_threads, key=lambda t: t.name):
        out.append("leaked thread %r (daemon=%s, target=%s)"
                   % (t.name, t.daemon,
                      getattr(t, "_target", None)))
    for pid in sorted(leaked_children):
        out.append("leaked child process pid=%d (%s)"
                   % (pid, _cmdline(pid)))
    return out


def _cmdline(pid: int) -> str:
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as f:
            raw = f.read().replace(b"\0", b" ").strip()
        return raw.decode("utf-8", "replace")[:120] or "?"
    except OSError:
        return "gone-or-unreadable"
