"""Runtime lock-order recorder: a mini lock-order sanitizer for the
serve/feed/checkpoint/compile_cache thread soup.

The counterpart of ``mxnet_tpu/analysis/lockcheck.py``, stdlib only.
Every lock in ``mxnet_tpu_torch`` is created through
``base.make_lock(name)``
/ ``make_rlock`` / ``make_condition``.  With ``MXNET_LOCK_CHECK=1``
those return instrumented wrappers that record, per process, the
acquired-while-holding graph over lock NAMES (name classes, not
instances — two ``serve.swap`` locks in two engines are one node).  A
cycle in that graph is a potential deadlock even if this run never
interleaved into it: thread 1 taking A then B while thread 2 takes B
then A deadlocks only under the wrong schedule, which is exactly why
four hardening rounds on the serve engine (CHANGES PR 4) kept finding
new ones by hand.  The recorder finds them on ANY schedule that merely
exercises both orders.

With the knob off (the default outside tests), the factories return
plain ``threading`` primitives — zero overhead.

Each newly observed edge emits a ``lockcheck:edge`` instant into
``mxnet_tpu_torch.trace`` (bounded: edges are recorded once per name pair);
a detected cycle emits ``lockcheck:cycle`` and is kept in
:func:`cycles` for the tier-1 pytest plugin to fail the module.
"""
from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["enabled", "make_lock", "make_rlock", "make_condition",
           "cycles", "edges", "reset", "scoped", "lock_order_report",
           "CheckedLock", "CheckedRLock", "CheckedCondition"]


def _env_enabled() -> bool:
    from ..base import get_env
    return bool(get_env("MXNET_LOCK_CHECK", False, bool))


_enabled: Optional[bool] = None


def enabled() -> bool:
    """Whether new locks are instrumented (MXNET_LOCK_CHECK, read once
    at first lock creation — module-level locks are made at import, so
    set the knob before importing mxnet_tpu_torch)."""
    global _enabled
    if _enabled is None:
        _enabled = _env_enabled()
    return _enabled


def set_enabled(on: bool) -> None:
    """Test hook: affects locks created AFTER the call."""
    global _enabled
    _enabled = bool(on)


class _Graph:
    """Acquired-while-holding graph over lock names, with cycle
    detection on every new edge."""

    def __init__(self):
        self._mu = threading.Lock()      # the recorder's own, unnamed
        self._adj: Dict[str, Set[str]] = {}
        self._edges: Dict[Tuple[str, str], str] = {}
        self._cycles: List[Dict] = []

    def note_edge(self, held: str, name: str) -> None:
        with self._mu:
            if (held, name) in self._edges:
                return
            where = "".join(traceback.format_stack(limit=8)[:-2])
            self._edges[(held, name)] = where
            self._adj.setdefault(held, set()).add(name)
            cycle = self._find_cycle(name, held)
            if cycle is not None:
                self._cycles.append({
                    "cycle": cycle,
                    "edge": (held, name),
                    "stack": where,
                })
        # trace emission outside the graph lock; deferred import keeps
        # this module import-light for tools/lint.py.  The recorder's own
        # lock is a make_lock too, so emitting here can re-enter this
        # function (instant -> spill flush -> CheckedLock.acquire ->
        # note_edge); the tls guard drops the nested emission — without
        # it the nested spill flush deadlocks on the recorder's
        # non-reentrant inner lock.  The edge/cycle itself is already
        # recorded above, only the trace instant is skipped.
        if getattr(_tls, "in_emit", False):
            return
        _tls.in_emit = True
        try:
            from .. import trace
            trace.instant("lockcheck:edge", cat="lockcheck",
                          held=held, acquired=name)
            if cycle is not None:
                trace.instant("lockcheck:cycle", cat="lockcheck",
                              cycle="->".join(cycle))
        finally:
            _tls.in_emit = False

    def _find_cycle(self, src: str, dst: str) -> Optional[List[str]]:
        """Path src -> dst in the edge graph closes the (dst -> src)
        edge just added into a cycle."""
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path + [src]
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._adj.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def snapshot(self):
        with self._mu:
            return dict(self._edges), list(self._cycles)


_graph = _Graph()
_tls = threading.local()


def _stack() -> List[Tuple[int, str]]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _note_acquired(obj, name: str) -> None:
    st = _stack()
    oid = id(obj)
    if not any(e[0] == oid for e in st):       # reentrant RLock: no edges
        for held_name in {n for i, n in st if n != name}:
            _graph.note_edge(held_name, name)
    st.append((oid, name))


def _note_released(obj) -> None:
    st = _stack()
    oid = id(obj)
    for i in range(len(st) - 1, -1, -1):       # out-of-order release ok
        if st[i][0] == oid:
            del st[i]
            return


def _note_released_all(obj) -> int:
    """Drop every model entry for ``obj`` (Condition.wait on an RLock
    releases ALL recursion levels at once); returns how many were held
    so the restore side can re-note them."""
    st = _stack()
    oid = id(obj)
    n = len(st)
    st[:] = [e for e in st if e[0] != oid]
    return n - len(st)


class CheckedLock:
    """threading.Lock with acquisition-order recording."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        self._inner = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _note_acquired(self, self.name)
        return ok

    def release(self):
        _note_released(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # --- threading.Condition(lock) protocol -------------------------------
    # Condition binds these at construction when the lock provides them;
    # without them its fallbacks probe ownership with acquire(False),
    # which a REENTRANT RLock happily grants to its own holder —
    # "cannot wait on un-acquired lock" from a thread that does hold it.

    def _release_save(self):
        count = _note_released_all(self)
        inner = getattr(self._inner, "_release_save", None)
        if inner is not None:
            return (inner(), count)
        self._inner.release()
        return (None, count)

    def _acquire_restore(self, state):
        inner_state, count = state
        restore = getattr(self._inner, "_acquire_restore", None)
        if restore is not None:
            restore(inner_state)
        else:
            self._inner.acquire()
        for _ in range(count):
            _note_acquired(self, self.name)

    def _is_owned(self):
        owned = getattr(self._inner, "_is_owned", None)
        if owned is not None:
            return owned()
        # plain Lock: owned iff the model says this thread holds it
        return any(e[0] == id(self) for e in _stack())

    def __repr__(self):
        return "<%s %r %r>" % (type(self).__name__, self.name, self._inner)


class CheckedRLock(CheckedLock):
    _factory = staticmethod(threading.RLock)

    def locked(self):  # RLock has no locked() before 3.12
        m = getattr(self._inner, "locked", None)
        return m() if m is not None else None


class CheckedCondition:
    """threading.Condition with order recording; ``wait`` drops the
    lock from the held stack for its duration (the real lock is
    released — holding it in the model would fabricate edges)."""

    def __init__(self, name: str):
        self.name = name
        self._inner = threading.Condition()

    def acquire(self, *args):
        ok = self._inner.acquire(*args)
        if ok:
            _note_acquired(self, self.name)
        return ok

    def release(self):
        _note_released(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        _note_released(self)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_acquired(self, self.name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _note_released(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _note_acquired(self, self.name)

    def notify(self, n: int = 1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


def make_lock(name: str):
    return CheckedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    return CheckedRLock(name) if enabled() else threading.RLock()


def make_condition(name: str):
    return CheckedCondition(name) if enabled() else threading.Condition()


def cycles() -> List[Dict]:
    """All lock-order cycles observed so far in this process."""
    return _graph.snapshot()[1]


def edges() -> Dict[Tuple[str, str], str]:
    return _graph.snapshot()[0]


def reset() -> None:
    """Drop the recorded graph (not the held-stack: locks actually held
    by live threads stay held)."""
    global _graph
    _graph = _Graph()


class scoped:
    """Context manager giving a FRESH graph for a synthetic test, then
    restoring the process graph — an inversion test must not poison the
    tier-1 zero-cycles check."""

    def __enter__(self):
        global _graph
        self._saved = _graph
        _graph = _Graph()
        return _graph

    def __exit__(self, *exc):
        global _graph
        _graph = self._saved
        return False


def lock_order_report() -> Dict:
    edges_, cycles_ = _graph.snapshot()
    return {
        "enabled": bool(_enabled),
        "edges": sorted("%s->%s" % e for e in edges_),
        "cycles": [c["cycle"] for c in cycles_],
    }
