"""Profiler registries (counterpart of ``mxnet_tpu/profiler.py``): for
now the serving one.

Every serving component registers its stats object here on
construction, weakly (a dropped engine disappears from the report with
no unregister call), so one :func:`serve_report` shows one row per live
component, each tagged by ``kind`` and carrying its own capacity shape:
``engine`` (ServeEngine: latency, queue, batch occupancy, pad waste,
bucket hits), ``decode`` (DecodeEngine: slot occupancy, steps, tokens),
``paged`` (PagedDecodeEngine: the decode row plus pool, spec decode and
inter-token latency), ``mux`` (ModelMultiplexer) and ``router``
(ServeRouter, with a rollup of its replicas).

The trace timeline, ``scope`` and the other report families wait for
ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import threading
import weakref

__all__ = ["register_serve_stats", "serve_report", "serve_report_str"]

# register() runs on constructing threads while readers iterate: every
# reader snapshot-copies under this lock first
_registry_lock = threading.Lock()


class _Registry:
    """name -> live stats objects, weakly held, creation-ordered."""

    def __init__(self, label: str, empty_str: str):
        self.label = label
        self.empty_str = empty_str
        self._items = weakref.WeakValueDictionary()
        self._seq = 0

    def register(self, obj) -> None:
        with _registry_lock:
            self._seq += 1
            # zero-padded seq: lexicographic order == creation order
            self._items["%s#%06d" % (obj.name, self._seq)] = obj

    def snapshot(self):
        """Strong-referenced (key, obj) list, safe to iterate while
        other threads register or drop."""
        with _registry_lock:
            return sorted(self._items.items())

    def __len__(self) -> int:
        with _registry_lock:
            return len(self._items)

    def report(self) -> dict:
        return {key: obj.report() for key, obj in self.snapshot()}

    def report_str(self) -> str:
        parts = [obj.report_str() for _, obj in self.snapshot()]
        return "\n\n".join(parts) if parts else self.empty_str


_serve_registry = _Registry("serve", "(no live serve engines)")


def register_serve_stats(serve_stats) -> None:
    """Called by ServeEngine / DecodeEngine / PagedDecodeEngine /
    ModelMultiplexer / ServeRouter on construction (any object with
    name/report/report_str rides along)."""
    _serve_registry.register(serve_stats)


def serve_report() -> dict:
    """{component key: counters} for every live serving component."""
    return _serve_registry.report()


def serve_report_str() -> str:
    """Human-readable per-component serving table."""
    return _serve_registry.report_str()
