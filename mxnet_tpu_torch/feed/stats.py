"""Per-stage instrumentation for the feed pipeline (counterpart of
``mxnet_tpu/feed/stats.py``).

Every stage carries one :class:`StageStats`: items/sec through the stage,
time spent doing work (``busy_s``), time stalled waiting for input
(``stall_in_s`` — the stage is STARVED by its producer) and time stalled
pushing output (``stall_out_s`` — the stage is BLOCKED by its consumer),
plus the live depth of the queue it feeds.  A single
:func:`mxnet_tpu_torch.profiler.feed_report` call renders every registered
pipeline, so one look shows exactly which stage starves the card:

* the bottleneck stage has high ``busy_s`` and low ``stall_*``;
* everything upstream of it shows ``stall_out_s`` (blocked pushing);
* everything downstream shows ``stall_in_s`` (starved waiting).

Counters are written under a lock from the owning stage's threads and
snapshotted atomically, so a report taken mid-flight is consistent.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..base import make_lock

__all__ = ["StageStats", "PipelineStats"]


class StageStats:
    """Throughput / stall / queue-depth counters for one pipeline stage."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("feed.stats")
        self._items = 0
        self._busy_s = 0.0
        self._stall_in_s = 0.0
        self._stall_out_s = 0.0
        self._bytes = 0
        self._started = time.perf_counter()
        # live depth of the queue this stage FEEDS (None until wired)
        self._depth_fn: Optional[Callable[[], int]] = None
        self._capacity = 0
        # external per-process counters (ParallelReader worker shm):
        # merged into every snapshot so feed_report() aggregates the
        # whole process tree, not just the parent
        self._external_fn: Optional[Callable[[], Dict]] = None

    # -- recording (called from stage threads) ---------------------------
    def add_items(self, n: int, busy_s: float = 0.0) -> None:
        with self._lock:
            self._items += n
            self._busy_s += busy_s

    def add_bytes(self, n: int) -> None:
        """Bytes this stage moved from the host to a device."""
        with self._lock:
            self._bytes += int(n)

    def add_stall_in(self, seconds: float) -> None:
        with self._lock:
            self._stall_in_s += seconds

    def add_stall_out(self, seconds: float) -> None:
        with self._lock:
            self._stall_out_s += seconds

    def wire_queue(self, depth_fn: Callable[[], int], capacity: int) -> None:
        self._depth_fn = depth_fn
        self._capacity = capacity

    def wire_external(self, fn: Callable[[], Dict]) -> None:
        """Attach per-worker-PROCESS counters (``{worker: {items, busy_s,
        restarts, ...}}``, read out of shared memory): a multi-process
        stage's decode work happens outside this process, and a report
        showing only the parent's counters would silently claim the
        workers did nothing."""
        self._external_fn = fn

    # -- reading ---------------------------------------------------------
    @property
    def items(self) -> int:
        with self._lock:
            return self._items

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            items = self._items
            busy = self._busy_s
            stall_in = self._stall_in_s
            stall_out = self._stall_out_s
            nbytes = self._bytes
        wall = max(time.perf_counter() - self._started, 1e-9)
        out = {
            "items": items,
            "items_per_s": round(items / wall, 2),
            "busy_s": round(busy, 4),
            "stall_in_s": round(stall_in, 4),
            "stall_out_s": round(stall_out, 4),
            "wall_s": round(wall, 4),
        }
        if nbytes:
            out["bytes"] = nbytes
        if self._depth_fn is not None:
            out["queue_depth"] = self._depth_fn()
            out["queue_capacity"] = self._capacity
        if self._external_fn is not None:
            try:
                workers = self._external_fn()
            except Exception:
                workers = None
            if workers:
                out["workers"] = workers
                out["worker_items"] = sum(
                    int(w.get("items", 0)) for w in workers.values())
                out["worker_busy_s"] = round(sum(
                    float(w.get("busy_s", 0.0)) for w in workers.values()),
                    4)
                out["restarts"] = sum(
                    int(w.get("restarts", 0)) for w in workers.values())
        return out


class PipelineStats:
    """All stages of one pipeline; registers with mx.profiler on creation
    so ``profiler.feed_report()`` sees every live pipeline."""

    def __init__(self, name: str):
        self.name = name
        self.stages: List[StageStats] = []

    def stage(self, name: str) -> StageStats:
        s = StageStats(name)
        self.stages.append(s)
        return s

    def register(self) -> "PipelineStats":
        from .. import profiler
        profiler.register_feed_stats(self)
        return self

    def report(self) -> Dict[str, Dict[str, float]]:
        """{stage name: counters}, in pipeline order."""
        return {s.name: s.snapshot() for s in self.stages}

    def bottleneck(self) -> Optional[str]:
        """Name of the stage with the largest busy share — where extra
        workers (or a faster device) would buy the most throughput."""
        if not self.stages:
            return None
        return max(self.stages, key=lambda s: s.snapshot()["busy_s"]).name

    def report_str(self) -> str:
        lines = ["feed pipeline %r" % self.name,
                 "  %-16s %10s %10s %8s %10s %10s %7s" %
                 ("stage", "items", "items/s", "busy_s",
                  "stall_in", "stall_out", "depth")]
        for s in self.stages:
            snap = s.snapshot()
            depth = ("%d/%d" % (snap["queue_depth"], snap["queue_capacity"])
                     if "queue_depth" in snap else "-")
            lines.append("  %-16s %10d %10.1f %8.2f %10.2f %10.2f %7s" % (
                s.name, snap["items"], snap["items_per_s"], snap["busy_s"],
                snap["stall_in_s"], snap["stall_out_s"], depth))
            for wname, wc in sorted((snap.get("workers") or {}).items()):
                lines.append(
                    "  %-16s %10d %10.1f %8.2f %10s %10s %7s" % (
                        "  %s[%s]" % (s.name, wname), wc.get("items", 0),
                        wc.get("items_per_s", 0.0), wc.get("busy_s", 0.0),
                        "-", "restarts=%d" % wc.get("restarts", 0),
                        "up" if wc.get("alive") else "down"))
        return "\n".join(lines)
