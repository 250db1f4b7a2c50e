"""Embedding instrumentation (counterpart of ``mxnet_tpu/embed/stats.py``):
dedup ratios and lookup/update counters.

One EmbedStats per embedding consumer (a FusedTrainStep with sparse
tables, an EmbeddingTable serving lookups, a device_embed kvstore),
registered weakly with ``mx.profiler`` like every other subsystem —
``mx.profiler.embed_report()`` shows, per table, how much the dedup
actually buys on the live id distribution (the number the bench's
``embed_dedup_ratio`` leg publishes)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..base import make_lock

__all__ = ["EmbedStats"]


class EmbedStats:
    """Counters for one embedding consumer; host-side and cheap (the id
    batches are small int arrays — a ``np.unique`` per sample costs
    microseconds against a multi-ms step)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("embed.stats")
        self._tables: Dict[str, Dict[str, float]] = {}
        self._order = []

    def _tab(self, table: str) -> Dict[str, float]:
        d = self._tables.get(table)
        if d is None:
            d = self._tables[table] = {
                "lookups": 0, "ids": 0, "unique_ids": 0,
                "updates": 0, "update_rows": 0}
            self._order.append(table)
        return d

    # -- recording ---------------------------------------------------------
    def note_ids(self, table: str, ids, n_uniq: int = None) -> None:
        """Record one lookup batch's dedup potential (host ids).
        ``n_uniq`` lets a caller that already counted the batch's
        distinct values (EmbeddingTable's cap guard) skip the second
        ``np.unique`` scan."""
        arr = np.asarray(ids).reshape(-1)
        if n_uniq is None:
            n_uniq = int(np.unique(arr).size)
        with self._lock:
            d = self._tab(table)
            d["lookups"] += 1
            d["ids"] += int(arr.size)
            d["unique_ids"] += n_uniq

    def note_update(self, table: str, rows: int) -> None:
        """Record one sparse update (rows = the traced unique cap)."""
        with self._lock:
            d = self._tab(table)
            d["updates"] += 1
            d["update_rows"] += int(rows)

    # -- reporting ---------------------------------------------------------
    def dedup_ratio(self, table: str = None) -> float:
        """ids seen / unique ids seen (>= 1; 1.0 = no duplication).
        Aggregated over every table when ``table`` is None."""
        with self._lock:
            tabs = [self._tables[table]] if table else \
                list(self._tables.values())
            ids = sum(d["ids"] for d in tabs)
            uniq = sum(d["unique_ids"] for d in tabs)
        return (ids / uniq) if uniq else 1.0

    def report(self) -> dict:
        with self._lock:
            tables = {}
            for t in self._order:
                d = dict(self._tables[t])
                d["dedup_ratio"] = (d["ids"] / d["unique_ids"]) \
                    if d["unique_ids"] else 1.0
                tables[t] = d
        return {"name": self.name, "tables": tables}

    def report_str(self) -> str:
        rep = self.report()
        lines = ["embed %r:" % rep["name"]]
        fmt = "  %-24s %9s %11s %11s %7s %9s %11s"
        lines.append(fmt % ("table", "lookups", "ids", "unique",
                            "dedup", "updates", "rows"))
        for t, d in rep["tables"].items():
            lines.append(fmt % (
                t, int(d["lookups"]), int(d["ids"]), int(d["unique_ids"]),
                "%.2fx" % d["dedup_ratio"], int(d["updates"]),
                int(d["update_rows"])))
        if not rep["tables"]:
            lines.append("  (no lookups recorded)")
        return "\n".join(lines)
