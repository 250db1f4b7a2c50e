"""MoE instrumentation (counterpart of ``mxnet_tpu/moe/stats.py``):
per-expert hit counters and drop/imbalance rates.

One MoeStats per MoE consumer (a FusedTrainStep whose graph contains
``_moe_dispatch`` nodes, a DecodeEngine sampling its per-slot routing
state), registered weakly with ``mx.profiler`` like every other
subsystem — ``mx.profiler.moe_report()`` shows, per block, where the
routed traffic actually lands: expert hit histogram, the max/mean
imbalance the bench gates as ``moe_expert_imbalance``, and the dropped
fraction the capacity factor is buying."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..base import make_lock

__all__ = ["MoeStats"]


class MoeStats:
    """Counters for one MoE consumer; host-side and cheap (an (E,)
    float vector per sample against a multi-ms step)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("moe.stats")
        self._blocks: Dict[str, dict] = {}
        self._order: List[str] = []

    def _blk(self, block: str, num_experts: int) -> dict:
        d = self._blocks.get(block)
        if d is None:
            d = self._blocks[block] = {
                "num_experts": int(num_experts), "steps": 0,
                "routed": 0.0, "dropped": 0.0,
                "hits": np.zeros(int(num_experts), dtype=np.float64)}
            self._order.append(block)
        return d

    # -- recording ---------------------------------------------------------
    def note_counts(self, block: str, counts, dropped: float = 0.0) -> None:
        """Record one step's per-expert accepted-token counts (an (E,)
        host vector — the routing plan's ``counts`` or a decode slot
        state sum) plus how many token-choice pairs folded to the
        sentinel."""
        vec = np.asarray(counts, dtype=np.float64).reshape(-1)
        with self._lock:
            d = self._blk(block, vec.size)
            if vec.size == d["hits"].size:
                d["hits"] += vec
            d["steps"] += 1
            d["routed"] += float(vec.sum())
            d["dropped"] += float(dropped)

    def set_hits(self, block: str, hits) -> None:
        """Overwrite a block's cumulative hit histogram (the decode
        engine samples a cumulative per-slot state, not a delta)."""
        vec = np.asarray(hits, dtype=np.float64).reshape(-1)
        with self._lock:
            d = self._blk(block, vec.size)
            if vec.size == d["hits"].size:
                d["hits"] = vec
            d["steps"] += 1
            d["routed"] = float(vec.sum())

    # -- reporting ---------------------------------------------------------
    def imbalance(self, block: str = None) -> float:
        """max/mean expert hits (>= 1.0; 1.0 = perfectly balanced).
        Worst block when ``block`` is None; 1.0 with no traffic."""
        with self._lock:
            blocks = [self._blocks[block]] if block else \
                list(self._blocks.values())
            worst = 1.0
            for d in blocks:
                mean = d["hits"].mean() if d["hits"].size else 0.0
                if mean > 0:
                    worst = max(worst, float(d["hits"].max() / mean))
        return worst

    def report(self) -> dict:
        with self._lock:
            blocks = {}
            for b in self._order:
                d = self._blocks[b]
                mean = d["hits"].mean() if d["hits"].size else 0.0
                blocks[b] = {
                    "num_experts": d["num_experts"],
                    "steps": int(d["steps"]),
                    "routed": float(d["routed"]),
                    "dropped": float(d["dropped"]),
                    "drop_frac": (d["dropped"] / (d["dropped"] + d["routed"])
                                  if (d["dropped"] + d["routed"]) else 0.0),
                    "imbalance": (float(d["hits"].max() / mean)
                                  if mean > 0 else 1.0),
                    "hits": [float(x) for x in d["hits"]],
                }
        return {"name": self.name, "blocks": blocks}

    def report_str(self) -> str:
        rep = self.report()
        lines = ["moe %r:" % rep["name"]]
        fmt = "  %-24s %3s %7s %11s %9s %9s %9s"
        lines.append(fmt % ("block", "E", "steps", "routed",
                            "dropped", "drop%", "imbal"))
        for b, d in rep["blocks"].items():
            lines.append(fmt % (
                b, d["num_experts"], d["steps"], int(d["routed"]),
                int(d["dropped"]), "%.2f%%" % (100.0 * d["drop_frac"]),
                "%.2fx" % d["imbalance"]))
        if not rep["blocks"]:
            lines.append("  (no routing recorded)")
        return "\n".join(lines)
