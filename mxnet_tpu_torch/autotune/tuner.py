"""The tuner core (counterpart of ``mxnet_tpu/autotune/tuner.py``):
deterministic selection over a measurement log, a store fast path, and
the run record.

Measurement is noisy, selection is not: :func:`select_best` is a pure
function of the log ``[(config, cost_s), ...]`` (minimum cost, ties by
log order), so a stored log replays to the stored winner.  An
:class:`Autotuner` run looks its key up in the store (a hit applies the
winner with zero measurements, ``source="cache"``), else measures every
candidate, selects and persists winner and log.  Each run keeps an
:class:`AutotuneStats`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, make_lock
from . import store as _store
from .measure import wall_timer

__all__ = ["Autotuner", "AutotuneStats", "select_best"]

Config = Dict[str, Any]
Log = List[Tuple[Config, float]]


def select_best(log: Log) -> Tuple[Config, float]:
    """The winning (config, cost_s) of a measurement log: minimum cost,
    ties broken by log order."""
    if not log:
        raise MXNetError("autotune: empty measurement log")
    best_i = 0
    for i, (_c, cost) in enumerate(log):
        if cost < log[best_i][1]:
            best_i = i
    return dict(log[best_i][0]), float(log[best_i][1])


class AutotuneStats:
    """One tuning run's record: key, source, per-candidate costs, winner,
    wall time, and how many gate, featurize and measure calls the run made
    (all 0 on a store hit)."""

    def __init__(self, name: str, key: str):
        self.name = name
        self.key = key
        self._lock = make_lock("autotune.stats")
        self.source = "pending"      # -> "measured" | "cache"
        self.trials: Log = []
        self.best: Optional[Config] = None
        self.best_cost_s: Optional[float] = None
        self.wall_s = 0.0
        self.store_path: Optional[str] = None
        self.calls = {"gate": 0, "featurize": 0, "measure": 0}

    def report(self) -> dict:
        with self._lock:
            return {
                "tuner": self.name,
                "key": self.key,
                "source": self.source,
                "trials": [[dict(c), s] for (c, s) in self.trials],
                "best": dict(self.best) if self.best else None,
                "best_cost_s": self.best_cost_s,
                "wall_s": round(self.wall_s, 4),
                "store_path": self.store_path,
                "calls": dict(self.calls),
            }

    def report_str(self) -> str:
        r = self.report()
        lines = ["%s: %s (key %s..., %.3fs)"
                 % (r["tuner"], r["source"], r["key"][:12], r["wall_s"])]
        for cfg, cost in r["trials"]:
            mark = " <== best" if cfg == r["best"] else ""
            lines.append("  %-40s %10.6fs%s"
                         % (_cfg_str(cfg), cost, mark))
        if r["source"] == "cache" and r["best"] is not None:
            lines.append("  %-40s %10s  (loaded from store)"
                         % (_cfg_str(r["best"]),
                            "%.6fs" % r["best_cost_s"]
                            if r["best_cost_s"] is not None else "-"))
        return "\n".join(lines)


def _cfg_str(cfg: Config) -> str:
    return ",".join("%s=%s" % (k, cfg[k]) for k in sorted(cfg))


def _record_cache_hit(stats: AutotuneStats, key: str, doc: dict,
                      elapsed: Callable[[], float]) -> None:
    with stats._lock:
        stats.source = "cache"
        stats.best = dict(doc["config"])
        stats.best_cost_s = doc.get("cost_s")
        stats.trials = [(dict(c), float(s)) for c, s in doc.get("log") or []]
        stats.store_path = _store.config_path(key)
        stats.wall_s = elapsed()


def _record_measured(stats: AutotuneStats, log: Log, best: Config,
                     best_cost: float, path: Optional[str],
                     elapsed: Callable[[], float]) -> None:
    with stats._lock:
        stats.source = "measured"
        stats.trials = log
        stats.best = best
        stats.best_cost_s = best_cost
        stats.store_path = path
        stats.wall_s = elapsed()


class Autotuner:
    """Measure-or-load tuner for one knob space.  ``key`` is a
    :func:`~mxnet_tpu_torch.autotune.measure.tuning_key`; ``persist``
    reads and writes the on-disk store."""

    def __init__(self, name: str, key: str, persist: bool = True):
        self.name = name
        self.key = key
        self.persist = persist
        self.stats = AutotuneStats(name, key)
        from . import _register_stats
        _register_stats(self.stats)

    def tune(self, candidates: Sequence[Config],
             measure: Callable[[Config], float],
             meta: Optional[Dict[str, Any]] = None) -> Tuple[Config, float]:
        """-> (winning config, its cost; the stored one on a cache hit).
        A persisted winner no longer among the candidates is ignored."""
        if not candidates:
            raise MXNetError("autotune %r: no candidates" % self.name)
        elapsed = wall_timer()
        if self.persist:
            doc = _store.load_config(self.key)
            if doc is not None and any(doc["config"] == dict(c)
                                       for c in candidates):
                _record_cache_hit(self.stats, self.key, doc, elapsed)
                return dict(doc["config"]), float(doc.get("cost_s") or 0.0)
        log: Log = []
        for cfg in candidates:
            self.stats.calls["measure"] += 1
            log.append((dict(cfg), float(measure(dict(cfg)))))
        best, best_cost = select_best(log)
        path = None
        if self.persist:
            path = _store.save_config(self.key, best, best_cost,
                                      meta=meta, log=log)
        _record_measured(self.stats, log, best, best_cost, path, elapsed)
        return best, best_cost
