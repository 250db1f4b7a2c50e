"""Joint-space tuning: rank with the shared cost model, measure a
shortlist (counterpart of ``mxnet_tpu/autotune/joint.py``).

:class:`JointTuner` runs one search:

1. store lookup (``model_version``-stamped, so a cost-model bump never
   resurrects a winner ranked by the old model); a hit applies with zero
   gate, featurize and measure calls;
2. otherwise: the parity ``gate`` over every candidate, featurize the
   survivors, rank by predicted cost, measure only the top
   ``MXNET_AUTOTUNE_SHORTLIST``, select by
   :func:`~mxnet_tpu_torch.autotune.tuner.select_best` over the measured
   entries;
3. persist the winner and the full audit log -- measured candidates with
   their cost, features (``"_feat"``) and prediction (``"est_s"``),
   unmeasured ones with ``"shortlisted": False`` and cost -1.0, gate
   failures with ``"parity": False`` -- then refit the model from the
   store.

``tune_fit_joint`` (over ``fit(superstep=)``'s K) and ``tune_serve_joint``
wait for ROADMAP.md queue 1 item 11 (the quantize passes it searches over
are in ``passes``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, get_env
from . import store as _store
from .costmodel import (COSTMODEL_VERSION, clean_config, get_model,
                        refit_from_store)
from .measure import backend_descriptor, wall_timer
from .tuner import AutotuneStats, _record_cache_hit, _record_measured, \
    select_best

__all__ = ["JointTuner", "default_shortlist"]

Config = Dict[str, Any]


def default_shortlist() -> int:
    """How many top-ranked candidates a joint search measures
    (``MXNET_AUTOTUNE_SHORTLIST``, default 3)."""
    return max(1, get_env("MXNET_AUTOTUNE_SHORTLIST", 3, int))


class JointTuner:
    """Rank-then-measure tuner over one joint candidate space.  Configs
    must round-trip through JSON (lists, not tuples).  ``device`` is
    where the candidates run: it picks the cost model's backend."""

    def __init__(self, name: str, key: str, persist: bool = True,
                 shortlist: Optional[int] = None, device=None):
        self.name = name
        self.key = key
        self.persist = persist
        self.shortlist = default_shortlist() if shortlist is None \
            else max(1, int(shortlist))
        self.backend = backend_descriptor(device)
        self.gate_failures = 0
        self.stats = AutotuneStats(name, key)
        from . import _register_stats
        _register_stats(self.stats)

    def tune(self, candidates: Sequence[Config],
             featurize: Callable[[Config], Sequence[float]],
             measure: Callable[[Config], float],
             meta: Optional[Dict[str, Any]] = None,
             gate: Optional[Callable[[Config], bool]] = None) \
            -> Tuple[Config, float]:
        """-> (winning clean config, its cost).  ``gate`` runs on every
        candidate before ranking: a failing candidate is only logged and
        can never win; if none passes, the search raises."""
        cands = [dict(c) for c in candidates]
        if not cands:
            raise MXNetError("autotune %r: no candidates" % self.name)
        elapsed = wall_timer()
        if self.persist:
            doc = _store.load_config(self.key,
                                     model_version=COSTMODEL_VERSION)
            if doc is not None and any(doc["config"] == c for c in cands):
                _record_cache_hit(self.stats, self.key, doc, elapsed)
                return dict(doc["config"]), float(doc.get("cost_s") or 0.0)

        calls = self.stats.calls

        def counted(what, fn):
            def call(cfg):
                calls[what] += 1
                return fn(cfg)
            return call

        gate = counted("gate", gate) if gate is not None else None
        featurize = counted("featurize", featurize)
        measure = counted("measure", measure)
        gated: List[Tuple[Config, float]] = []
        live: List[int] = []
        for i, c in enumerate(cands):
            if gate is not None and not gate(dict(c)):
                self.gate_failures += 1
                gated.append((dict(c, parity=False), -1.0))
                continue
            live.append(i)
        if not live:
            raise MXNetError("autotune %r: no candidate passed the "
                             "parity gate" % self.name)
        model = get_model(self.backend)
        feats = {i: [float(v) for v in featurize(dict(cands[i]))]
                 for i in live}
        preds = {i: model.predict(feats[i]) for i in live}
        order = sorted(live, key=lambda i: (preds[i], i))
        short = order[:self.shortlist]

        log: List[Tuple[Config, float]] = []
        for i in short:
            cost = float(measure(dict(cands[i])))
            log.append((dict(cands[i], _feat=feats[i],
                             est_s=round(preds[i], 9)), cost))
        measured = list(log)
        for i in order[self.shortlist:]:
            log.append((dict(cands[i], est_s=round(preds[i], 9),
                             shortlisted=False), -1.0))
        log.extend(gated)

        best_aud, best_cost = select_best(measured)
        best = clean_config(best_aud)
        path = None
        if self.persist:
            path = _store.save_config(
                self.key, best, best_cost,
                meta=dict(meta or {}, space_size=len(cands),
                          measured=len(measured), shortlist=self.shortlist,
                          model_trained=model.trained,
                          backend=self.backend),
                log=log, model_version=COSTMODEL_VERSION)
            # the new measurements join the training set at once
            refit_from_store(self.backend)
        _record_measured(self.stats, log, best, best_cost, path, elapsed)
        return best, best_cost
