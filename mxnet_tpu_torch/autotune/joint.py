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

:func:`tune_fit_joint` searches superstep K x remat for ``fit``;
:func:`tune_serve_joint` searches fusion x bucket grid x quantize op set
for ``ServeEngine``.

The port has no XLA cost analysis, so the fit space's features come from
one eager step of the fused body on a snapshot of the state (put back
afterwards): its FLOPs from ``torch.utils.flop_counter.FlopCounterMode``,
``hbm_gb`` from the bytes of the parameters, their gradients, the
optimizer slots and the activations the walk saves for backward, and the
collective features from ``parallel.collectives.STATS`` over that step.
The cost model only ranks; measurement decides.  ``unroll`` has no
counterpart (a captured superstep is K replays, with no ``lax.scan`` to
unroll), so the port enumerates ``unroll=1`` only (ROADMAP.md queue 3,
"Recorded differences").
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, get_env
from . import store as _store
from .costmodel import (COSTMODEL_VERSION, clean_config, features,
                        get_model, refit_from_store)
from .measure import backend_descriptor, tuning_key, wall_timer
from .tuner import AutotuneStats, _record_cache_hit, _record_measured, \
    select_best

__all__ = ["JointTuner", "default_shortlist", "tune_fit_joint",
           "tune_serve_joint"]

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


# -- fit-side joint space: superstep K x remat -------------------------------

_FIT_KS = (1, 2, 3, 4, 6, 8, 12, 16)
# the reference's scan unroll factors; the port enumerates unroll=1 only
_FIT_UNROLLS = (1, 2, 4)


def _fit_space(ks: Sequence[int]) -> List[Config]:
    """The fit-side joint space, the reference's tuple shape with
    ``unroll`` fixed at 1.  Every knob keeps the trajectory: superstep K
    is bitwise K sequential steps, and remat recomputes the same
    forward."""
    space: List[Config] = []
    for k in ks:
        for remat in (False, True):
            space.append({"superstep": int(k), "unroll": 1,
                          "remat": bool(remat)})
    return space


def _step_features(module) -> Dict[str, float]:
    """Compute, memory and collective features of one training step,
    from one eager step of the fused body on a snapshot of the state
    (put back afterwards, the generators too)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from ..parallel import collectives
    from . import _zero_batch
    fused = module._fused
    batch = fused.make_batch(_zero_batch(module), note_ids=False)
    snap = fused.snapshot_state()
    saved: Dict[int, int] = {}

    def pack(t):
        saved[t.data_ptr()] = t.numel() * t.element_size()
        return t

    calls0 = collectives.STATS["calls"]
    bytes0 = collectives.STATS["bytes"]
    try:
        fused.state["lr"].fill_(float(module._optimizer.base_lr()))
        with FlopCounterMode(display=False) as fc, \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fused._body(batch)
        flops = float(fc.get_total_flops())
    finally:
        fused.restore_state(snap)
        fused._lr_host = None
    st = fused.state

    def nbytes(tree) -> int:
        from ..module.fused import flatten_tensors
        total = 0
        for v in (tree.values() if isinstance(tree, dict) else [tree]):
            for t in flatten_tensors(v):
                if isinstance(t, torch.Tensor):
                    total += t.numel() * t.element_size()
        return total
    params = nbytes(st["params"])
    hbm = 2 * params + nbytes(st["opt"]) + sum(saved.values())
    return {"gflops": flops / 1e9, "hbm_gb": hbm / 1e9,
            "coll_gb": (collectives.STATS["bytes"] - bytes0) / 1e9,
            "coll_count": float(collectives.STATS["calls"] - calls0)}


def tune_fit_joint(module, viable=None, trials: int = 2,
                   persist: bool = True,
                   shortlist: Optional[int] = None) -> Config:
    """Joint fit-side search: the ``Module.fit(autotune="joint")`` entry.
    Enumerates superstep K x remat, ranks with the shared cost model over
    one step's features (the module docstring says where they come
    from), measures the shortlist between snapshots of the state, and
    returns the winning ``{"superstep", "unroll", "remat"}`` (the caller
    applies it through ``Module.apply_joint_config``).  ``viable(k)`` is
    the module's superstep-blocker closure: blocked Ks leave the space."""
    from . import _measure_superstep
    fused = getattr(module, "_fused", None)
    if fused is None or not module.optimizer_initialized:
        return {"superstep": 1, "unroll": 1, "remat": False}
    ks = [k for k in _FIT_KS if k == 1 or viable is None or viable(k) is None]
    space = _fit_space(ks)
    key = tuning_key(
        "fit:joint", module._symbol.tojson(),
        sorted(module._data_shapes), sorted(module._label_shapes or []),
        type(module._optimizer).__name__, fused.hparam_signature(),
        tuple(ks), (1,), device=fused.device)
    base: Dict[str, float] = {}

    def baseline() -> Dict[str, float]:
        # one eager step feeds every candidate's features: lazy, so a
        # store hit runs nothing
        if not base:
            base.update(_step_features(module))
        return base

    mesh = fused.mesh

    def featurize(cfg: Config) -> List[float]:
        b = baseline()
        k = int(cfg["superstep"])
        return features(
            gflops=b["gflops"], hbm_gb=b["hbm_gb"], coll_gb=b["coll_gb"],
            coll_count=b["coll_count"], inv_k=1.0 / k, superstep_k=k,
            unroll=cfg["unroll"], remat=1.0 if cfg["remat"] else 0.0,
            mesh_devices=mesh.size if mesh is not None else 1,
            mesh_axes=len(mesh.axis_names) if mesh is not None else 1)

    def measure(cfg: Config) -> float:
        prev = fused._remat
        try:
            fused.set_remat(bool(cfg["remat"]))
            return _measure_superstep(module, int(cfg["superstep"]), trials,
                                      unroll=int(cfg["unroll"]))
        finally:
            fused.set_remat(prev)

    tuner = JointTuner("fit:joint", key, persist=persist,
                       shortlist=shortlist, device=fused.device)
    best, _cost = tuner.tune(
        space, featurize, measure,
        meta={"candidates": ks,
              "backend": backend_descriptor(fused.device)})
    return {"superstep": int(best["superstep"]),
            "unroll": int(best.get("unroll", 1)),
            "remat": bool(best.get("remat", False))}


# -- serve-side joint space: fusion x bucket grid x quantize op set ----------

def _bucket_grids(max_b: int) -> List[Tuple[int, ...]]:
    """Candidate bucket grids under one max batch: every suffix of the
    pow2 chain up to ``max_b`` (finer grids pad less but keep more
    programs) plus the sparse (small, max) pairs."""
    chain: List[int] = []
    b = max(1, int(max_b))
    while b >= 1:
        chain.append(b)
        b //= 2
    chain = sorted(set(chain))
    grids = [tuple(chain[i:]) for i in range(len(chain))]
    for b in chain[:-1]:
        pair = (b, chain[-1])
        if pair not in grids:
            grids.append(pair)
    return grids


def _grid_pad_waste(grid: Sequence[int]) -> float:
    """Mean padded fraction over request sizes 1..max for uniform
    arrivals: each size r runs at the smallest bucket >= r."""
    buckets = sorted(grid)
    waste = []
    for r in range(1, buckets[-1] + 1):
        b = next(x for x in buckets if x >= r)
        waste.append((b - r) / float(b))
    return float(np.mean(waste)) if waste else 0.0


def _quantize_candidates(quantize, ctx=None) -> List[Any]:
    """Quantize-axis candidates: for a plain mode string ("int8") every
    non-empty subset of the default op set on ``ctx``'s device; an
    explicit dict or a falsy value is taken as it is (one candidate)."""
    if not (isinstance(quantize, str) and quantize):
        return [quantize]
    from ..passes.quantize import default_quantize_ops
    ops = sorted(default_quantize_ops(ctx))
    subsets: List[List[str]] = []
    for bits in range(1, 2 ** len(ops)):
        subsets.append([op for i, op in enumerate(ops) if bits >> i & 1])
    return [{"dtype": quantize, "ops": subset} for subset in subsets]


def tune_serve_joint(symbol_json: str, params: Dict,
                     shapes_tpl: Dict[str, Tuple[int, ...]],
                     buckets: Sequence[int], data_name: str = "data",
                     quantize=None, calib_data=None, u8_wire=None,
                     dev: Tuple[str, int] = ("gpu", 0),
                     name: str = "autotune", explicit_buckets: bool = False,
                     trials: int = 5, persist: bool = True,
                     shortlist: Optional[int] = None):
    """Joint serve-side search: the ``ServeEngine(autotune="joint")``
    entry.  Space: fusion on/off x bucket grid (suffixes of the pow2
    chain under the engine's max batch; the caller's grid alone when
    ``explicit_buckets``) x quantize op subset (for a string
    ``quantize`` mode).  A candidate's cost is the expected per-item
    service time: each bucket's warm forward measured once and averaged
    over request sizes 1..max at the grid's padding.  -> ``(fuse,
    buckets, quantize_resolved, pipeline)``, ``pipeline`` the winner's
    built pipeline when this call measured (None on a store hit)."""
    from ..context import Context
    from ..passes.quantize import build_serving_pipeline
    from ..predictor import Predictor
    from . import _device_of, _quantize_tag, _time_forward
    ctx = Context(dev[0], dev[1])
    device = _device_of(dev)
    max_b = max(int(b) for b in buckets)
    grids = [tuple(sorted(int(b) for b in buckets))] if explicit_buckets \
        else _bucket_grids(max_b)
    qcands = _quantize_candidates(quantize, ctx)
    space: List[Config] = []
    for fuse in (True, False):
        for grid in grids:
            for q in qcands:
                space.append({
                    "fuse": fuse, "buckets": [int(b) for b in grid],
                    "quant_ops": sorted(q["ops"])
                    if isinstance(q, dict) and "ops" in q else None})
    key = tuning_key(
        "serve:joint", symbol_json,
        sorted((k, tuple(v)) for k, v in shapes_tpl.items()),
        data_name, _quantize_tag(quantize), bool(u8_wire),
        tuple(sorted(int(b) for b in buckets)), bool(explicit_buckets),
        device=device)

    def resolve_quantize(cfg: Config):
        if cfg["quant_ops"] is None:
            return quantize
        return {"dtype": quantize if isinstance(quantize, str) else "int8",
                "ops": tuple(cfg["quant_ops"])}

    def featurize(cfg: Config) -> List[float]:
        return features(
            fuse=1.0 if cfg["fuse"] else 0.0,
            quant_ops=float(len(cfg["quant_ops"] or ())),
            num_buckets=float(len(cfg["buckets"])),
            pad_waste=_grid_pad_waste(cfg["buckets"]))

    built: Dict[Tuple, Any] = {}

    def built_key(cfg: Config) -> Tuple:
        return (bool(cfg["fuse"]), tuple(cfg["quant_ops"] or ()))

    def measure(cfg: Config) -> float:
        bkey = built_key(cfg)
        pipe = built.get(bkey)
        if pipe is None:
            pipe = build_serving_pipeline(
                quantize=resolve_quantize(cfg), calib_data=calib_data,
                calib_shapes={k: (max_b,) + tuple(v[1:])
                              for k, v in shapes_tpl.items()},
                data_name=data_name, u8_wire=u8_wire, fuse=cfg["fuse"],
                name=name, ctx=ctx)
            built[bkey] = pipe
        grid = sorted(cfg["buckets"])
        t_bucket: Dict[int, float] = {}
        for b in grid:
            shapes = {k: (b,) + tuple(v[1:]) for k, v in shapes_tpl.items()}
            p = Predictor(symbol_json, dict(params), shapes,
                          dev[0], dev[1], pipeline=pipe)
            t_bucket[b] = _time_forward(
                p, data_name, "fuse=%s,b=%d" % (cfg["fuse"], b), trials)
        per_item = [t_bucket[next(x for x in grid if x >= r)] / r
                    for r in range(1, grid[-1] + 1)]
        return float(np.mean(per_item))

    tuner = JointTuner("serve:joint", key, persist=persist,
                       shortlist=shortlist, device=device)
    best, _cost = tuner.tune(
        space, featurize, measure,
        meta={"quantize": _quantize_tag(quantize), "max_batch": max_b,
              "backend": backend_descriptor(device)})
    fuse = bool(best["fuse"])
    win_buckets = tuple(sorted(int(b) for b in best["buckets"]))
    return (fuse, win_buckets, resolve_quantize(best),
            built.get(built_key(best)))
