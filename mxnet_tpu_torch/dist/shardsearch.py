"""Automatic sharding search: ``fit(mesh=..., sharding="auto")``
(counterpart of ``mxnet_tpu/dist/shardsearch.py``, with the same
candidates, store records and knobs).

1. **Enumerate** a bounded set of global strategies from the parameter
   shapes: replicate everything (pure dp), column-sharded (the last dim
   over the non-dp "model" axes), row-sharded (the first dim), and the
   two alternating column/row assignments (the Megatron pairing, both
   phases).  Only parameters whose dim divides the model-axis product
   are sharded; every candidate is valid by construction
   (``parallel.mesh.validate_spec``).

2. **Score** each candidate with the shared cost model
   (``autotune.costmodel``, the scorer ``JointTuner`` ranks with) over
   features of one eager step of the candidate's sharded fused step:
   this rank's FLOPs (``FlopCounterMode``), the bytes of the state and
   of the activations autograd saved, and the collectives module's
   census (``parallel.collectives.STATS``).  The reference reads XLA's
   cost analysis of an AOT compile; the port has no compile step, so it
   takes the step itself, as ``autotune.joint`` does for the fit space.
   The features are memoized in this process under the step's program
   description (``FusedTrainStep._program_desc``, the ``fast_key`` of its
   captures) and the batch's shapes, so the shortlist's second trial of
   a candidate takes no second eager step.  No score persists across
   processes (a new process scores again); the winner does (4.).  A
   single-process search uses the host's trained model; several ranks
   score with the deterministic ``analytic_cost`` prior, so every rank
   shortlists identically (they step together).

3. **Measure** only the shortlist (``MXNET_DIST_SHARDSEARCH_SHORTLIST``
   best estimates, default 2): the step is warmed and captured
   (``FusedTrainStep.prepare``), the card drained, then
   ``MXNET_DIST_SHARDSEARCH_STEPS`` steps (default 3) timed to a drained
   card.  The estimate ranks; the measurement decides.

4. **Persist** the winner under a fingerprint of everything that changes
   the answer (symbol, parameter shapes, mesh axes, the card's name,
   the device count and the world size) in the autotune store
   (``MXNET_AUTOTUNE_DIR``, prefix ``shardsearch-``).  A store hit skips
   the whole search.

Several ranks search in lockstep, then rank 0's measured winner is
broadcast over the process group, so every rank installs the same
specs; only rank 0 writes the store.  ``MXNET_DIST_SHARDSEARCH=0``
disables resolution (``sharding="auto"`` then means "just the
``__sharding__`` symbol attributes").
"""
from __future__ import annotations

import gc
import hashlib
import json
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..base import MXNetError, get_env

__all__ = ["resolve_auto", "search_sharding", "enumerate_candidates",
           "fingerprint"]

_STORE_PREFIX = "shardsearch-"

# (program description, batch shapes) -> (flops, bytes, census): one
# eager step's features, kept for this process
_FEATURES: Dict[tuple, tuple] = {}
# what this process did: trials built, eager feature steps taken
COUNTS = {"trials": 0, "feature_steps": 0}


# -- candidate enumeration ---------------------------------------------------
def _model_axes(mesh) -> List[Tuple[str, int]]:
    """The non-dp mesh axes with size > 1: the axes a parameter can
    shard over (dp carries the batch)."""
    return [(str(a), int(s)) for a, s in mesh.shape.items()
            if str(a) != "dp" and int(s) > 1]


def enumerate_candidates(shapes: Dict[str, tuple], mesh) \
        -> List[Tuple[str, Dict[str, list]]]:
    """Bounded global strategies as ``(name, {param: spec_entries})``
    pairs.  ``spec_entries`` is the JSON form: a list per parameter of
    ``None`` / axis name / list of axis names.  Parameters not named
    stay replicated (modulo ``__sharding__`` attributes, which the fused
    step merges underneath).  ``mesh`` is anything with an ordered
    ``shape`` of ``{axis: size}``."""
    from ..parallel.mesh import validate_spec
    model = _model_axes(mesh)
    if not model:
        return [("dp", {})]
    axes = [a for a, _ in model]
    ways = 1
    for _, s in model:
        ways *= s
    entry = axes[0] if len(axes) == 1 else list(axes)
    eligible = [(n, tuple(shapes[n])) for n in sorted(shapes)
                if len(shapes[n]) >= 2]

    def col(nd):
        return [None] * (nd - 1) + [entry]

    def row(nd):
        return [entry] + [None] * (nd - 1)

    def strat(pick):
        specs = {}
        for i, (n, shape) in enumerate(eligible):
            kind = pick(i, shape)
            if kind == "col" and shape[-1] % ways == 0:
                specs[n] = col(len(shape))
            elif kind == "row" and shape[0] % ways == 0:
                specs[n] = row(len(shape))
        for n, entries in specs.items():
            validate_spec(n, _to_spec(entries), mesh, shapes[n])
        return specs

    cands: List[Tuple[str, Dict[str, list]]] = [("dp", {})]
    seen = {json.dumps({}, sort_keys=True)}
    for name, pick in (
            ("col", lambda i, s: "col"),
            ("row", lambda i, s: "row"),
            ("alt", lambda i, s: "col" if i % 2 == 0 else "row"),
            ("alt2", lambda i, s: "row" if i % 2 == 0 else "col")):
        specs = strat(pick)
        key = json.dumps(specs, sort_keys=True)
        if key not in seen:
            seen.add(key)
            cands.append((name, specs))
    return cands


def _to_spec(entries):
    from ..parallel.mesh import PartitionSpec
    return PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                           for e in entries])


def _to_partition_specs(specs: Dict[str, list]) -> dict:
    """JSON spec entries -> PartitionSpec map (inner lists become the
    tuple-of-axes form: one dim over the product of those axes)."""
    return {n: _to_spec(entries) for n, entries in specs.items()}


# -- fingerprint -------------------------------------------------------------
def _device_name(device=None) -> str:
    """The card's name, or ``"cpu"``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch.cuda.get_device_name(index)


def _world_size() -> int:
    from . import boot
    return boot.world_size()


def fingerprint(symbol, param_shapes: Dict[str, tuple], mesh,
                device=None) -> str:
    """Store key: everything that changes the search's answer: the model
    (symbol JSON + parameter shapes) and the topology (mesh axes, the
    name of ``device``'s card or ``"cpu"``, the device count and the
    world size).  The platform string is the port's own, so a key never
    matches one the JAX package wrote."""
    from ..parallel.mesh import mesh_axes
    h = hashlib.sha1()
    h.update(symbol.tojson().encode())
    for n in sorted(param_shapes):
        h.update(("%s:%s;" % (n, tuple(param_shapes[n]))).encode())
    h.update(repr(mesh_axes(mesh)).encode())
    h.update(("torch:%s:%d:%d" % (_device_name(device), int(mesh.size),
                                  _world_size())).encode())
    return _STORE_PREFIX + h.hexdigest()[:20]


# -- scoring + measurement ---------------------------------------------------
def _featurize(flops: float, bytes_accessed: float, census, mesh) \
        -> List[float]:
    """A candidate's step characteristics on the shared cost-model
    feature schema (autotune.costmodel.FEATURE_NAMES)."""
    from ..autotune.costmodel import features
    census = census or {}
    return features(
        gflops=float(flops) / 1e9,
        hbm_gb=float(bytes_accessed) / 1e9,
        coll_gb=float(census.get("total_bytes", 0.0)) / 1e9,
        coll_count=float(census.get("total_count", 0.0)),
        mesh_devices=float(mesh.size),
        mesh_axes=float(len(mesh.axis_names)))


def _estimate_s(feat, multiprocess: bool) -> float:
    """Predicted step time from the shared cost model: the deterministic
    analytic prior over several ranks (identical on every rank), the
    host's trained model in one process."""
    from ..autotune import costmodel
    if multiprocess:
        return costmodel.analytic_cost(feat)
    return costmodel.get_model().predict(feat)


def _nbytes(tree) -> int:
    from ..module.fused import flatten_tensors
    total = 0
    for v in (tree.values() if isinstance(tree, dict) else [tree]):
        for t in flatten_tensors(v):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total


class _Trial:
    """One candidate's fused step, state and zero batch, built from the
    module's own bind (same symbol, optimizer, shapes)."""

    def __init__(self, module, mesh, specs: Dict[str, list]):
        from ..autotune import _zero_batch
        from ..module.fused import FusedTrainStep
        COUNTS["trials"] += 1
        gdp = (module._kvstore is not None
               and "dist_sync" in module._kvstore.type)
        self.fused = FusedTrainStep(
            module._symbol, module._context[0], module._data_names,
            module._label_names, module._param_names,
            module._fixed_param_names, module._optimizer, mesh=mesh,
            global_dp=gdp, sharding=_to_partition_specs(specs),
            remat=get_env("MXNET_BACKWARD_DO_MIRROR", False, bool))
        self.fused.init_state(module._arg_params, module._aux_params)
        self.batch = self.fused.make_batch(_zero_batch(module),
                                           note_ids=False)
        self.fused.state["lr"].fill_(float(module._optimizer.base_lr()))

    def step_cost(self):
        """-> (flops, bytes, collective census) of one step: from the
        in-process memo, else from one eager step of the fused body."""
        fused = self.fused
        key = (fused._program_desc("step"), fused._key(self.batch))
        cost = _FEATURES.get(key)
        if cost is None:
            cost = _FEATURES[key] = self._eager_cost()
        if fused.multichip_stats is not None:
            fused.multichip_stats.set_cost(cost[0], cost[1],
                                           collectives=cost[2])
        return cost

    def _eager_cost(self):
        from torch.utils.flop_counter import FlopCounterMode
        from ..parallel import collectives
        COUNTS["feature_steps"] += 1
        saved: Dict[int, int] = {}

        def pack(t):
            saved[t.data_ptr()] = t.numel() * t.element_size()
            return t

        calls0 = collectives.STATS["calls"]
        bytes0 = collectives.STATS["bytes"]
        with FlopCounterMode(display=False) as fc, \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            self.fused._body(self.batch)
        st = self.fused.state
        nbytes = 2 * _nbytes(st["params"]) + _nbytes(st["opt"]) \
            + sum(saved.values())
        census = {"total_count": collectives.STATS["calls"] - calls0,
                  "total_bytes": collectives.STATS["bytes"] - bytes0}
        return float(fc.get_total_flops()), float(nbytes), census

    def measure_s(self, steps: int) -> float:
        """Mean wall of ``steps`` steps from a drained card to a drained
        card, after the step of this batch shape is warmed and captured
        (``prepare``, which leaves the state as it was)."""
        fused = self.fused
        fused.prepare(self.batch)
        fused._sync()
        t0 = time.perf_counter()
        for _ in range(max(1, steps)):
            fused.step(self.batch)
        fused._sync()
        return (time.perf_counter() - t0) / max(1, steps)

    def close(self) -> None:
        """Drop the step's graphs, its state and its batch, and hand the
        card's cached blocks back (several candidates of a large model
        would not fit on the card together)."""
        fused = self.fused
        if fused is not None:
            fused.drop_graphs()
            fused.state = None
            fused._buffers.clear()
            fused._side = None
        self.fused = None
        self.batch = None
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()


def _broadcast_pick(best: int, device) -> int:
    """Rank 0's pick, on every rank."""
    import torch.distributed as dist
    from . import boot
    dev = device if boot.backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([best], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


# -- the search --------------------------------------------------------------
def _shapes(module) -> Dict[str, tuple]:
    return {n: tuple(module._arg_params[n].shape)
            for n in module._param_names}


def search_sharding(module, mesh, log_fn=None) \
        -> Tuple[Dict[str, list], list]:
    """Run the full search (no store involvement); returns
    ``(winning_spec_entries, measurement_log)`` where the log is
    ``[({"strategy": name, "specs": {...}, "est_s": e}, measured_s),
    ...]``, the autotune store's audit format.  The trials' steps draw
    from the generators (Dropout's masks); their states are put back
    afterwards, so the training after the search draws what it would
    have drawn with the winner's specs given by hand."""
    from .. import random as _random
    gens = [_random.generator(d) for d in
            {torch.device("cpu"), module._context[0].torch_device()}]
    states = [g.get_state() for g in gens]
    try:
        return _search(module, mesh, log_fn)
    finally:
        for g, st in zip(gens, states):
            g.set_state(st)


def _search(module, mesh, log_fn):
    cands = enumerate_candidates(_shapes(module), mesh)
    shortlist_n = max(1, get_env("MXNET_DIST_SHARDSEARCH_SHORTLIST",
                                 2, int))
    steps = max(1, get_env("MXNET_DIST_SHARDSEARCH_STEPS", 3, int))
    multiprocess = mesh.size > 1

    scored = []
    for name, specs in cands:
        trial = _Trial(module, mesh, specs)
        try:
            flops, nbytes, census = trial.step_cost()
            feat = _featurize(flops, nbytes, census, mesh)
            est = _estimate_s(feat, multiprocess=multiprocess)
        finally:
            trial.close()
        scored.append((est, name, specs, feat))
        if log_fn:
            log_fn("shardsearch: candidate %-4s est %.3es" % (name, est))
    # a deterministic shortlist: estimate, then name, the same on every
    # rank (several ranks score with the analytic prior)
    scored.sort(key=lambda t: (t[0], t[1]))
    shortlist = scored[:shortlist_n]

    measured = []
    mlog = []
    for est, name, specs, feat in shortlist:
        trial = _Trial(module, mesh, specs)
        try:
            trial.step_cost()      # the memo: no second eager step
            s = trial.measure_s(steps)
        finally:
            trial.close()
        measured.append((s, name, specs))
        # "_feat" makes this measurement training data for the shared
        # cost model (costmodel.refit_from_store walks the audit logs)
        mlog.append(({"strategy": name, "specs": specs,
                      "est_s": round(est, 9), "_feat": feat}, s))
        if log_fn:
            log_fn("shardsearch: measured  %-4s %.3es/step" % (name, s))
    for est, name, specs, feat in scored[shortlist_n:]:
        # the audit log records why the tail was never measured
        mlog.append(({"strategy": name, "specs": specs,
                      "est_s": round(est, 9), "shortlisted": False},
                     -1.0))

    best = min(range(len(measured)), key=lambda i: measured[i][0])
    if multiprocess:
        # the ranks' clocks differ; rank 0's pick is the pick, or the
        # ranks install different specs and wedge in their first step
        best = _broadcast_pick(best, module._context[0].torch_device())
    _, name, specs = measured[best]
    if log_fn:
        log_fn("shardsearch: winner %s (%.3es/step over %d candidates, "
               "%d measured)" % (name, measured[best][0], len(cands),
                                 len(measured)))
    return specs, mlog


def resolve_auto(module, mesh) -> Optional[dict]:
    """The ``sharding="auto"`` entry point (``Module._setup_fused``):
    a store hit gives the persisted winner; a miss runs the search,
    persists it on rank 0 and returns PartitionSpecs (None: nothing to
    shard, the merge then leaves only the ``__sharding__`` attributes)."""
    if not get_env("MXNET_DIST_SHARDSEARCH", True, bool):
        return None
    if mesh is None:
        raise MXNetError("sharding='auto' needs a mesh to search over")
    from ..autotune import store
    from . import boot
    shapes = _shapes(module)
    key = fingerprint(module._symbol, shapes, mesh,
                      device=module._context[0].torch_device())
    doc = store.load_config(key)
    if doc is not None:
        specs = doc["config"].get("specs", {})
        return _to_partition_specs(specs) if specs else None
    log_fn = module.logger.info if hasattr(module, "logger") else None
    specs, mlog = search_sharding(module, mesh, log_fn=log_fn)
    best_s = min((s for _, s in mlog if s >= 0), default=0.0)
    if boot.rank() == 0:
        from ..parallel.mesh import mesh_axes
        store.save_config(
            key, {"specs": specs}, best_s,
            meta={"kind": "shardsearch",
                  "mesh": [list(ax) for ax in mesh_axes(mesh)],
                  "nparams": len(shapes)},
            log=mlog)
        # the featurized measurements just joined the training set:
        # fold them into the shared cost model for the next search
        from ..autotune.costmodel import refit_from_store
        refit_from_store()
    return _to_partition_specs(specs) if specs else None
