"""``mxnet_tpu_torch.autotune`` -- measurement-driven search over the
port's knobs (counterpart of ``mxnet_tpu/autotune``).

* the config store (the JAX package's record and path rules), the
  measure-or-load :class:`Autotuner`, the shared cost model and the
  rank-then-measure :class:`JointTuner`;
* fit-side: :func:`tune_superstep` (``Module.fit(autotune=True)``) picks
  the superstep K, :func:`tune_fit_joint` (``fit(autotune="joint")``)
  searches K x remat;
* serve-side: :func:`tune_serve_pipeline` (``ServeEngine(autotune=True)``)
  picks fusion on or off, :func:`tune_serve_joint`
  (``ServeEngine(autotune="joint")``) searches fusion x bucket grid x
  quantize op set;
* the kernel search over the hand-written kernels' tiles
  (:mod:`.kernelsearch`: flash's (block_q, block_k), fc's block_n,
  paged's partition length)::

    mx.autotune.kernelsearch.search_flash(4, 1024, 12, 64, causal=True)
    MXNET_KERNEL_SEARCH=1   # the kernels then load their winners

Measuring never advances training: on the card a replay writes the live
parameters in place, so every fit-side trial runs between the fused
step's ``snapshot_state()`` and ``restore_state()``; parameters,
optimizer slots, the step count and both generators' states are
afterwards bitwise what they were.  Winners persist per (model, shapes,
optimizer, backend) key under ``MXNET_AUTOTUNE_DIR``; a fresh process
loads one with zero measurements.  ``mx.profiler.autotune_report()``
shows what was decided and from what.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import get_env
from .measure import (CANDIDATE_SPAN, backend_descriptor, measure_candidate,
                      timed_span, tuning_key, wall_timer)
from .store import (config_path, list_configs, load_config, save_config,
                    store_dir)
from .tuner import Autotuner, AutotuneStats, select_best

__all__ = ["Autotuner", "AutotuneStats", "select_best", "tuning_key",
           "backend_descriptor", "measure_candidate", "timed_span",
           "wall_timer", "store_dir", "config_path", "load_config",
           "save_config", "list_configs", "enabled", "mode", "JointTuner",
           "default_shortlist", "recent_stats", "CANDIDATE_SPAN",
           "costmodel", "kernelsearch", "tune_superstep",
           "tune_serve_pipeline", "tune_fit_joint", "tune_serve_joint"]

# a tuning run is an event: keep the last N records for reports (the
# profiler's registry holds them weakly)
_MAX_KEPT = 64
_kept_stats: List[AutotuneStats] = []


def _register_stats(stats: AutotuneStats) -> None:
    from .. import profiler
    _kept_stats.append(stats)
    del _kept_stats[:-_MAX_KEPT]
    profiler.register_autotune_stats(stats)


def recent_stats() -> List[AutotuneStats]:
    """The records of the last tuning runs of this process, oldest
    first."""
    return list(_kept_stats)


def enabled(flag=None) -> bool:
    """Resolve an ``autotune=`` argument: an explicit True/False wins;
    None falls back to the ``MXNET_AUTOTUNE`` env knob (default off)."""
    if flag is not None:
        return bool(flag)
    return get_env("MXNET_AUTOTUNE", False, bool)


def mode(flag=None):
    """Resolve an ``autotune=`` argument to a tuning mode: ``"joint"``,
    ``"measure"`` (what ``True`` means), or None (off).
    ``MXNET_AUTOTUNE=joint`` selects joint, any other truthy value
    measure."""
    if flag is None:
        env = get_env("MXNET_AUTOTUNE", "", str)
        if env in ("", "0", "false", "False"):
            return None
        return "joint" if env == "joint" else "measure"
    if isinstance(flag, str):
        if not flag:
            return None
        return flag if flag == "joint" else "measure"
    return "measure" if flag else None


# -- fit-side tuning: superstep K --------------------------------------------

def _zero_batch(module):
    """A zero DataBatch at the module's bound shapes and dtypes (the
    uint8 HWC wire under device augmentation): the step's cost does not
    depend on the data, so measuring and ``Module.prepare`` need no
    feed."""
    from ..io import DataBatch
    from ..ndarray import zeros as nd_zeros
    ctx = module._context[0]
    ex = module._exec_group.execs[0] if module._exec_group is not None \
        else None

    def zeros(name, shape):
        arr = ex.arg_dict.get(name) if ex is not None else None
        return nd_zeros(shape, ctx=ctx,
                        dtype=arr.dtype if arr is not None else np.float32)
    fused = getattr(module, "_fused", None)
    spec = getattr(fused, "device_augment", None)
    shapes = list(module._data_shapes)
    if spec is not None:
        batch = shapes[0][1][0]
        data = [nd_zeros((batch,) + tuple(spec.pre_shape), ctx=ctx,
                         dtype=np.uint8)]
        data += [zeros(n, s) for n, s in shapes[1:]]
    else:
        data = [zeros(n, s) for n, s in shapes]
    return DataBatch(data=data, label=[zeros(n, s) for n, s in
                                       (module._label_shapes or [])])


def _measure_superstep(module, k: int, trials: int,
                       unroll: int = 1) -> float:
    """Seconds per training step at superstep K, measured on the real
    (captured) step over zero batches.  Every trial runs between the
    fused step's ``snapshot_state()`` and ``restore_state()``, which
    also puts the generators back, and the module's step counters and
    scheduler are restored: measuring never advances training.
    ``unroll`` has no counterpart in the port (there is no scan to
    unroll) and is ignored."""
    fused = module._fused
    batch = fused.make_batch(_zero_batch(module), note_ids=False)
    fused.prepare(batch)            # measure replays, not warm-up steps
    snap = fused.snapshot_state()
    lr = float(module._optimizer.base_lr())

    def setup():
        fused.restore_state(snap)

    try:
        if k == 1:
            return measure_candidate(lambda: fused.step(batch, lr=lr),
                                     label="superstep=1", trials=trials,
                                     warmup=1, setup=setup)
        _k, mega = fused.make_megabatch(
            [_zero_batch(module) for _ in range(k)], note_ids=False)
        lrs = [lr] * k
        return measure_candidate(
            lambda: fused.superstep(k, mega, lrs),
            label="superstep=%d,unroll=%d" % (k, unroll), trials=trials,
            warmup=1, setup=setup) / k
    finally:
        fused.restore_state(snap)


def tune_superstep(module, candidates: Sequence[int] = (1, 2, 4, 8),
                   viable: Optional[Callable[[int], Optional[str]]] = None,
                   trials: int = 2, persist: bool = True) -> int:
    """Pick superstep K by measuring: the ``Module.fit(autotune=True)``
    entry when neither ``superstep=`` nor ``MXNET_SUPERSTEP`` chose.
    ``viable(k)`` returns a blocker string or None; blocked Ks leave the
    candidates.  Returns 1 when the fused step is off or nothing beyond
    K=1 survives.  The winner persists per (symbol, shapes, optimizer,
    K space, backend) key, and a fresh process loads it without
    measuring."""
    fused = getattr(module, "_fused", None)
    if fused is None or not module.optimizer_initialized:
        return 1
    ks = sorted({int(k) for k in candidates if int(k) >= 1})
    if viable is not None:
        ks = [k for k in ks if k == 1 or viable(k) is None]
    if not ks or ks == [1]:
        return 1
    key = tuning_key(
        "fit:superstep", module._symbol.tojson(),
        sorted(module._data_shapes), sorted(module._label_shapes or []),
        type(module._optimizer).__name__, fused.hparam_signature(),
        tuple(ks), device=fused.device)
    tuner = Autotuner("fit:superstep", key, persist=persist)
    best, _cost = tuner.tune(
        [{"superstep": k} for k in ks],
        lambda cfg: _measure_superstep(module, cfg["superstep"], trials),
        meta={"candidates": ks,
              "backend": backend_descriptor(fused.device)})
    return int(best["superstep"])


# -- serve-side tuning: the pass pipeline ------------------------------------

def _quantize_tag(quantize) -> str:
    """Stable digest material for a ``quantize=`` argument (a mode
    string, falsy, or a kwargs dict whose array values stay out)."""
    if not quantize:
        return "-"
    if isinstance(quantize, str):
        return quantize
    if isinstance(quantize, dict):
        return ";".join(
            "%s=%r" % (k, v) for k, v in sorted(quantize.items())
            if isinstance(v, (str, int, float, bool, tuple)))
    return type(quantize).__name__


def _device_of(dev):
    from ..context import Context
    return Context(dev[0], dev[1]).torch_device()


def _time_forward(p, data_name: str, label: str, trials: int) -> float:
    """Seconds of one warm forward of a Predictor on zeros, output read
    back (the engine's batch path)."""
    arr = p._exec.arg_dict[data_name]
    data = np.zeros(tuple(arr.shape), np.dtype(arr.dtype))

    def run():
        p.set_input(data_name, data)
        p.forward()
        p.get_output(0)
    return measure_candidate(run, label=label, trials=trials, warmup=2)


def tune_serve_pipeline(symbol_json: str, params: Dict,
                        shapes: Dict[str, Tuple[int, ...]],
                        data_name: str = "data", quantize=None,
                        calib_data=None, u8_wire=None,
                        dev: Tuple[str, int] = ("gpu", 0),
                        name: str = "autotune",
                        trials: int = 5, persist: bool = True):
    """Pick the serving pipeline variant by measuring: the
    ``ServeEngine(autotune=True)`` entry.  The candidates are fusion on
    and off around the same fold/CSE/DCE[/quantize] spine; each builds a
    Predictor at the engine's largest bucket on ``dev`` and is timed over
    warm forwards.  -> ``(fuse, pipeline)``: the winner's built pipeline
    when this call measured, None on a store hit (the caller builds
    one)."""
    from ..context import Context
    from ..passes.quantize import build_serving_pipeline
    from ..predictor import Predictor
    device = _device_of(dev)
    key = tuning_key("serve:pipeline", symbol_json,
                     sorted((k, tuple(v)) for k, v in shapes.items()),
                     data_name, _quantize_tag(quantize), bool(u8_wire),
                     device=device)
    tuner = Autotuner("serve:pipeline", key, persist=persist)
    built: Dict[bool, Any] = {}

    def measure(cfg):
        pipe = build_serving_pipeline(
            quantize=quantize, calib_data=calib_data,
            calib_shapes=dict(shapes), data_name=data_name,
            u8_wire=u8_wire, fuse=cfg["fuse"], name=name,
            ctx=Context(dev[0], dev[1]))
        built[bool(cfg["fuse"])] = pipe
        p = Predictor(symbol_json, dict(params), dict(shapes),
                      dev[0], dev[1], pipeline=pipe)
        return _time_forward(p, data_name, "fuse=%s" % cfg["fuse"], trials)

    best, _cost = tuner.tune(
        [{"fuse": True}, {"fuse": False}], measure,
        meta={"quantize": _quantize_tag(quantize),
              "backend": backend_descriptor(device)})
    fuse = bool(best["fuse"])
    return fuse, built.get(fuse)


# -- joint-space tuning (cost-model-ranked; see joint.py) --------------------
from .joint import (JointTuner, default_shortlist,  # noqa: E402
                    tune_fit_joint, tune_serve_joint)
from . import costmodel, kernelsearch  # noqa: E402,F401
