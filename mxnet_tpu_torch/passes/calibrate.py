"""Activation-range calibration for quantized serving (counterpart of
``mxnet_tpu/passes/calibrate.py``).

Runs the float32 program over a feed sample and records, per internal
tensor, the range the quantize pass turns into int8 scales:

    table = passes.calibrate(sym, data_iter, num_batches=10,
                             arg_params=arg, aux_params=aux)
    qsym, qparams = QuantizePass(calib=table).apply(sym, params)

Two modes: ``minmax`` (|max| over every batch) and ``percentile`` (the
per-batch |x| percentile, max over batches).  The table's JSON is plain
and numpy-only, so a table either package writes loads in the other and
gives the same ``digest()``.  Tables computed by the two packages from
the same graph, params and feeds agree within float32 rounding of the
forward, not bitwise: the packages sum in other orders.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..base import MXNetError, atomic_local_write
from ..symbol import Symbol
from .pipeline import _as_np

__all__ = ["CalibrationTable", "calibrate", "calibrate_arrays"]

INT8_QMAX = 127.0


class CalibrationTable:
    """tensor name -> (lo, hi) observed range, plus provenance."""

    def __init__(self, ranges: Dict[str, Tuple[float, float]],
                 mode: str = "minmax", percentile: float = 99.99,
                 num_batches: int = 0):
        self.ranges = {k: (float(v[0]), float(v[1]))
                       for k, v in ranges.items()}
        self.mode = mode
        self.percentile = float(percentile)
        self.num_batches = int(num_batches)

    def scale(self, name: str) -> Optional[float]:
        """Symmetric int8 scale for a tensor, or None if uncalibrated or
        constant-zero (a zero range cannot key an int8 grid)."""
        r = self.ranges.get(name)
        if r is None:
            return None
        amax = max(abs(r[0]), abs(r[1]))
        return (amax / INT8_QMAX) if amax > 0 else None

    def digest(self) -> str:
        """Stable content hash; joins the quantize pass config and so the
        pipeline fingerprint."""
        h = hashlib.sha256()
        h.update(("%s;%r;%d" % (self.mode, self.percentile,
                                self.num_batches)).encode())
        for k in sorted(self.ranges):
            lo, hi = self.ranges[k]
            h.update(("%s=%.9e,%.9e;" % (k, lo, hi)).encode())
        return h.hexdigest()

    def tojson(self) -> str:
        return json.dumps({"mode": self.mode, "percentile": self.percentile,
                           "num_batches": self.num_batches,
                           "ranges": {k: list(v)
                                      for k, v in sorted(self.ranges.items())}},
                          indent=2)

    @classmethod
    def fromjson(cls, text: str) -> "CalibrationTable":
        doc = json.loads(text)
        return cls({k: tuple(v) for k, v in doc["ranges"].items()},
                   mode=doc.get("mode", "minmax"),
                   percentile=doc.get("percentile", 99.99),
                   num_batches=doc.get("num_batches", 0))

    def save(self, path: str) -> None:
        with atomic_local_write(path, "w") as f:
            f.write(self.tojson())

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            return cls.fromjson(f.read())

    def __len__(self):
        return len(self.ranges)

    def __repr__(self):
        return "<CalibrationTable %d tensors, %s, %d batches>" % (
            len(self.ranges), self.mode, self.num_batches)


def _batch_stat(arr: np.ndarray, mode: str, percentile: float) -> float:
    a = np.abs(arr.astype(np.float64, copy=False))
    if mode == "percentile":
        return float(np.percentile(a, percentile)) if a.size else 0.0
    return float(a.max()) if a.size else 0.0


def _observe(ranges, name, arr, mode, percentile):
    amax = _batch_stat(arr, mode, percentile)
    lo, hi = ranges.get(name, (0.0, 0.0))
    ranges[name] = (min(lo, -amax), max(hi, amax))


def calibrate(sym: Symbol, data_iter, num_batches: int = 10, *,
              arg_params: Dict, aux_params: Optional[Dict] = None,
              mode: str = "minmax", percentile: float = 99.99,
              ctx=None) -> CalibrationTable:
    """Run the float32 program over ``num_batches`` of ``data_iter`` and
    record every internal float tensor's range.  ``data_iter`` is any
    object with ``provide_data`` (and optionally ``provide_label``) as
    (name, shape) pairs, ``reset()``, and iteration yielding batches with
    ``data`` (and ``label``) lists; labels feed the graph when it
    declares them."""
    shapes = {}
    labels = list(getattr(data_iter, "provide_label", None) or [])
    for name, shape in list(data_iter.provide_data) + labels:
        shapes[name] = tuple(shape)
    feeds = []
    data_iter.reset()
    for i, batch in enumerate(data_iter):
        if i >= num_batches:
            break
        feed = {}
        for (name, _s), arr in zip(data_iter.provide_data, batch.data):
            feed[name] = _as_np(arr)
        for (name, _s), arr in zip(labels,
                                   getattr(batch, "label", None) or []):
            feed[name] = _as_np(arr)
        feeds.append(feed)
    if not feeds:
        raise MXNetError("calibrate: data_iter yielded no batches")
    return calibrate_arrays(sym, feeds, arg_params=arg_params,
                            aux_params=aux_params, mode=mode,
                            percentile=percentile, ctx=ctx,
                            default_shapes=shapes)


def calibrate_arrays(sym: Symbol, feeds: Iterable[Dict[str, np.ndarray]], *,
                     arg_params: Dict, aux_params: Optional[Dict] = None,
                     mode: str = "minmax", percentile: float = 99.99,
                     ctx=None, default_shapes=None) -> CalibrationTable:
    """Core calibration over explicit feed dicts (name -> batch array),
    run on ``ctx`` (default: the current context, the card).  Missing
    non-param arguments are zero-filled at their bound shape, as
    ServeEngine does for label inputs."""
    from ..context import current_context
    from .. import trace as _trace
    if mode not in ("minmax", "percentile"):
        raise MXNetError("calibration mode must be minmax|percentile, "
                         "got %r" % (mode,))
    feeds = list(feeds)
    if not feeds:
        raise MXNetError("calibrate: empty feed sample")
    internals = sym.get_internals()
    out_names = internals.list_outputs()
    shapes = dict(default_shapes or {})
    for k, v in feeds[0].items():
        shapes[k] = tuple(np.asarray(v).shape)
    with _trace.span("passes:calibrate", cat="passes",
                     batches=len(feeds), mode=mode):
        exe = internals.simple_bind(
            ctx if ctx is not None else current_context(),
            grad_req="null", **shapes)
        exe.copy_params_from(dict(arg_params), dict(aux_params or {}),
                             allow_extra_params=True)
        ranges: Dict[str, Tuple[float, float]] = {}
        for feed in feeds:
            for k, v in feed.items():
                if k in exe.arg_dict:
                    # lint: allow(decode-host-sync) — offline per-batch
                    # calibration sweep, not a decode loop; feeds arrive
                    # as host arrays
                    exe.arg_dict[k][:] = np.asarray(
                        v, dtype=exe.arg_dict[k].dtype)
            outs = exe.forward(is_train=False)
            for name, nd in zip(out_names, outs):
                t = nd._get()
                if not t.is_floating_point():
                    continue
                # lint: allow(decode-host-sync) — the pass's purpose is
                # pulling activations to host to histogram them
                _observe(ranges, name, t.float().cpu().numpy(), mode,
                         percentile)
    return CalibrationTable(ranges, mode=mode, percentile=percentile,
                            num_batches=len(feeds))
