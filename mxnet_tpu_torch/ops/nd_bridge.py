"""Dual registration: every registered op without auxiliary states as an
imperative ``mx.nd.<op>`` (counterpart of ``mxnet_tpu/ops/nd_bridge.py``,
the reference's SimpleOp path that serves ``mx.nd.*`` and ``mx.sym.*``
from one registration).  Inputs are NDArrays, parameters keyword
arguments; the op's torch body runs at once, an op that draws taking
its numbers from the generator of the inputs' device (else the current
context's)."""
from __future__ import annotations

from ..base import MXNetError
from ..context import current_context
from .. import ndarray as nd_mod
from ..engine import track as _track
from .. import random as _random
from .registry import OpContext, get_op, list_ops


def _make_nd_fn(op_name: str):
    def nd_fn(*args, **kwargs):
        op = get_op(op_name)
        inputs = [a for a in args if isinstance(a, nd_mod.NDArray)]
        out = kwargs.pop("out", None)
        if op.variable_args is not None and op.variable_args not in kwargs:
            kwargs[op.variable_args] = len(inputs)
        p = op.parse_params(kwargs)
        nargs = len(op.list_arguments(p))
        if len(inputs) != nargs:
            raise MXNetError("%s expects %d NDArray inputs, got %d"
                             % (op_name, nargs, len(inputs)))
        gen = None
        if op.needs_rng:
            gen = _random.generator(inputs[0]._get().device if inputs
                                    else current_context())
        res = op.forward(p, [x._get() for x in inputs], [],
                         OpContext(is_train=False, generator=gen))
        if isinstance(res, tuple):
            res = res[0]
        outs = [nd_mod.NDArray(o) for o in _track(res)]
        if out is not None:
            outs[0].copyto(out)
            return out
        return outs[0] if len(outs) == 1 else outs
    nd_fn.__name__ = op_name
    nd_fn.__doc__ = "Imperative form of operator %s." % op_name
    return nd_fn


def register_all() -> None:
    """Attach an imperative wrapper to ``ndarray`` for every aux-free op
    that has no hand-written function of its name (dot, sum, clip ...)."""
    for name in list_ops():
        op = get_op(name)
        try:
            if op.list_auxiliary_states(op.parse_params({})):
                continue   # stateful ops (BatchNorm ...) need an executor
        except MXNetError:
            pass   # required params block introspection: aux-free ops
        if hasattr(nd_mod, name):
            continue
        nd_mod.register_ndarray_fn(name, _make_nd_fn(name))
