"""Python custom operators: all three reference generations.

The counterpart of ``mxnet_tpu/operator.py``: ``PythonOp``/``NumpyOp``
(forward and backward on numpy arrays), ``NDArrayOp`` (the same bridge
with the NDArray-flavoured override points), ``CustomOp``/
``CustomOpProp`` + ``register`` (used as ``sym.Custom(op_type=...)``),
and the ``_Native``/``_NDArray`` symbol ops, which only report the path.

Where the JAX package wraps the user's code in ``jax.pure_callback`` +
``jax.custom_vjp``, the port calls it from a ``torch.autograd.Function``
(:class:`_PythonBridge`): its forward runs the user's forward, its
backward the user's backward, on the tensors the graph walk hands it.
``NumpyOp`` and ``NDArrayOp`` give the user numpy copies and put the
results back on the op's device; ``CustomOp`` gives the user the port's
``NDArray``s on the op's own device (the card included), so nothing
crosses to the host that the user's code does not ask for.  The user's
code runs under the op's device as the current context, so
``mx.nd.array(y)`` inside it lands beside the op's tensors.

These ops run Python on the host, so they carry ``host_op``: the fused
train step runs a graph that holds one eagerly, every step, where it
would otherwise capture a CUDA graph (a capture would run the Python
once, at capture).
"""
from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np
import torch

from .base import MXNetError
from .context import context_of
from .ndarray import NDArray
from .ops.registry import OpDef, Param, register_op
from . import symbol as _symbol

__all__ = ["PythonOp", "NumpyOp", "NDArrayOp", "CustomOp", "CustomOpProp",
           "register", "get_all_registered_operators"]

_CUSTOM_REGISTRY: Dict[str, type] = {}


class _PythonBridge(torch.autograd.Function):
    """``outs = run_fwd(inputs)``; the backward is
    ``run_bwd(inputs, outs, out_grads)`` -> one gradient per input.  The
    inputs and outputs are kept for backward, as the reference's
    ``custom_vjp`` keeps them as residuals."""

    @staticmethod
    def forward(ctx, run_fwd, run_bwd, n_in, *inputs):
        outs = run_fwd(inputs)
        ctx.save_for_backward(*inputs, *outs)
        ctx.run_bwd = run_bwd
        ctx.n_in = n_in
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        grads = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, outs)]
        in_grads = ctx.run_bwd(ins, outs, grads)
        return (None, None, None) + tuple(
            g if need else None
            for g, need in zip(in_grads, ctx.needs_input_grad[3:]))


def _bridge(inputs, run_fwd, run_bwd) -> List[torch.Tensor]:
    """Run the user's forward through :class:`_PythonBridge`, under the
    inputs' device as the current context."""
    dev = inputs[0].device if inputs else torch.device("cpu")

    def fwd(ins):
        with context_of(dev):
            return run_fwd(ins)

    def bwd(ins, outs, grads):
        with context_of(dev):
            return run_bwd(ins, outs, grads)
    return list(_PythonBridge.apply(fwd, bwd, len(inputs), *inputs))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


class PythonOp:
    """Base class for Python-side ops (reference operator.py:20-122)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def get_symbol(self, *args, **kwargs):
        raise NotImplementedError("Must override this")

    def __call__(self, *args, **kwargs):
        # reference ops are applied by calling the instance
        # (operator.py: __call__ = get_symbol)
        return self.get_symbol(*args, **kwargs)

    def forward(self, in_data, out_data):
        raise NotImplementedError("Must override this")

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError("Must override this")

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_


class NumpyOp(PythonOp):
    """Numpy op (reference operator.py:122-222): define forward and
    backward on numpy arrays; ``get_symbol()`` returns a Symbol whose
    forward hands the user host copies and puts the results back on the
    op's device."""

    def get_symbol(self, *args, **kwargs):
        op_ref = self

        class _NumpyOpDef(OpDef):
            needs_rng = False
            host_op = True

            def list_arguments(self, p):
                return op_ref.list_arguments()

            def list_outputs(self, p):
                return op_ref.list_outputs()

            def infer_shape(self, p, in_shapes):
                if in_shapes[0] is None:
                    return in_shapes, [None] * len(op_ref.list_outputs()), []
                # secondary inputs (labels) may be unknown: the op's own
                # infer_shape derives them from the data shape.  Only that
                # partial-shape case is lenient; a raise with every shape
                # known is a user bug and propagates.
                partial = any(s is None for s in in_shapes[1:])
                shapes_arg = [list(s) if s is not None else None
                              for s in in_shapes]
                if partial:
                    try:
                        ins, outs = op_ref.infer_shape(shapes_arg)
                    except (TypeError, ValueError, IndexError,
                            AttributeError) as e:
                        logging.debug(
                            "NumpyOp %s.infer_shape deferred on partial "
                            "shapes (%s); retrying when known", op_name, e)
                        return (in_shapes,
                                [None] * len(op_ref.list_outputs()), [])
                else:
                    ins, outs = op_ref.infer_shape(shapes_arg)
                return ([tuple(s) for s in ins], [tuple(s) for s in outs], [])

            def forward(self, p, inputs, aux, ctx):
                in_shapes = [tuple(x.shape) for x in inputs]
                _, out_shapes = op_ref.infer_shape([list(s) for s in in_shapes])
                out_shapes = [tuple(s) for s in out_shapes]

                def run_fwd(ins):
                    outs = [np.zeros(s, dtype=np.float32) for s in out_shapes]
                    op_ref.forward(in_data=[_host(x) for x in ins],
                                   out_data=outs)
                    return [torch.from_numpy(o).to(ins[0].device)
                            for o in outs]

                def run_bwd(ins, outs, grads):
                    in_grads = [np.zeros(s, dtype=np.float32)
                                for s in in_shapes]
                    op_ref.backward(out_grad=[_host(g) for g in grads],
                                    in_data=[_host(x) for x in ins],
                                    out_data=[_host(o) for o in outs],
                                    in_grad=in_grads)
                    return [torch.from_numpy(g).to(ins[0].device)
                            for g in in_grads]
                return _bridge(list(inputs), run_fwd, run_bwd)

        name = kwargs.pop("name", None)
        op_name = "_numpy_op_%d" % id(self)
        cls = type("_NumpyOp_%d" % id(self), (_NumpyOpDef,), {})
        register_op(op_name, hint="numpyop")(cls)
        input_syms = [a for a in args if isinstance(a, _symbol.Symbol)]
        sym_kwargs = {k: v for k, v in kwargs.items()
                      if isinstance(v, _symbol.Symbol)}
        return _symbol._create(op_name, input_syms, name=name, **sym_kwargs)


class NDArrayOp(NumpyOp):
    """NDArray custom op (reference operator.py:222+).  It shares the
    NumpyOp bridge, as the JAX package's does, keeping the NDArray-
    flavoured override points: ``forward``/``backward`` receive numpy
    arrays, and may push them through ``mx.nd.array`` and ``mx.rtc``."""

    def forward(self, in_data, out_data):
        raise NotImplementedError("Must override this")

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError("Must override this")


class CustomOp:
    """Newest-generation custom op (reference operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src


class CustomOpProp:
    """Property class for CustomOp (reference operator.py CustomOpProp)."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad
        self.kwargs: Dict[str, str] = {}

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """The tensors backward depends on (reference operator.py:~540).
        The graph walk keeps every input and output for backward whatever
        this returns, as the JAX package's does; the hook is kept for the
        user surface."""
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError()


def register(reg_name: str):
    """Register a CustomOpProp subclass under
    ``sym.Custom(op_type=reg_name)`` (reference operator.py register)."""
    def do_register(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered_operators():
    return sorted(_CUSTOM_REGISTRY)


@register_op("_NDArray", hint="ndarrayop")
class _NDArrayShimOp(OpDef):
    """reference ndarray_op-inl.h: the handle-passing symbol of NDArrayOp.
    ``NDArrayOp.get_symbol`` registers an op per instance instead (no raw
    pointers across an ABI), so this shim only reports the path."""
    params = [Param("info", str, default="")]

    def forward(self, p, inputs, aux, ctx):
        raise MXNetError("_NDArray pointer-passing is not used in the TPU "
                         "build; construct the symbol via NDArrayOp.get_symbol")


@register_op("_Native", hint="nativeop")
class _NativeShimOp(_NDArrayShimOp):
    """reference native_op-inl.h: see the _NDArray shim; use
    NumpyOp.get_symbol."""

    def forward(self, p, inputs, aux, ctx):
        raise MXNetError("_Native pointer-passing is not used in the TPU "
                         "build; construct the symbol via NumpyOp.get_symbol")


@register_op("Custom", hint="custom")
class CustomSymbolOp(OpDef):
    """``sym.Custom(..., op_type='name')`` (reference custom-inl.h:211).
    Extra kwargs beyond op_type reach the prop's constructor as strings
    (the reference keeps them as the kwargs_ vector handed to the
    creator)."""
    params = [Param("op_type", str, required=True)]
    allow_extra_params = True
    host_op = True

    def _prop(self, p) -> CustomOpProp:
        if p.op_type not in _CUSTOM_REGISTRY:
            raise MXNetError("custom op %r not registered (have %s)"
                             % (p.op_type, get_all_registered_operators()))
        return _CUSTOM_REGISTRY[p.op_type](**(p.get("_extras") or {}))

    def list_arguments(self, p):
        return self._prop(p).list_arguments()

    def list_outputs(self, p):
        return self._prop(p).list_outputs()

    def list_auxiliary_states(self, p):
        return self._prop(p).list_auxiliary_states()

    def infer_shape(self, p, in_shapes):
        if any(s is None for s in in_shapes):
            return in_shapes, [None] * len(self.list_outputs(p)), []
        prop = self._prop(p)
        res = prop.infer_shape([list(s) for s in in_shapes])
        ins, outs = res[0], res[1]
        aux = res[2] if len(res) > 2 else []
        return ([tuple(s) for s in ins], [tuple(s) for s in outs],
                [tuple(s) for s in aux])

    def forward(self, p, inputs, aux, ctx):
        prop = self._prop(p)
        in_shapes = [tuple(x.shape) for x in inputs]
        res = prop.infer_shape([list(s) for s in in_shapes])
        out_shapes = [tuple(s) for s in res[1]]
        op = prop.create_operator(None, in_shapes,
                                  [np.float32] * len(in_shapes))
        is_train = ctx.is_train

        def nd(t):
            return NDArray(t.detach())

        def run_fwd(ins):
            dev = ins[0].device
            outs = [torch.zeros(s, dtype=torch.float32, device=dev)
                    for s in out_shapes]
            op.forward(is_train=is_train, req=["write"] * len(outs),
                       in_data=[nd(x) for x in ins],
                       out_data=[NDArray(o) for o in outs], aux=[])
            return outs

        def run_bwd(ins, outs, grads):
            dev = ins[0].device
            in_grads = [torch.zeros(s, dtype=torch.float32, device=dev)
                        for s in in_shapes]
            op.backward(req=["write"] * len(in_grads),
                        out_grad=[nd(g) for g in grads],
                        in_data=[nd(x) for x in ins],
                        out_data=[nd(o) for o in outs],
                        in_grad=[NDArray(g) for g in in_grads], aux=[])
            return in_grads
        return _bridge(list(inputs), run_fwd, run_bwd)
