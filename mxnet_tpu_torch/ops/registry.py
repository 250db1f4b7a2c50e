"""Operator registry: op metadata plus a forward function on tensors.

The counterpart of ``mxnet_tpu/ops/registry.py``.  The metadata (names,
parameter schemas with dmlc-style string parsing, shape and type rules,
argument names) is kept identical to the JAX package's, so a graph
serializes to the same symbol JSON in both packages.  ``forward`` takes
and returns ``torch.Tensor``s.

Gradients come from autograd through each op's torch body; an op whose
reference defines its own gradient (the loss layers) wraps its body in a
``torch.autograd.Function``.  A train-mode forward of an op with
auxiliary states returns ``(outputs, new_aux)``, as the reference does;
the executor commits the new states.
"""
from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError, _AttrDict

__all__ = ["Param", "OpDef", "register_op", "register_simple_op", "get_op",
           "list_ops", "OpContext"]

_OP_REGISTRY: Dict[str, "OpDef"] = {}


def _parse_shape(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    if isinstance(v, (int, np.integer)):
        return (int(v),)
    if isinstance(v, str):
        val = ast.literal_eval(v.strip())
        if isinstance(val, (int, float)):
            return (int(val),)
        return tuple(int(x) for x in val)
    raise ValueError("cannot parse shape from %r" % (v,))


def _parse_bool(v):
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return bool(v)


class Param:
    """One dmlc::Parameter field: typed, defaulted, documented, str-parseable."""

    def __init__(self, name: str, typ, default=None, required: bool = False,
                 doc: str = "", enum: Optional[Sequence[str]] = None):
        self.name = name
        self.typ = typ
        self.default = default
        self.required = required
        self.doc = doc
        self.enum = enum

    def parse(self, value):
        if value is None:
            return None
        if self.typ == "shape":
            return _parse_shape(value)
        if self.typ is bool:
            return _parse_bool(value)
        if self.typ is int:
            return int(float(value)) if isinstance(value, str) else int(value)
        if self.typ is float:
            return float(value)
        if self.typ is str:
            value = str(value)
            if self.enum and value not in self.enum:
                raise MXNetError("param %s expects one of %s, got %r"
                                 % (self.name, self.enum, value))
            return value
        return value

    def to_string(self, value) -> str:
        """Serialize for symbol JSON attrs."""
        if self.typ == "shape":
            return "(" + ", ".join(str(x) for x in value) + ")"
        if self.typ is bool:
            return "True" if value else "False"
        return str(value)


class OpContext:
    """Per-call execution context handed to forward: the train flag and
    the ``torch.Generator`` the ops that draw (``needs_rng``: Dropout,
    rrelu) take their numbers from.  The reference hands a jax PRNG key
    here instead.  ``dp`` is the data-parallel ``collectives.Axis`` a
    step runs under (None on one device): the ops that reduce over the
    batch axis (BatchNorm's statistics, the ``batch``/``valid``
    normalizations of the loss layers) reduce over it too, as GSPMD
    makes the JAX package's ops see the global batch."""

    def __init__(self, is_train: bool = False, generator=None, dp=None):
        self.is_train = is_train
        self.generator = generator
        self.dp = dp if dp is not None and dp.size > 1 else None


class OpDef:
    """Base class for op definitions.  Subclass and register with
    @register_op; override ``params``, ``list_arguments``,
    ``list_outputs``, ``list_auxiliary_states``, ``infer_shape``,
    ``infer_type`` and ``forward``."""

    params: List[Param] = []
    hint: Optional[str] = None
    needs_rng: bool = False
    # the op's backward ignores the incoming gradient (loss layers): an
    # omitted head gradient for its output is not an error
    head_grad_optional: bool = False
    # an op that takes a variable number of inputs (Concat) names the
    # parameter that counts them; the symbol constructor fills it in
    variable_args: Optional[str] = None

    def __init__(self, name: str):
        self.name = name

    # -- metadata -----------------------------------------------------------
    def parse_params(self, kwargs: Dict[str, Any]) -> _AttrDict:
        p = _AttrDict()
        schema = {x.name: x for x in self.params}
        for k, v in kwargs.items():
            if k not in schema:
                raise MXNetError("%s got unknown parameter %r (accepts: %s)"
                                 % (self.name, k, sorted(schema)))
            p[k] = schema[k].parse(v)
        for x in self.params:
            if x.name not in p:
                if x.required:
                    raise MXNetError("%s requires parameter %r"
                                     % (self.name, x.name))
                p[x.name] = x.parse(x.default) if x.default is not None \
                    else None
        return p

    def serialize_params(self, p) -> Dict[str, str]:
        out = {}
        for x in self.params:
            v = p.get(x.name)
            if v is not None:
                out[x.name] = x.to_string(v)
        return out

    def list_arguments(self, p) -> List[str]:
        return ["data"]

    def list_outputs(self, p) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self, p) -> List[str]:
        return []

    # -- inference ----------------------------------------------------------
    def infer_shape(self, p, in_shapes: List[Optional[Tuple[int, ...]]]):
        """Return (in_shapes, out_shapes, aux_shapes); None = unknown."""
        return in_shapes, [in_shapes[0]], []

    def infer_type(self, p, in_types: List[Optional[np.dtype]]):
        t = next((x for x in in_types if x is not None), np.dtype(np.float32))
        return [t] * len(in_types), [t] * len(self.list_outputs(p)), \
            [t] * len(self.list_auxiliary_states(p))

    # -- execution ----------------------------------------------------------
    def forward(self, p, inputs: List[Any], aux: List[Any], ctx: OpContext):
        """Return the list of output tensors, or ``(outputs, new_aux)``
        for a train-mode forward that updates auxiliary states."""
        raise NotImplementedError(self.name)


def register_op(name: str, hint: Optional[str] = None):
    def deco(cls):
        op = cls(name)
        if hint is not None:
            op.hint = hint
        elif op.hint is None:
            op.hint = name.lstrip("_").lower()
        _OP_REGISTRY[name] = op
        return cls
    return deco


def register_simple_op(name: str, fn, nin: int = 1, infer_shape=None,
                       hint: Optional[str] = None, needs_rng: bool = False,
                       params: Optional[List[Param]] = None) -> OpDef:
    """Register a function-backed op (the reference's ``register_simple_op``,
    its SimpleOp path): ``fn(p, *inputs)`` -> one tensor, or
    ``fn(p, *inputs, generator=...)`` for an op that draws.  Arguments are
    ``data`` (one input), ``lhs``/``rhs`` (two) or ``arg0..`` (none or
    more); without ``infer_shape`` every input and the output share the
    first known input's shape."""

    class _SimpleOp(OpDef):
        pass

    _SimpleOp.params = params or []
    _SimpleOp.needs_rng = needs_rng
    op = _SimpleOp(name)
    op.hint = hint or name.lstrip("_").lower()

    def list_arguments(p, _n=nin):
        if _n == 1:
            return ["data"]
        if _n == 2:
            return ["lhs", "rhs"]
        return ["arg%d" % i for i in range(_n)]
    op.list_arguments = list_arguments

    if infer_shape is not None:
        op.infer_shape = infer_shape
    else:
        def _default_is(p, in_shapes, _n=nin):
            if _n == 2:
                d = in_shapes[0] if in_shapes[0] is not None \
                    else in_shapes[1]
                return [d, d], [d], []
            return in_shapes, [in_shapes[0]], []
        op.infer_shape = _default_is

    def forward(p, inputs, aux, ctx):
        if needs_rng:
            return [fn(p, *inputs, generator=ctx.generator)]
        return [fn(p, *inputs)]
    op.forward = forward
    _OP_REGISTRY[name] = op
    return op


def get_op(name: str) -> OpDef:
    if name not in _OP_REGISTRY:
        raise MXNetError("operator %r is not registered in the port (have "
                         "%s)" % (name, sorted(_OP_REGISTRY)))
    return _OP_REGISTRY[name]


def list_ops() -> List[str]:
    return sorted(_OP_REGISTRY)
