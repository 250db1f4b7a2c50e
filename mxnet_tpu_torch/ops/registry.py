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

Sharded state (tensor parallelism): under a mesh the graph walk hands
each op its inputs' layouts (``parallel.mesh.Layout``; None is
replicated) and calls ``forward_layout``, which returns the outputs and
their layouts.  The default rule brings every input to replicated at
the op's entry (``to_replicated``: an all-gather for a shard, an
all-reduce for a partial sum) and runs ``forward``, so an op without a
rule of its own computes what it computes on one device.  An op with
``keeps_layout`` (the unary elementwise ops: any dim; Pooling: the
channel dim) runs on the shard it is given.  The rules of
FullyConnected, ``_fused_FullyConnected``, Convolution, Dropout,
Flatten, Reshape and ``_moe_expert_ffn`` live with the ops.  Every
redistribution is counted per op in ``parallel.collectives.STATS``.

Data parallelism: the walk also hands each op which inputs hold this
rank's rows of a batch cut over ``dp`` (``OpContext.in_rows``; an op's
``row_dim`` says where its output keeps them).  An op that draws
(``needs_rng``) draws through ``OpContext.draw``: the global batch's
numbers, this rank's rows kept, so the ranks draw what one device does.
"""
from __future__ import annotations

import ast
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, _AttrDict

__all__ = ["Param", "OpDef", "register_op", "register_simple_op", "get_op",
           "list_ops", "OpContext", "to_replicated", "to_shard",
           "enter_parallel"]

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

    def __init__(self, is_train: bool = False, generator=None, dp=None,
                 mesh=None):
        self.is_train = is_train
        self.generator = generator
        # a DrawTape while a checkpointed region runs (executor.checkpointed)
        self.tape = None
        self.dp = dp if dp is not None and dp.size > 1 else None
        # the mesh of a sharded walk (None: every value is replicated)
        self.mesh = mesh
        # per input of the op being run: Layout.shard(dim, "dp") when the
        # value is this rank's rows of a batch cut over ``dp``, else None
        # (set by the graph walk before each op)
        self.in_rows = ()

    def axis(self, name: str):
        """This rank's ``collectives.Axis`` of the walk's mesh."""
        return self.mesh.axis(name)

    def row_cuts(self, i: int = 0) -> List[Tuple[int, Any]]:
        """``[(dim, dp Axis)]`` when input ``i`` holds this rank's rows of
        a batch cut over ``dp``, else ``[]``."""
        lay = self.in_rows[i] if i < len(self.in_rows) else None
        return [] if lay is None or self.dp is None else [(lay.dim, self.dp)]

    def draw(self, fn, shape, cuts=()):
        """Random numbers for a value of local ``shape`` cut by ``cuts``
        (``[(dim, Axis)]``), as one device draws them for the whole
        value: ``fn(whole shape)`` draws the whole (the same numbers on
        every rank, the generators being in one state) and this rank's
        part is kept.  Without cuts, ``fn(shape)``.  Inside a checkpointed
        region (``tape`` set) the first run records each draw and the
        recompute replays them, so the generator advances once and the
        recompute sees the same numbers."""
        tape = self.tape
        if tape is not None and tape.recorded:
            return tape.replay()
        whole = list(shape)
        for d, ax in cuts:
            whole[d] *= ax.size
        u = fn(tuple(whole))
        for d, ax in cuts:
            n = shape[d]
            u = u.narrow(d, ax.index * n, n)
        if tape is not None:
            tape.record(u)
        return u


def to_replicated(x, lay, ctx: OpContext, op: str):
    """``x`` of layout ``lay`` made whole on every rank: an all-gather of
    a shard, an all-reduce of a partial sum, counted against ``op``."""
    if lay is None:
        return x
    from ..parallel import collectives as C
    ax = ctx.axis(lay.axis)
    if lay.partial:
        C.note_redistribution(op, "all_reduce")
        return C.all_reduce(x, ax)
    C.note_redistribution(op, "all_gather")
    return C.all_gather(x.contiguous(), ax, lay.dim)


def to_shard(x, lay, dim: int, axis: str, ctx: OpContext, op: str):
    """``x`` of layout ``lay`` brought to ``Layout.shard(dim, axis)``:
    as it is when it already is, else made whole and narrowed."""
    from ..parallel import collectives as C
    from ..parallel.mesh import Layout
    if lay == Layout.shard(dim, axis):
        return x
    x = to_replicated(x, lay, ctx, op)
    C.note_redistribution(op, "narrow")
    return C.narrow(x, ctx.axis(axis), dim)


def enter_parallel(x, lay, axis: str, ctx: OpContext, op: str):
    """A replicated ``x`` as the input of per-rank work over ``axis``
    whose input gradients are summands (``collectives.enter_parallel``:
    the backward sums them)."""
    from ..parallel import collectives as C
    x = to_replicated(x, lay, ctx, op)
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    C.note_redistribution(op, "all_reduce_backward")
    return C.enter_parallel(x, ctx.axis(axis))


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
    # the input shard dims a one-input op computes on as they are
    # ("any", or a tuple of dims); None: the default layout rule
    keeps_layout = None

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

    def row_dim(self, p, dim: int, ndim: int) -> Optional[int]:
        """The dim of an output that holds the batch rows ``dim`` of the
        op's input (``ndim`` the output's rank): the same dim (checked
        against the output's size by the walk), unless the op moves it."""
        return dim if dim < ndim else None

    def forward_layout(self, p, inputs: List[Any], layouts: List[Any],
                       aux: List[Any], ctx: OpContext):
        """The forward under a mesh: -> ``(forward's result, output
        layouts or None for all replicated)``.  Default: every input made
        replicated first, unless the op keeps the one shard it is
        given."""
        keep = self.keeps_layout
        if keep is not None and len(inputs) == 1 and layouts[0] is not None \
                and not layouts[0].partial \
                and (keep == "any" or layouts[0].dim in keep):
            res = self.forward(p, inputs, aux, ctx)
            outs = res[0] if isinstance(res, tuple) else res
            return res, [layouts[0]] * len(outs)
        ins = [to_replicated(x, lay, ctx, self.name)
               for x, lay in zip(inputs, layouts)]
        return self.forward(p, ins, aux, ctx), None


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
            # through ctx.draw, so a checkpointed region's tape replays it
            return [ctx.draw(lambda _s: fn(p, *inputs,
                                          generator=ctx.generator), ())]
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
