"""Tensor ops (counterpart of ``mxnet_tpu/ops/tensor.py``): the
elementwise, scalar, unary, broadcast, reduction, matrix and shaping
family, the two losses, the samplers, and the structural ops
(``Reshape``, ``SliceChannel``, ``Embedding``, ``Crop`` ...).

Names, parameter schemas and shape rules are the reference's.  Gradients
come from autograd, except where the reference's differ from PyTorch's:
``abs`` at 0 (JAX gives 1, ``torch.abs`` 0) and ``_maximum_scalar``/
``_minimum_scalar`` at a tie (JAX splits the gradient, ``clamp`` does
not).  ``_sparse_embedding`` is the deduped lookup of ``embed/sparse.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import numpy_dtype, torch_dtype
from .registry import OpDef, Param, register_op, register_simple_op


class _Abs(torch.autograd.Function):
    """|x| with the reference's gradient: +1 at 0 (``x >= 0``), -1 below."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x: torch.Tensor) -> torch.Tensor:
    return _Abs.apply(x) if x.requires_grad else torch.abs(x)


# ---------------------------------------------------------------------------
# elementwise binary (reference elementwise_binary_op-inl.h:257)

def _binary_shape(p, in_shapes):
    d = in_shapes[0] if in_shapes[0] is not None else in_shapes[1]
    return [d, d], [d], []


# torch.maximum/minimum split the gradient at a tie, as jnp's do
_BINARY = [("_plus", torch.add), ("_minus", torch.sub),
           ("_mul", torch.mul), ("_div", torch.div),
           ("_power", torch.pow), ("_maximum", torch.maximum),
           ("_minimum", torch.minimum)]
for _name, _fn in _BINARY:
    register_simple_op(_name, (lambda f: lambda p, a, b: f(a, b))(_fn),
                       nin=2, infer_shape=_binary_shape)


# ---------------------------------------------------------------------------
# scalar and reverse-scalar forms (elementwise_binary_scalar_op-inl.h:262)

def scalar_of(p) -> float:
    """The op's scalar rounded to float32 first, as the reference's weak
    python scalar is and as ``_fused_elemwise`` (``fused.apply_steps``)
    rounds it, so a fused chain and its unfused nodes give the same
    bits."""
    return float(np.float32(p.scalar))


def _full(x, s):
    """``s`` as a 0-d tensor of x's dtype on x's device (a fill, which a
    CUDA graph capture records)."""
    return torch.full((), s, dtype=x.dtype, device=x.device)


_SCALAR = [
    ("_plus_scalar", lambda x, s: x + s),
    ("_minus_scalar", lambda x, s: x - s),
    ("_rminus_scalar", lambda x, s: s - x),
    ("_mul_scalar", lambda x, s: x * s),
    ("_div_scalar", lambda x, s: x / s),
    ("_rdiv_scalar", lambda x, s: s / x),
    ("_power_scalar", lambda x, s: torch.pow(x, s)),
    ("_rpower_scalar", lambda x, s: torch.pow(s, x)),
    ("_maximum_scalar", lambda x, s: torch.maximum(x, _full(x, s))),
    ("_minimum_scalar", lambda x, s: torch.minimum(x, _full(x, s)))]
for _name, _fn in _SCALAR:
    register_simple_op(
        _name, (lambda f: lambda p, a: f(a, scalar_of(p)))(_fn), nin=1,
        params=[Param("scalar", float, required=True)]).keeps_layout = "any"


# ---------------------------------------------------------------------------
# elementwise unary, each under its name and with a leading "_"
# (reference elementwise_unary_op-inl.h:144, mshadow_op.h)

_UNARY = [("abs", abs_), ("ceil", torch.ceil), ("cos", torch.cos),
          ("exp", torch.exp), ("floor", torch.floor), ("log", torch.log),
          ("round", torch.round), ("rsqrt", torch.rsqrt),
          ("sign", torch.sign), ("sin", torch.sin), ("sqrt", torch.sqrt),
          ("square", torch.square)]
for _name, _fn in _UNARY:
    for _n in (_name, "_" + _name):
        register_simple_op(_n, (lambda f: lambda p, a: f(a))(_fn),
                           nin=1).keeps_layout = "any"


# ---------------------------------------------------------------------------
# broadcast family (reference elementwise_binary_broadcast_op-inl.h:549)

def _bcast_shape(p, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [a if a is not None else b], []
    if len(a) != len(b):
        raise MXNetError("broadcast inputs need same ndim: %s vs %s" % (a, b))
    out = []
    for x, y in zip(a, b):
        if x == y or y == 1:
            out.append(x)
        elif x == 1:
            out.append(y)
        else:
            raise MXNetError("broadcast shape mismatch %s vs %s" % (a, b))
    return [a, b], [tuple(out)], []


for _name, _fn in [("broadcast_plus", torch.add),
                   ("broadcast_minus", torch.sub),
                   ("broadcast_mul", torch.mul),
                   ("broadcast_div", torch.div),
                   ("broadcast_power", torch.pow)]:
    register_simple_op(_name, (lambda f: lambda p, a, b: f(a, b))(_fn),
                       nin=2, infer_shape=_bcast_shape)


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def _broadcast_axis_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    out = list(d)
    for ax, sz in zip(_as_tuple(p.axis), _as_tuple(p.size)):
        if out[ax] != 1:
            raise MXNetError("broadcast_axis: input dim %d must be 1" % ax)
        out[ax] = sz
    return [d], [tuple(out)], []


def _broadcast_axis(p, a):
    out = list(a.shape)
    for ax, sz in zip(_as_tuple(p.axis), _as_tuple(p.size)):
        out[ax] = sz
    # materialized, as jnp.broadcast_to's result is
    return a.expand(out).contiguous()


register_simple_op("broadcast_axis", _broadcast_axis, nin=1,
                   infer_shape=_broadcast_axis_shape,
                   params=[Param("axis", "shape", default=()),
                           Param("size", "shape", default=())])


def _broadcast_to_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    tgt = list(p.shape)
    for i, (x, y) in enumerate(zip(d, tgt)):
        if y == 0:
            tgt[i] = x
        elif x != y and x != 1:
            raise MXNetError("cannot broadcast %s to %s" % (d, p.shape))
    return [d], [tuple(tgt)], []


def _broadcast_to(p, a):
    tgt = [x if y == 0 else y for x, y in zip(a.shape, p.shape)]
    return a.expand(tgt).contiguous()


register_simple_op("broadcast_to", _broadcast_to, nin=1,
                   infer_shape=_broadcast_to_shape,
                   params=[Param("shape", "shape", required=True)])


# ---------------------------------------------------------------------------
# reductions (reference broadcast_reduce_op-inl.h:491); max and min split
# the gradient among tied maxima, as jnp.max does (torch.amax, not max)

def _reduce_all_shape(p, in_shapes):
    return in_shapes, [(1,)], []


def _reduce_axis_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    axes = _as_tuple(p.axis)
    if p.keepdims:
        out = tuple(1 if i in axes else x for i, x in enumerate(d))
    else:
        out = tuple(x for i, x in enumerate(d) if i not in axes)
        if out == ():
            out = (1,)
    return [d], [out], []


def _axis_reduce(fn):
    def run(p, a):
        axes = _as_tuple(p.axis)
        if not axes:            # jnp reduces over no axis: the identity
            return a
        return fn(a, dim=axes, keepdim=p.keepdims)
    return run


for _name, _fn in [("sum", torch.sum), ("max", torch.amax),
                   ("min", torch.amin)]:
    register_simple_op(_name, (lambda f: lambda p, a: f(a).reshape(1))(_fn),
                       nin=1, infer_shape=_reduce_all_shape)
    register_simple_op(_name + "_axis", _axis_reduce(_fn), nin=1,
                       infer_shape=_reduce_axis_shape,
                       params=[Param("axis", "shape", default=(0,)),
                               Param("keepdims", bool, default=False)])

register_simple_op(
    "norm", lambda p, a: torch.sqrt(torch.sum(torch.square(a))).reshape(1),
    nin=1, infer_shape=_reduce_all_shape)


def _argmax_channel_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    return [d], [(d[0],)], []


register_simple_op("argmax_channel",
                   lambda p, a: torch.argmax(a, dim=1).to(a.dtype),
                   nin=1, infer_shape=_argmax_channel_shape)


# ---------------------------------------------------------------------------
# matrix ops (reference matrix_op-inl.h:680)

def _dot_shape(p, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    if len(a) == 2 and len(b) == 2:
        return [a, b], [(a[0], b[1])], []
    if len(a) == 1 and len(b) == 1:
        return [a, b], [(1,)], []
    if len(a) == 2 and len(b) == 1:
        return [a, b], [(a[0],)], []
    raise MXNetError("dot shape mismatch %s %s" % (a, b))


def _dot(p, a, b):
    out = torch.matmul(a, b)
    return out.reshape(1) if out.dim() == 0 else out


register_simple_op("dot", _dot, nin=2, infer_shape=_dot_shape)


def _batch_dot_shape(p, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    return [a, b], [(a[0], a[1], b[2])], []


register_simple_op("batch_dot", lambda p, a, b: torch.matmul(a, b),
                   nin=2, infer_shape=_batch_dot_shape)


def _transpose_axes(p, ndim):
    return p.axes if p.axes else tuple(reversed(range(ndim)))


def _transpose_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    return [d], [tuple(d[a] for a in _transpose_axes(p, len(d)))], []


# materialized, as jnp.transpose is: a permuted view would send the next
# convolution down another algorithm than a dense input
_TRANSPOSE = register_simple_op(
    "transpose",
    lambda p, a: a.permute(*_transpose_axes(p, a.dim())).contiguous(),
    nin=1, infer_shape=_transpose_shape,
    params=[Param("axes", "shape", default=())])
_TRANSPOSE.row_dim = lambda p, dim, ndim: list(
    _transpose_axes(p, ndim)).index(dim)


def _expand_dims_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    out = list(d)
    out.insert(p.axis, 1)
    return [d], [tuple(out)], []


register_simple_op("expand_dims", lambda p, a: a.unsqueeze(p.axis),
                   nin=1, infer_shape=_expand_dims_shape,
                   params=[Param("axis", int, required=True)])


def _slice_bounds(p, n):
    end = p.end if p.end is not None and p.end != 0 else n
    if end < 0:
        end += n
    begin = p.begin if p.begin >= 0 else p.begin + n
    return begin, end


def _slice_axis_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    out = list(d)
    begin, end = _slice_bounds(p, d[p.axis])
    out[p.axis] = end - begin
    return [d], [tuple(out)], []


def _slice_axis(p, a):
    begin, end = _slice_bounds(p, a.shape[p.axis])
    return a.narrow(p.axis, begin, end - begin)


register_simple_op("slice_axis", _slice_axis, nin=1,
                   infer_shape=_slice_axis_shape,
                   params=[Param("axis", int, required=True),
                           Param("begin", int, default=0),
                           Param("end", int, default=0)])

register_simple_op("flip", lambda p, a: torch.flip(a, dims=(p.axis,)),
                   nin=1, params=[Param("axis", int, required=True)])


def _crop_bounds(p, shape):
    begin = p.begin if p.begin else (0,) * len(shape)
    end = p.end if p.end else tuple(shape)
    return begin, end


def _crop_simple_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    begin, end = _crop_bounds(p, d)
    return [d], [tuple(e - b for b, e in zip(begin, end))], []


def _crop_simple(p, a):
    begin, end = _crop_bounds(p, a.shape)
    return a[tuple(slice(b, e) for b, e in zip(begin, end))]


# lowercase crop: the general slice (reference matrix_op-inl.h crop
# SimpleOp, distinct from the Crop layer)
register_simple_op("crop", _crop_simple, nin=1,
                   infer_shape=_crop_simple_shape,
                   params=[Param("begin", "shape", default=()),
                           Param("end", "shape", default=())])


# ---------------------------------------------------------------------------
# losses (reference loss_binary_op-inl.h:110, smooth_l1_unary-inl.h:115)

def _softmax_cross_entropy(p, data, label):
    """-sum(log softmax(data)[i, label[i]]), shape (1,)."""
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, label.long()[:, None])
    return -torch.sum(picked).reshape(1)


register_simple_op("softmax_cross_entropy", _softmax_cross_entropy, nin=2,
                   infer_shape=lambda p, s: (s, [(1,)], []))


def _smooth_l1(p, a):
    sigma2 = p.sigma * p.sigma
    return torch.where(abs_(a) < 1.0 / sigma2,
                       0.5 * sigma2 * torch.square(a),
                       abs_(a) - 0.5 / sigma2)


register_simple_op("smooth_l1", _smooth_l1, nin=1,
                   params=[Param("sigma", float, default=1.0)])


# ---------------------------------------------------------------------------
# sampling (reference sample_op-inl.h:112): drawn from the op context's
# generator, on its device (Philox on the card, not the reference's
# threefry: the same law, other numbers)

def _sample_uniform(p, generator=None):
    u = torch.rand(tuple(p.shape), generator=generator,
                   device=generator.device)
    return p.low + (p.high - p.low) * u


def _sample_normal(p, generator=None):
    z = torch.randn(tuple(p.shape), generator=generator,
                    device=generator.device)
    return p.loc + p.scale * z


# the samplers take no input: their value is cut over no axis, and every
# rank draws one device's numbers of the given shape
for _name, _fn, _params in [
        ("_sample_uniform", _sample_uniform,
         [Param("low", float, default=0.0), Param("high", float, default=1.0)]),
        ("_sample_normal", _sample_normal,
         [Param("loc", float, default=0.0),
          Param("scale", float, default=1.0)])]:
    register_simple_op(_name, _fn, nin=0, needs_rng=True,
                       infer_shape=lambda p, s: ([], [tuple(p.shape)], []),
                       params=_params + [Param("shape", "shape",
                                               required=True)])


# ---------------------------------------------------------------------------
# structural ops

@register_op("Reshape", hint="reshape")
class ReshapeOp(OpDef):
    """reference reshape-inl.h:370: ``shape`` (else ``target_shape``),
    0 copies the input's dim, -1 is inferred, ``keep_highest`` keeps dim
    0."""
    params = [Param("target_shape", "shape", default=None),
              Param("shape", "shape", default=None),
              Param("keep_highest", bool, default=False)]

    def _target(self, p, in_shape):
        tgt = p.shape if p.shape else p.target_shape
        if tgt is None:
            raise MXNetError("Reshape needs shape")
        tgt = list(tgt)
        size = int(np.prod(in_shape))
        if p.keep_highest:
            tgt[0] = in_shape[0]
        for i, x in enumerate(tgt):
            if x == 0:
                tgt[i] = in_shape[i]
        if -1 in tgt:
            known = int(np.prod([x for x in tgt if x != -1]))
            tgt[tgt.index(-1)] = size // known
        return tuple(tgt)

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d], [self._target(p, d)], []

    def forward(self, p, inputs, aux, ctx):
        return [inputs[0].reshape(self._target(p, tuple(inputs[0].shape)))]

    def forward_layout(self, p, inputs, layouts, aux, ctx):
        """A shard on dim d stays one when the target keeps every dim up
        to d: each rank reshapes its slice to the target with dim d cut."""
        lay = layouts[0]
        if lay is not None and not lay.partial:
            n = ctx.axis(lay.axis).size
            shape = list(inputs[0].shape)
            shape[lay.dim] *= n
            out = list(self._target(p, tuple(shape)))
            d = lay.dim
            if len(out) > d and out[:d + 1] == shape[:d + 1]:
                out[d] //= n
                return [inputs[0].reshape(out)], [lay]
        return super().forward_layout(p, inputs, layouts, aux, ctx)


@register_op("Flatten", hint="flatten")
class FlattenOp(OpDef):
    """(N, ...) -> (N, prod)."""
    # a shard of dim 1 is a contiguous block of the flattened features
    keeps_layout = (1,)

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d], [(d[0], int(np.prod(d[1:])))], []

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]


@register_op("Cast", hint="cast")
class CastOp(OpDef):
    """Cast to ``dtype`` (64-bit types narrowed to 32 bits, as the
    reference's arrays are with jax's 64-bit types off)."""
    params = [Param("dtype", str, required=True,
                    enum=["float16", "float32", "float64", "bfloat16",
                          "uint8", "int32", "int64"])]

    def infer_type(self, p, in_types):
        out = numpy_dtype(torch.bfloat16) if p.dtype == "bfloat16" \
            else np.dtype(p.dtype)
        return in_types, [out], []

    def forward(self, p, inputs, aux, ctx):
        return [inputs[0].to(torch_dtype(p.dtype))]


@register_op("Concat", hint="concat")
class ConcatOp(OpDef):
    """Join ``num_args`` inputs along ``dim`` (reference concat-inl.h)."""
    params = [Param("num_args", int, required=True),
              Param("dim", int, default=1)]
    variable_args = "num_args"

    def list_arguments(self, p):
        return ["arg%d" % i for i in range(p.num_args)]

    def infer_shape(self, p, in_shapes):
        known = [s for s in in_shapes if s is not None]
        if not known:
            return in_shapes, [None], []
        out = list(known[0])
        out[p.dim] = int(np.sum([s[p.dim] for s in known]))
        return in_shapes, [tuple(out)], []

    def forward(self, p, inputs, aux, ctx):
        return [torch.cat(list(inputs), dim=p.dim)]


@register_op("SliceChannel", hint="slicechannel")
class SliceChannelOp(OpDef):
    """reference slice_channel-inl.h: ``num_outputs`` equal parts along
    ``axis``, each squeezed there with ``squeeze_axis``."""
    params = [Param("num_outputs", int, required=True),
              Param("axis", int, default=1),
              Param("squeeze_axis", bool, default=False)]

    def list_outputs(self, p):
        return ["output%d" % i for i in range(p.num_outputs)]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None] * p.num_outputs, []
        out = list(d)
        if out[p.axis] % p.num_outputs != 0:
            raise MXNetError("SliceChannel: axis size %d not divisible by %d"
                             % (out[p.axis], p.num_outputs))
        out[p.axis] //= p.num_outputs
        if p.squeeze_axis and out[p.axis] == 1:
            out = out[:p.axis] + out[p.axis + 1:]
        return [d], [tuple(out)] * p.num_outputs, []

    def forward(self, p, inputs, aux, ctx):
        parts = torch.chunk(inputs[0], p.num_outputs, dim=p.axis)
        if p.squeeze_axis:
            parts = [x.squeeze(p.axis) for x in parts]
        return list(parts)


@register_op("SwapAxis", hint="swapaxis")
class SwapAxisOp(OpDef):
    """reference swapaxis-inl.h."""
    params = [Param("dim1", int, default=0), Param("dim2", int, default=0)]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        out = list(d)
        out[p.dim1], out[p.dim2] = out[p.dim2], out[p.dim1]
        return [d], [tuple(out)], []

    def forward(self, p, inputs, aux, ctx):
        return [inputs[0].transpose(p.dim1, p.dim2).contiguous()]

    def row_dim(self, p, dim, ndim):
        return {p.dim1: p.dim2, p.dim2: p.dim1}.get(dim, dim)


@register_op("BlockGrad", hint="blockgrad")
class BlockGradOp(OpDef):
    """reference block_grad-inl.h: identity forward, zero gradient."""
    head_grad_optional = True

    def forward(self, p, inputs, aux, ctx):
        return [inputs[0].detach()]


@register_op("ElementWiseSum", hint="esum")
class ElementWiseSumOp(OpDef):
    """Sum of ``num_args`` inputs of one shape (reference
    elementwise_sum-inl.h), added left to right."""
    params = [Param("num_args", int, required=True)]
    variable_args = "num_args"

    def list_arguments(self, p):
        return ["arg%d" % i for i in range(p.num_args)]

    def infer_shape(self, p, in_shapes):
        d = next((s for s in in_shapes if s is not None), None)
        return [d] * len(in_shapes), [d], []

    def forward(self, p, inputs, aux, ctx):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return [out]


def embedding(data: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``weight[(int32)data]`` as the reference's ``jnp.take`` gives it:
    ids truncate toward zero, an id in ``[-input_dim, 0)`` wraps to
    ``id + input_dim``, and an id outside ``[-input_dim, input_dim)``
    reads a row of NaN.  On the card an out-of-range index is a device
    assert, so the rows are gathered at clamped ids and masked; a
    dropped id's gradient goes nowhere, a wrapped id's to its row.

    The gather is advanced indexing: its backward is PyTorch's
    ``index_put_`` with accumulation, which sorts the ids and sums each
    row's gradients in that order (deterministic, no host sync), where
    ``F.embedding``'s backward may read a count back to the host."""
    n = weight.shape[0]
    idx = data.detach().to(torch.int32)
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(valid, torch.where(idx < 0, idx + n, idx),
                       torch.zeros_like(idx)).long()
    rows = weight[safe]
    return torch.where(valid.unsqueeze(-1), rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


@register_op("Embedding", hint="embedding")
class EmbeddingOp(OpDef):
    """reference embedding-inl.h: weight[(int)data]."""
    params = [Param("input_dim", int, required=True),
              Param("output_dim", int, required=True)]

    def list_arguments(self, p):
        return ["data", "weight"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        w = (p.input_dim, p.output_dim)
        if d is None:
            return [None, w], [None], []
        return [d, w], [tuple(d) + (p.output_dim,)], []

    def forward(self, p, inputs, aux, ctx):
        return [embedding(inputs[0], inputs[1])]


@register_op("_sparse_embedding", hint="sparse_embedding")
class SparseEmbeddingOp(OpDef):
    """Deduped embedding lookup (``embed.sparse.dedup_lookup``): each
    distinct id's row gathered once, ``unique_cap`` distinct real ids a
    batch (0: the safe worst case).  The same output as ``Embedding`` for
    in-range ids; ids outside ``[0, input_dim)`` read zero vectors (the
    padded id batch).  ``passes.SparseEmbedPass`` rewrites Embedding to
    this op on a serving graph."""
    params = [Param("input_dim", int, required=True),
              Param("output_dim", int, required=True),
              Param("unique_cap", int, default=0)]

    def list_arguments(self, p):
        return ["data", "weight"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        w = (p.input_dim, p.output_dim)
        if d is None:
            return [None, w], [None], []
        return [d, w], [tuple(d) + (p.output_dim,)], []

    def forward(self, p, inputs, aux, ctx):
        from ..embed.sparse import dedup_lookup
        data, weight = inputs
        out, _uniq, _inv = dedup_lookup(weight, data.detach(),
                                        cap=p.unique_cap)
        return [out]


@register_op("Crop", hint="crop")
class CropOp(OpDef):
    """reference crop-inl.h: crop to ``h_w`` (or to the second input's
    height and width), at ``offset`` or centred."""
    params = [Param("num_args", int, default=1),
              Param("offset", "shape", default=(0, 0)),
              Param("h_w", "shape", default=(0, 0)),
              Param("center_crop", bool, default=False)]
    variable_args = "num_args"

    def list_arguments(self, p):
        if p.num_args == 1:
            return ["data"]
        return ["arg0", "arg1"]

    def _out_hw(self, p, like_shape):
        if p.num_args == 2 and like_shape is not None:
            return like_shape[2], like_shape[3]
        return p.h_w[0], p.h_w[1]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        like = in_shapes[1] if p.num_args == 2 and len(in_shapes) > 1 \
            else None
        h, w = self._out_hw(p, like)
        return in_shapes, [(d[0], d[1], h, w)], []

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        like = inputs[1].shape if p.num_args == 2 else None
        h, w = self._out_hw(p, like)
        if p.center_crop:
            oy = (x.shape[2] - h) // 2
            ox = (x.shape[3] - w) // 2
        else:
            oy, ox = p.offset
        return [x[:, :, oy:oy + h, ox:ox + w]]


@register_op("_CrossDeviceCopy", hint="crossdevicecopy")
class CrossDeviceCopyOp(OpDef):
    """reference cross_device_copy.cc: the identity on one device."""

    def forward(self, p, inputs, aux, ctx):
        return [inputs[0]]
