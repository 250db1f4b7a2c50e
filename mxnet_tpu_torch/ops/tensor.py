"""Tensor ops (counterpart of ``mxnet_tpu/ops/tensor.py``): the
shaping ops the port's models use, ResNet's ``ElementWiseSum``, and the
uint8 wire prologue's ``Cast``, ``transpose``, ``_minus_scalar`` and
``_mul_scalar``.  The rest of the elementwise and scalar family waits
(ROADMAP.md, queue 1 item 2)."""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray import numpy_dtype, torch_dtype
from .registry import OpDef, Param, register_op


@register_op("Flatten", hint="flatten")
class FlattenOp(OpDef):
    """(N, ...) -> (N, prod)."""

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d], [(d[0], int(np.prod(d[1:])))], []

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]


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


@register_op("transpose", hint="transpose")
class TransposeOp(OpDef):
    """Permute the axes (all reversed when ``axes`` is empty)."""
    params = [Param("axes", "shape", default=())]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        axes = p.axes if p.axes else tuple(reversed(range(len(d))))
        return [d], [tuple(d[a] for a in axes)], []

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        axes = p.axes if p.axes else tuple(reversed(range(x.dim())))
        # materialized, as jnp.transpose is: a permuted view would send
        # the next convolution down another algorithm than a dense input
        return [x.permute(*axes).contiguous()]


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


class _ScalarOp(OpDef):
    """``x <op> scalar``, the scalar rounded to float32 first as in
    ``_fused_elemwise`` (``fused.apply_steps``), so a fused chain and its
    unfused nodes give the same bits."""
    params = [Param("scalar", float, required=True)]

    @staticmethod
    def scalar(p) -> float:
        return float(np.float32(p.scalar))


@register_op("_minus_scalar", hint="minus_scalar")
class MinusScalarOp(_ScalarOp):
    def forward(self, p, inputs, aux, ctx):
        return [inputs[0] - self.scalar(p)]


@register_op("_mul_scalar", hint="mul_scalar")
class MulScalarOp(_ScalarOp):
    def forward(self, p, inputs, aux, ctx):
        return [inputs[0] * self.scalar(p)]
