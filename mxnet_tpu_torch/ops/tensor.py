"""Tensor-shaping ops (counterpart of ``mxnet_tpu/ops/tensor.py``)."""
from __future__ import annotations

import numpy as np
import torch

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
