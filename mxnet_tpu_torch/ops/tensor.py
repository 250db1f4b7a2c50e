"""Tensor-shaping ops (counterpart of ``mxnet_tpu/ops/tensor.py``)."""
from __future__ import annotations

import numpy as np

from .registry import OpDef, register_op


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
