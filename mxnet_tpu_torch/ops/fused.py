"""Fused inference operators (the op-level half of ``passes.fuse``).

The counterpart of ``mxnet_tpu/ops/fused.py`` for the f32 family:

* ``_fused_FullyConnected`` — FullyConnected + bias + Activation
  (+ int8 requantize) as one node; its forward is the hand-written
  kernel ``cuda_kernels.fused_fc_epilogue`` (the plain version for CPU
  tensors);
* ``_fused_Convolution`` — Convolution + bias + Activation (+ requantize);
* ``_fused_quantized_FullyConnected`` / ``_fused_quantized_Convolution``
  — the int8 products of ``ops/quantized.py`` (summed exactly in int32)
  with dequantize + bias + Activation (+ requantize) fused in;
* ``_fused_elemwise`` — a chain of single-input elementwise ops carried
  as a serialized step list.

Parameter schemas equal the JAX package's, so fused graphs serialize to
the same JSON.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from . import cuda_kernels
from .nn import (ACTIVATIONS, _CONV_PARAMS, conv2d, conv_forward_layout,
                 conv_infer_shape, fc_input, fc_mode, fc_reduce)
from .quantized import (_QCONV_PARAMS, _QFC_PARAMS, _QuantizedBase,
                        fc_infer_shape, quantized_conv,
                        quantized_conv_infer_shape, quantized_fc)
from .registry import OpDef, Param, register_op, to_replicated, to_shard

__all__ = ["ACT_FNS", "ELEMWISE_STEP_OPS", "apply_act", "apply_steps",
           "parse_steps", "format_steps"]

# the activation epilogues the fused ops carry: Activation's act_type enum
# plus "none" (epilogue absent)
ACT_FNS = dict(ACTIVATIONS, none=lambda x: x)


def apply_act(x, act_type: str):
    fn = ACT_FNS.get(act_type or "none")
    if fn is None:
        raise MXNetError("fused op: unknown act_type %r (have %s)"
                         % (act_type, sorted(ACT_FNS)))
    return fn(x)


def _requantize(x, out_scale: Optional[float]):
    """The absorbed ``_contrib_quantize`` epilogue (int8 codes)."""
    return x if out_scale is None else cuda_kernels.requantize(x, out_scale)


_EPILOGUE_PARAMS = [
    Param("act_type", str, default="none",
          enum=sorted(ACT_FNS),
          doc="activation epilogue fused into the op"),
    Param("out_scale", float, default=None,
          doc="absorbed _contrib_quantize epilogue: when set, the op "
              "emits int8 at this scale"),
]


def _epilogue_infer_type(op, p, in_types):
    t = next((x for x in in_types if x is not None), np.dtype(np.float32))
    out = np.dtype(np.int8) if p.out_scale is not None else t
    return [t] * len(op.list_arguments(p)), [out], []


@register_op("_fused_FullyConnected", hint="fused_fullyconnected")
class FusedFullyConnectedOp(OpDef):
    """``y = act(x·Wᵀ + b)`` [→ int8 by ``out_scale``] in one kernel."""
    params = [Param("num_hidden", int, required=True),
              Param("no_bias", bool, default=False)] + _EPILOGUE_PARAMS

    def list_arguments(self, p):
        return ["data", "weight"] if p.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        num_input = int(np.prod(d[1:]))
        shapes = [d, (p.num_hidden, num_input)]
        if not p.no_bias:
            shapes.append((p.num_hidden,))
        return shapes, [(d[0], p.num_hidden)], []

    def infer_type(self, p, in_types):
        return _epilogue_infer_type(self, p, in_types)

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0].reshape(inputs[0].shape[0], -1).contiguous()
        b = None if p.no_bias else inputs[2]
        return [cuda_kernels.fused_fc_epilogue(x, inputs[1], b, p.act_type,
                                               p.out_scale)]

    def forward_layout(self, p, inputs, layouts, aux, ctx):
        """Column-parallel: the kernel on this rank's (N/n, K) weight
        shard and bias slice, the whole epilogue in it; the output is cut
        on its features.  Row-parallel: the kernel makes the partial
        product (no bias, no activation), the partials are summed over
        the axis, then bias, activation and the int8 requantize, so int8
        codes come from the sum, never from a partial."""
        from ..parallel.mesh import Layout
        mode = fc_mode(layouts)
        if mode is None:
            return super().forward_layout(p, inputs, layouts, aux, ctx)
        x, axis = fc_input(self.name, mode, inputs, layouts, ctx)
        x = x.contiguous()
        if mode == "column":
            b = None if p.no_bias else to_shard(inputs[2], layouts[2], 0,
                                                axis, ctx, self.name)
            return [cuda_kernels.fused_fc_epilogue(
                x, inputs[1], b, p.act_type, p.out_scale)], \
                [Layout.shard(1, axis)]
        out = fc_reduce(self.name, cuda_kernels.fused_fc_epilogue(
            x, inputs[1], None, "none"), axis, ctx)
        if not p.no_bias:
            out = out + to_replicated(inputs[2], layouts[2], ctx, self.name)
        return [_requantize(apply_act(out, p.act_type), p.out_scale)], None


@register_op("_fused_Convolution", hint="fused_convolution")
class FusedConvolutionOp(OpDef):
    """Convolution + bias + Activation (+ requantize) in one body."""
    params = list(_CONV_PARAMS) + _EPILOGUE_PARAMS

    def list_arguments(self, p):
        return ["data", "weight"] if p.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, p, in_shapes):
        return conv_infer_shape(p, in_shapes)

    def infer_type(self, p, in_types):
        return _epilogue_infer_type(self, p, in_types)

    def forward(self, p, inputs, aux, ctx):
        out = conv2d(p, inputs)
        return [_requantize(apply_act(out, p.act_type), p.out_scale)]

    def forward_layout(self, p, inputs, layouts, aux, ctx):
        return conv_forward_layout(
            self, p, inputs, layouts, aux, ctx,
            lambda p_, ins: _requantize(apply_act(conv2d(p_, ins),
                                                  p_.act_type), p_.out_scale))


class _FusedQuantizedBase(_QuantizedBase):
    """int8 data+weight, f32 wscale (+f32 bias): ``ops/quantized.py``'s
    convention with the activation/requantize epilogues fused in, in the
    reference's order and rounding: dequantize plus bias rounded once
    (``quantized.dequantize_int32``), activation, requantize."""

    def infer_type(self, p, in_types):
        ins, _out, aux = super().infer_type(p, in_types)
        out = np.dtype(np.int8) if p.out_scale is not None \
            else np.dtype(np.float32)
        return ins, [out], aux


@register_op("_fused_quantized_FullyConnected",
             hint="fused_quantized_fullyconnected")
class FusedQuantizedFullyConnectedOp(_FusedQuantizedBase):
    """int8 GEMM (int32 sums) + dequant + bias + act (+ requant)."""
    params = list(_QFC_PARAMS) + _EPILOGUE_PARAMS

    def infer_shape(self, p, in_shapes):
        return fc_infer_shape(p, in_shapes)

    def forward(self, p, inputs, aux, ctx):
        out = apply_act(quantized_fc(p, inputs), p.act_type)
        return [_requantize(out, p.out_scale)]


@register_op("_fused_quantized_Convolution",
             hint="fused_quantized_convolution")
class FusedQuantizedConvolutionOp(_FusedQuantizedBase):
    """int8 NCHW conv (int32 sums) + dequant + bias + act (+ requant)."""
    params = list(_QCONV_PARAMS) + _EPILOGUE_PARAMS

    def infer_shape(self, p, in_shapes):
        return quantized_conv_infer_shape(p, in_shapes)

    def forward(self, p, inputs, aux, ctx):
        out = apply_act(quantized_conv(p, inputs), p.act_type)
        return [_requantize(out, p.out_scale)]


# step name -> (needs_scalar, fn(x, scalar?)): the single-input, shape- and
# dtype-preserving ops ElementwiseFusePass may chain
ELEMWISE_STEP_OPS = {
    **{act: (False, fn) for act, fn in ACTIVATIONS.items()},
    "_plus_scalar": (True, lambda x, s: x + s),
    "_minus_scalar": (True, lambda x, s: x - s),
    "_rminus_scalar": (True, lambda x, s: s - x),
    "_mul_scalar": (True, lambda x, s: x * s),
    "_div_scalar": (True, lambda x, s: x / s),
    "_rdiv_scalar": (True, lambda x, s: s / x),
    "_maximum_scalar": (True, torch.clamp_min),
    "_minimum_scalar": (True, torch.clamp_max),
    "abs": (False, torch.abs),
    "ceil": (False, torch.ceil),
    "cos": (False, torch.cos),
    "exp": (False, torch.exp),
    "floor": (False, torch.floor),
    "log": (False, torch.log),
    "round": (False, torch.round),
    "rsqrt": (False, torch.rsqrt),
    "sign": (False, torch.sign),
    "sin": (False, torch.sin),
    "sqrt": (False, torch.sqrt),
    "square": (False, torch.square),
}


def format_steps(steps) -> str:
    """[("relu", None), ("_mul_scalar", 2.0)] -> "relu;_mul_scalar:2.0"."""
    parts = []
    for name, scalar in steps:
        if name not in ELEMWISE_STEP_OPS:
            raise MXNetError("_fused_elemwise: unknown step %r (have %s)"
                             % (name, sorted(ELEMWISE_STEP_OPS)))
        parts.append(name if scalar is None
                     else "%s:%r" % (name, float(scalar)))
    return ";".join(parts)


def parse_steps(spec: str):
    """Inverse of :func:`format_steps`."""
    steps = []
    for part in (spec or "").split(";"):
        if not part:
            continue
        name, _, scalar = part.partition(":")
        if name not in ELEMWISE_STEP_OPS:
            raise MXNetError("_fused_elemwise: unknown step %r in %r"
                             % (name, spec))
        needs_scalar = ELEMWISE_STEP_OPS[name][0]
        if needs_scalar != bool(scalar):
            raise MXNetError("_fused_elemwise: step %r %s a scalar (%r)"
                             % (name, "needs" if needs_scalar
                                else "takes no", part))
        steps.append((name, float(scalar) if scalar else None))
    return steps


def apply_steps(x, spec: str):
    for name, scalar in parse_steps(spec):
        needs_scalar, fn = ELEMWISE_STEP_OPS[name]
        # lint: allow(decode-host-sync) — the steps of an elementwise
        # chain, not a decode loop; ``scalar`` is a parsed host float
        x = fn(x, float(np.float32(scalar))) if needs_scalar else fn(x)
    return x


@register_op("_fused_elemwise", hint="fused_elemwise")
class FusedElemwiseOp(OpDef):
    """A chain of single-input elementwise ops as one node."""
    params = [Param("steps", str, required=True,
                    doc="';'-joined step list, each 'op' or 'op:scalar' "
                        "(see ops.fused.ELEMWISE_STEP_OPS)")]

    keeps_layout = "any"

    def forward(self, p, inputs, aux, ctx):
        return [apply_steps(inputs[0], p.steps)]
