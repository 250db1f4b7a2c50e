"""Quantized inference operators (counterpart of
``mxnet_tpu/ops/quantized.py``).  Symmetric int8, zero point 0:

    q = clip(round(x / scale), -127, 127)        x ~= q * scale

The compute ops take int8 activations and int8 weights, sum their
products exactly in int32 (``ops/int8.py``: ``torch._int_mm`` on the
card, float64 on the CPU), then dequantize and add the float32 bias in
the op, so each quantized layer emits float32.  Weight scales are per
output channel, a float32 input vector (``<name>_wscale``) that the
quantize pass bakes into the parameters.  Names, parameter schemas and
shape/type rules equal the JAX package's, so a quantized graph
serializes to the same symbol JSON in both packages.  Inference only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from .cuda_kernels import requantize
from .int8 import int8_conv2d, int8_matmul, int8_matmul_reference
from .nn import conv_infer_shape
from .registry import OpDef, Param, register_op

__all__ = ["INT8_QMAX", "quantize_array", "dequantize_int32"]

INT8_QMAX = 127.0


def quantize_array(arr: np.ndarray, axis: Optional[int] = None):
    """Host-side symmetric int8 quantization of a weight array.

    -> (int8 array, f32 scale array).  ``axis`` selects per-channel
    scales (one per slice along ``axis``); None = one per-tensor scale.
    Zero slices get scale 1.0 (q is all-zero either way; a zero scale
    would NaN the dequantize)."""
    arr = np.asarray(arr, np.float32)
    if axis is None:
        amax = float(np.max(np.abs(arr))) if arr.size else 0.0
        scale = np.float32(amax / INT8_QMAX if amax > 0 else 1.0)
        q = np.clip(np.rint(arr / scale), -INT8_QMAX, INT8_QMAX)
        return q.astype(np.int8), np.asarray(scale, np.float32)
    red = tuple(i for i in range(arr.ndim) if i != axis)
    amax = np.max(np.abs(arr), axis=red) if arr.size else \
        np.zeros(arr.shape[axis], np.float32)
    scale = np.where(amax > 0, amax / INT8_QMAX, 1.0).astype(np.float32)
    bshape = [1] * arr.ndim
    bshape[axis] = -1
    q = np.clip(np.rint(arr / scale.reshape(bshape)), -INT8_QMAX, INT8_QMAX)
    return q.astype(np.int8), scale


def _f32(t: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` rounded to float32, shaped like ``t``."""
    return torch.full_like(t, float(value), dtype=torch.float32)


def dequantize_int32(acc: torch.Tensor, scale_data: float,
                     wscale: torch.Tensor, bias: Optional[torch.Tensor]
                     ) -> torch.Tensor:
    """``acc.astype(f32) * (f32(scale_data) * wscale) + bias`` with the
    per-channel vectors broadcast along axis 1, rounded as the reference
    computes it on the CPU: XLA contracts the multiply and the bias add
    into one fused multiply-add, a single rounding.  The port takes the
    product (exact in float64: two float32 significands) and the sum in
    float64 and rounds once to float32, which is the fused result unless
    the float64 sum is itself inexact and lands on a float32 tie
    (probability about 2^-29 per element).  Both devices compute it the
    same way, so the card's results equal the CPU's bitwise."""
    scale = _f32(wscale, scale_data) * wscale
    shape = [1] * acc.dim()
    shape[1] = -1
    out = acc.to(torch.float32)
    if bias is None:
        return out * scale.reshape(shape)
    # the float64 product of two float32 values is exact, so a fused or
    # an unfused multiply-add gives the same float64 sum
    return torch.addcmul(bias.double().reshape(shape), out.double(),
                         scale.double().reshape(shape)).float()


@register_op("_contrib_quantize", hint="quantize")
class QuantizeOp(OpDef):
    """f32 -> int8 with a calibration-baked scale (symmetric, zp=0)."""
    params = [Param("scale", float, required=True,
                    doc="dequantize step: x ~= q * scale")]

    def infer_type(self, p, in_types):
        return [np.dtype(np.float32)], [np.dtype(np.int8)], []

    def forward(self, p, inputs, aux, ctx):
        if p.scale <= 0:
            raise MXNetError("_contrib_quantize scale must be > 0, got %r"
                             % (p.scale,))
        return [requantize(inputs[0], p.scale)]


@register_op("_contrib_dequantize", hint="dequantize")
class DequantizeOp(OpDef):
    """int8/int32 -> f32 by a single baked scale."""
    params = [Param("scale", float, required=True)]

    def infer_type(self, p, in_types):
        t = in_types[0] if in_types[0] is not None else np.dtype(np.int8)
        return [t], [np.dtype(np.float32)], []

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0].to(torch.float32)
        return [x * _f32(x, p.scale)]


class _QuantizedBase(OpDef):
    """Shared plumbing: int8 data+weight, f32 wscale vector (+f32 bias)."""

    def list_arguments(self, p):
        args = ["data", "weight", "wscale"]
        if not p.no_bias:
            args.append("bias")
        return args

    def infer_type(self, p, in_types):
        i8, f32 = np.dtype(np.int8), np.dtype(np.float32)
        ins = [i8, i8, f32] + ([] if p.no_bias else [f32])
        return ins, [f32], []


def fc_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    num_input = int(np.prod(d[1:]))
    shapes = [d, (p.num_hidden, num_input), (p.num_hidden,)]
    if not p.no_bias:
        shapes.append((p.num_hidden,))
    return shapes, [(d[0], p.num_hidden)], []


def quantized_conv_infer_shape(p, in_shapes):
    """Convolution's shapes with the wscale vector after the weight."""
    shapes, out, aux = conv_infer_shape(p, in_shapes)
    if in_shapes[0] is None:
        return shapes, out, aux
    return shapes[:2] + [(p.num_filter,)] + shapes[2:], out, aux


def _codes(t: torch.Tensor) -> torch.Tensor:
    """An operand that is not int8 (a quantized graph bound by
    ``simple_bind`` holds the int8 codes in float32 arrays) as int32,
    truncated toward zero: what XLA's ``dot_general`` with
    ``preferred_element_type=int32`` does to it in the JAX package
    (``mxnet_tpu/ops/quantized.py:127-134``)."""
    return t if t.dtype == torch.int8 else t.to(torch.int32)


def _int8_pair(x: torch.Tensor, w: torch.Tensor) -> bool:
    return x.dtype == torch.int8 and w.dtype == torch.int8


def quantized_fc(p, inputs) -> torch.Tensor:
    """int8 GEMM summed in int32, dequantized, plus bias: float32 out.
    Operands bound in another dtype take the exact float64 product of
    their int32 values (exact while every sum stays below 2^53)."""
    x = inputs[0].reshape(inputs[0].shape[0], -1)
    w = inputs[1]
    acc = int8_matmul(x, w) if _int8_pair(x, w) else \
        int8_matmul_reference(_codes(x), _codes(w))
    return dequantize_int32(acc, p.scale_data, inputs[2],
                            None if p.no_bias else inputs[3])


def quantized_conv(p, inputs) -> torch.Tensor:
    """int8 NCHW convolution summed in int32, dequantized per filter,
    plus bias: float32 out.  Both operands must be int8: the JAX
    package's ``lax.conv_general_dilated`` refuses mixed dtypes too."""
    acc = int8_conv2d(inputs[0], inputs[1], p.stride, p.pad, p.dilate,
                      p.num_group)
    return dequantize_int32(acc, p.scale_data, inputs[2],
                            None if p.no_bias else inputs[3])


_QFC_PARAMS = [Param("num_hidden", int, required=True),
               Param("no_bias", bool, default=False),
               Param("scale_data", float, required=True,
                     doc="calibrated activation scale of the int8 data "
                         "input")]
_QCONV_PARAMS = [Param("kernel", "shape", required=True),
                 Param("stride", "shape", default=(1, 1)),
                 Param("dilate", "shape", default=(1, 1)),
                 Param("pad", "shape", default=(0, 0)),
                 Param("num_filter", int, required=True),
                 Param("num_group", int, default=1),
                 Param("no_bias", bool, default=False),
                 Param("scale_data", float, required=True)]


@register_op("_quantized_FullyConnected", hint="quantized_fullyconnected")
class QuantizedFullyConnectedOp(_QuantizedBase):
    """y = (x_q · W_qᵀ).astype(f32) * (scale_data * wscale) + bias"""
    params = list(_QFC_PARAMS)

    def infer_shape(self, p, in_shapes):
        return fc_infer_shape(p, in_shapes)

    def forward(self, p, inputs, aux, ctx):
        return [quantized_fc(p, inputs)]


@register_op("_quantized_Convolution", hint="quantized_convolution")
class QuantizedConvolutionOp(_QuantizedBase):
    """int8 NCHW conv, int32 accumulation, fused per-filter dequant+bias."""
    params = list(_QCONV_PARAMS)

    def infer_shape(self, p, in_shapes):
        return quantized_conv_infer_shape(p, in_shapes)

    def forward(self, p, inputs, aux, ctx):
        return [quantized_conv(p, inputs)]
