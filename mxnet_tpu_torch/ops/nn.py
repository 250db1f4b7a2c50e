"""Neural-network layer ops (counterpart of ``mxnet_tpu/ops/nn.py``).

Forward only, and only the layers VGG-16, the MLP and FlowNetC's
correlation stage use.  Convolution goes to ``torch.nn.functional.conv2d``
and the plain matrix product to ``torch.matmul``, as the JAX package left
both to XLA.  Layouts are the reference's: NCHW data, OIHW convolution
weights, (N, K) FC weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpDef, Param, register_op


def _conv_out(x, k, s, p, d=1):
    eff = d * (k - 1) + 1
    return (x + 2 * p - eff) // s + 1


def softrelu(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)``, the form ``jax.nn.softplus``
    computes (no large-x cutoff)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": sigmoid,
    "tanh": torch.tanh,
    "softrelu": softrelu,
}


@register_op("Activation", hint="activation")
class ActivationOp(OpDef):
    params = [Param("act_type", str, required=True,
                    enum=["relu", "sigmoid", "tanh", "softrelu"])]

    def forward(self, p, inputs, aux, ctx):
        fn = ACTIVATIONS.get(p.act_type)
        if fn is None:
            raise MXNetError("unknown act_type %s" % p.act_type)
        return [fn(inputs[0])]


@register_op("FullyConnected", hint="fullyconnected")
class FullyConnectedOp(OpDef):
    """y = x·Wᵀ + b, x flattened to 2-D."""
    params = [Param("num_hidden", int, required=True),
              Param("no_bias", bool, default=False)]

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

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0].reshape(inputs[0].shape[0], -1)
        out = torch.matmul(x, inputs[1].t())
        if not p.no_bias:
            out = out + inputs[2]
        return [out]


_CONV_PARAMS = [Param("kernel", "shape", required=True),
                Param("stride", "shape", default=(1, 1)),
                Param("dilate", "shape", default=(1, 1)),
                Param("pad", "shape", default=(0, 0)),
                Param("num_filter", int, required=True),
                Param("num_group", int, default=1),
                Param("workspace", int, default=512),
                Param("no_bias", bool, default=False),
                Param("cudnn_tune", str, default=None),
                Param("cudnn_off", bool, default=False)]


def conv_infer_shape(p, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    kh, kw = p.kernel
    wshape = (p.num_filter, d[1] // p.num_group, kh, kw)
    oshape = (d[0], p.num_filter,
              _conv_out(d[2], kh, p.stride[0], p.pad[0], p.dilate[0]),
              _conv_out(d[3], kw, p.stride[1], p.pad[1], p.dilate[1]))
    shapes = [d, wshape] + ([] if p.no_bias else [(p.num_filter,)])
    return shapes, [oshape], []


def conv2d(p, inputs) -> torch.Tensor:
    """NCHW x OIHW convolution with the op's stride/pad/dilate/groups."""
    return F.conv2d(inputs[0], inputs[1],
                    None if p.no_bias else inputs[2],
                    stride=tuple(p.stride), padding=tuple(p.pad),
                    dilation=tuple(p.dilate), groups=p.num_group)


@register_op("Convolution", hint="convolution")
class ConvolutionOp(OpDef):
    params = list(_CONV_PARAMS)

    def list_arguments(self, p):
        return ["data", "weight"] if p.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, p, in_shapes):
        return conv_infer_shape(p, in_shapes)

    def forward(self, p, inputs, aux, ctx):
        return [conv2d(p, inputs)]


@register_op("Pooling", hint="pooling")
class PoolingOp(OpDef):
    """max/avg/sum pooling, floor output convention; padding counts as
    -inf for max and as zeros for avg (divided by the full window)."""
    params = [Param("kernel", "shape", required=True),
              Param("pool_type", str, default="max",
                    enum=["max", "avg", "sum"]),
              Param("global_pool", bool, default=False),
              Param("stride", "shape", default=(1, 1)),
              Param("pad", "shape", default=(0, 0))]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if p.global_pool:
            return [d], [(d[0], d[1], 1, 1)], []
        kh, kw = p.kernel
        oshape = (d[0], d[1],
                  1 + (d[2] + 2 * p.pad[0] - kh) // p.stride[0],
                  1 + (d[3] + 2 * p.pad[1] - kw) // p.stride[1])
        return [d], [oshape], []

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        if p.global_pool:
            kernel, stride, pad = (x.shape[2], x.shape[3]), (1, 1), (0, 0)
        else:
            kernel, stride, pad = tuple(p.kernel), tuple(p.stride), \
                tuple(p.pad)
        if p.pool_type == "max":
            floating = x.dtype.is_floating_point
            if pad != (0, 0):
                x = F.pad(x, (pad[1], pad[1], pad[0], pad[0]),
                          value=float("-inf") if floating
                          else torch.iinfo(x.dtype).min)
            if floating:
                return [F.max_pool2d(x, kernel, stride)]
            # max_pool2d has no integer kernel on CUDA: windows as views
            win = x.unfold(2, kernel[0], stride[0]).unfold(3, kernel[1],
                                                           stride[1])
            return [win.amax(dim=(-2, -1))]
        if pad != (0, 0):
            x = F.pad(x, (pad[1], pad[1], pad[0], pad[0]))
        out = F.avg_pool2d(x, kernel, stride)
        if p.pool_type == "sum":
            out = out * (kernel[0] * kernel[1])
        return [out]


@register_op("Dropout", hint="dropout")
class DropoutOp(OpDef):
    """The identity at inference; training comes with the training slice."""
    params = [Param("p", float, default=0.5)]
    needs_rng = True

    def forward(self, p, inputs, aux, ctx):
        if ctx.is_train and p.p > 0.0:
            raise NotImplementedError(
                "Dropout in training mode is not in the port yet "
                "(ROADMAP.md, queue 1 item 2: training)")
        return [inputs[0]]


@register_op("SoftmaxOutput", hint="softmaxoutput")
class SoftmaxOutputOp(OpDef):
    """Inference forward: softmax over the flattened non-batch axes
    (over axis 1 per position with ``multi_output``)."""
    params = [Param("grad_scale", float, default=1.0),
              Param("ignore_label", float, default=-1.0),
              Param("multi_output", bool, default=False),
              Param("use_ignore", bool, default=False),
              Param("prob_label", bool, default=False),
              Param("normalization", str, default="null",
                    enum=["null", "batch", "valid"])]

    def list_arguments(self, p):
        return ["data", "label"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if p.prob_label:
            lshape = d
        elif p.multi_output:
            lshape = (d[0],) + tuple(d[2:])
        else:
            lshape = (d[0],)
        return [d, lshape], [d], []

    def forward(self, p, inputs, aux, ctx):
        data = inputs[0]
        n = data.shape[0]
        if p.multi_output:
            d3 = data.reshape(n, data.shape[1], -1)
            return [torch.softmax(d3, dim=1).reshape(data.shape)]
        return [torch.softmax(data.reshape(n, -1), dim=1).reshape(data.shape)]


@register_op("LeakyReLU", hint="leakyrelu")
class LeakyReLUOp(OpDef):
    """Leaky, exponential and parametric rectifiers (reference
    leaky_relu-inl.h).  rrelu at inference uses the mean slope
    (lower + upper) / 2; rrelu in training draws a slope per element and
    raises until training is ported."""
    params = [Param("act_type", str, default="leaky",
                    enum=["leaky", "prelu", "rrelu", "elu"]),
              Param("slope", float, default=0.25),
              Param("lower_bound", float, default=0.125),
              Param("upper_bound", float, default=0.334)]
    needs_rng = True

    def list_arguments(self, p):
        return ["data", "gamma"] if p.act_type == "prelu" else ["data"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if p.act_type == "prelu":
            return [d, (d[1],)], [d], []
        return [d], [d], []

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        if p.act_type == "leaky":
            # x > 0 ? x : slope * x, in one pass
            return [F.leaky_relu(x, p.slope)]
        if p.act_type == "elu":
            return [torch.where(x > 0, x, p.slope * (torch.exp(x) - 1))]
        if p.act_type == "prelu":
            gamma = inputs[1].reshape([1, -1] + [1] * (x.dim() - 2))
            return [torch.where(x > 0, x, gamma * x)]
        if p.act_type == "rrelu":
            if ctx.is_train:
                raise NotImplementedError(
                    "LeakyReLU(act_type='rrelu') in training mode is not in "
                    "the port yet (ROADMAP.md, queue 1 item 2: training)")
            return [F.leaky_relu(x, (p.lower_bound + p.upper_bound) / 2.0)]
        raise MXNetError("unknown act_type %s" % p.act_type)
