"""Neural-network layer ops (counterpart of ``mxnet_tpu/ops/nn.py``).

Every layer of the reference's ``ops/nn.py``.  Convolution goes to
``torch.nn.functional.conv2d``, Deconvolution and bilinear UpSampling to
``F.conv_transpose2d``, the plain matrix product to ``torch.matmul`` and
BatchNorm's normalization to ``F.batch_norm``, as the JAX package left
them to XLA.  Layouts are the
reference's: NCHW data, OIHW convolution weights, (N, K) FC weights.

Gradients come from autograd, except the output and loss layers'
(``SoftmaxOutput``/``Softmax``, the three regression outputs,
``MakeLoss``, ``SVMOutput``), whose backward ignores the head gradient
and injects the reference's own (``inject``, one ``autograd.Function``
in place of the reference's ``custom_vjp``s), and
``IdentityAttachKLSparseReg``, which adds its KL penalty to the head
gradient.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import (OpDef, Param, enter_parallel, register_op, to_replicated,
                       to_shard)


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
    keeps_layout = "any"

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

    def forward_layout(self, p, inputs, layouts, aux, ctx):
        from ..parallel.mesh import Layout
        mode = fc_mode(layouts)
        if mode is None:
            return super().forward_layout(p, inputs, layouts, aux, ctx)
        x, axis = fc_input(self.name, mode, inputs, layouts, ctx)
        out = torch.matmul(x, inputs[1].t())
        if mode == "column":
            if not p.no_bias:
                out = out + to_shard(inputs[2], layouts[2], 0, axis, ctx,
                                     self.name)
            return [out], [Layout.shard(1, axis)]
        if p.no_bias:
            # the partial sums go on as they are: the consumer's entry
            # sums them
            return [out], [Layout.sum_of(axis)]
        out = fc_reduce(self.name, out, axis, ctx)
        return [out + to_replicated(inputs[2], layouts[2], ctx,
                                    self.name)], None


def fc_mode(layouts) -> Optional[str]:
    """The tensor-parallel form of a FullyConnected from its weight's
    layout: ``"column"`` (weight (N, K) cut on dim 0: each rank makes its
    slice of the features), ``"row"`` (cut on dim 1: each rank sums its
    slice of the inputs, a partial sum), or None (the default rule)."""
    w = layouts[1]
    if w is None or w.partial or w.dim not in (0, 1):
        return None
    return "column" if w.dim == 0 else "row"


def fc_input(op: str, mode: str, inputs, layouts, ctx):
    """-> (the 2-D input this rank multiplies, the weight's axis).  A
    column-parallel product takes the whole input (its gradient summed
    over the axis); a row-parallel one its slice of the flattened
    features (a shard of dim 1 already is one)."""
    from ..parallel.mesh import Layout
    axis = layouts[1].axis
    x, lay = inputs[0], layouts[0]
    if mode == "column":
        x = enter_parallel(x, lay, axis, ctx, op)
        return x.reshape(x.shape[0], -1), axis
    if lay == Layout.shard(1, axis):
        return x.reshape(x.shape[0], -1), axis
    x = to_replicated(x, lay, ctx, op)
    x = to_shard(x.reshape(x.shape[0], -1), None, 1, axis, ctx, op)
    return x, axis


def fc_reduce(op: str, part, axis: str, ctx):
    """The sum over ``axis`` of a row-parallel product's partial sums."""
    from ..parallel import collectives as C
    C.note_redistribution(op, "all_reduce")
    return C.all_reduce(part, ctx.axis(axis))


def conv_forward_layout(op, p, inputs, layouts, aux, ctx, forward):
    """Convolution with its output channels cut (weight (O, C, kh, kw) on
    dim 0, one group): the whole input, this rank's filters and bias
    slice; the output is cut on dim 1.  ``forward(p, inputs)`` -> the
    output tensor.  Otherwise the default rule."""
    from ..parallel.mesh import Layout
    w = layouts[1]
    if w is None or w.partial or w.dim != 0 or p.num_group != 1:
        return OpDef.forward_layout(op, p, inputs, layouts, aux, ctx)
    ins = [enter_parallel(inputs[0], layouts[0], w.axis, ctx, op.name),
           inputs[1]]
    if not p.no_bias:
        ins.append(to_shard(inputs[2], layouts[2], 0, w.axis, ctx, op.name))
    return [forward(p, ins)], [Layout.shard(1, w.axis)]


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

    def forward_layout(self, p, inputs, layouts, aux, ctx):
        return conv_forward_layout(self, p, inputs, layouts, aux, ctx,
                                   conv2d)


@register_op("Deconvolution", hint="deconvolution")
class DeconvolutionOp(OpDef):
    """reference deconvolution-inl.h: the transposed convolution,
    out = s·(x-1) + k - 2p + adj.  The weight is (in_c, num_filter/g, kh,
    kw), PyTorch's transposed-conv layout, so ``F.conv_transpose2d``
    takes it as is.  As in the JAX package, ``target_shape`` is read by
    ``infer_shape`` only; the forward's size always follows the formula."""
    params = [Param("kernel", "shape", required=True),
              Param("stride", "shape", default=(1, 1)),
              Param("pad", "shape", default=(0, 0)),
              Param("adj", "shape", default=(0, 0)),
              Param("target_shape", "shape", default=(0, 0)),
              Param("num_filter", int, required=True),
              Param("num_group", int, default=1),
              Param("workspace", int, default=512),
              Param("no_bias", bool, default=True)]

    def list_arguments(self, p):
        return ["data", "weight"] if p.no_bias else ["data", "weight", "bias"]

    def _out_hw(self, p, d):
        if p.target_shape and (p.target_shape[0] != 0
                               or p.target_shape[1] != 0):
            return tuple(p.target_shape)
        return deconv_out_hw(p, d)

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        kh, kw = p.kernel
        wshape = (d[1], p.num_filter // p.num_group, kh, kw)
        oh, ow = self._out_hw(p, d)
        shapes = [d, wshape] + ([] if p.no_bias else [(p.num_filter,)])
        return shapes, [(d[0], p.num_filter, oh, ow)], []

    def forward(self, p, inputs, aux, ctx):
        x, w = inputs[0], inputs[1]
        bias = None if p.no_bias else inputs[2]
        if all(a < s for a, s in zip(p.adj, p.stride)):
            return [F.conv_transpose2d(x, w, bias, stride=tuple(p.stride),
                                       padding=tuple(p.pad),
                                       output_padding=tuple(p.adj),
                                       groups=p.num_group)]
        # PyTorch takes output_padding below the stride only; the lax
        # lowering takes any adj.  Output row o is row o + pad of the
        # uncropped transposed convolution, zero beyond its extent
        full = F.conv_transpose2d(x, w, None, stride=tuple(p.stride),
                                  groups=p.num_group)
        oh, ow = deconv_out_hw(p, x.shape)
        (ph, pw), (fh, fw) = p.pad, full.shape[2:]
        out = F.pad(full, (-pw, ow - (fw - pw), -ph, oh - (fh - ph)))
        if bias is not None:
            out = out + bias[None, :, None, None]
        return [out]


def deconv_out_hw(p, d):
    kh, kw = p.kernel
    return (p.stride[0] * (d[2] - 1) + kh - 2 * p.pad[0] + p.adj[0],
            p.stride[1] * (d[3] - 1) + kw - 2 * p.pad[1] + p.adj[1])


@register_op("Pooling", hint="pooling")
class PoolingOp(OpDef):
    """max/avg/sum pooling, floor output convention; padding counts as
    -inf for max and as zeros for avg (divided by the full window)."""
    # each channel pools alone
    keeps_layout = (1,)
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


class _DPBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the global batch of a data-parallel axis:
    the per-channel count and sum, then the sum of squared deviations,
    are summed over the axis in float32 (two passes, as ``var_mean``),
    and the backward sums the two per-channel gradient sums the same
    way.  The gradients of gamma and beta stay this rank's own sums; the
    step sums every parameter gradient over the axis."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, axis):
        from ..parallel.collectives import all_reduce_
        red = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = x.numel() // x.shape[1]
        s = torch.cat([x.sum(dim=red),
                       torch.full((1,), float(count), dtype=x.dtype,
                                  device=x.device)])
        all_reduce_(s, axis)
        n = s[-1]
        mean = s[:-1] / n
        xc = x - mean.view(shape)
        ss = (xc * xc).sum(dim=red)
        all_reduce_(ss, axis)
        var = ss / n
        invstd = torch.rsqrt(var + eps)
        xhat = xc * invstd.view(shape)
        y = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        from ..parallel.collectives import all_reduce_
        xhat, invstd, weight, n = ctx.saved_tensors
        red = [0] + list(range(2, gy.dim()))
        shape = [1, -1] + [1] * (gy.dim() - 2)
        sum_dy = gy.sum(dim=red)
        sum_dy_xhat = (gy * xhat).sum(dim=red)
        c = sum_dy.shape[0]
        t = all_reduce_(torch.cat([sum_dy, sum_dy_xhat]), ctx.axis)
        dx = (weight * invstd).view(shape) * (
            gy - (t[:c] / n).view(shape) - xhat * (t[c:] / n).view(shape))
        return dx, sum_dy_xhat, sum_dy, None, None


@register_op("BatchNorm", hint="batchnorm")
class BatchNormOp(OpDef):
    """reference batch_norm-inl.h (eps 1e-3, momentum 0.9, fix_gamma).

    The statistics are float32 and the variance is the biased one,
    mean((x - mu)^2), for the normalization and for the moving average
    alike: ``F.batch_norm`` normalizes with batch statistics but is never
    handed the aux tensors, whose own update would use the unbiased
    variance.  A train forward returns the new moving states
    ``m * old + (1 - m) * stat``.  Under a data-parallel axis
    (``ctx.dp``) the statistics are those of the global batch
    (``_DPBatchNorm``), as GSPMD gives the JAX package's op."""
    params = [Param("eps", float, default=1e-3),
              Param("momentum", float, default=0.9),
              Param("fix_gamma", bool, default=True),
              Param("use_global_stats", bool, default=False)]

    def list_arguments(self, p):
        return ["data", "gamma", "beta"]

    def list_auxiliary_states(self, p):
        return ["moving_mean", "moving_var"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        c = (d[1],) if len(d) > 1 else (d[0],)
        return [d, c, c], [d], [c, c]

    def forward(self, p, inputs, aux, ctx):
        x, gamma, beta = inputs
        moving_mean, moving_var = aux
        xf = x.float()
        # fix_gamma: a constant ones weight in gamma's place, so gamma's
        # gradient is 0 (not None: PyTorch's CUDA batch_norm backward
        # raises without a weight when its input takes a gradient)
        weight = torch.ones_like(beta, dtype=torch.float32) \
            if p.fix_gamma else gamma.float()
        if ctx.is_train and not p.use_global_stats and ctx.dp is not None:
            y, mean, var = _DPBatchNorm.apply(xf, weight, beta.float(),
                                              p.eps, ctx.dp)
            with torch.no_grad():
                m = p.momentum
                new_mean = (m * moving_mean.float() + (1 - m) * mean)
                new_var = (m * moving_var.float() + (1 - m) * var)
            return [y.to(x.dtype)], [new_mean.to(moving_mean.dtype),
                                     new_var.to(moving_var.dtype)]
        if ctx.is_train and not p.use_global_stats:
            y = F.batch_norm(xf, None, None, weight, beta.float(),
                             training=True, eps=p.eps)
            axes = [0] + list(range(2, x.dim()))
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=axes, unbiased=False)
                m = p.momentum
                new_mean = (m * moving_mean.float() + (1 - m) * mean)
                new_var = (m * moving_var.float() + (1 - m) * var)
            return [y.to(x.dtype)], [new_mean.to(moving_mean.dtype),
                                     new_var.to(moving_var.dtype)]
        y = F.batch_norm(xf, moving_mean.float(), moving_var.float(),
                         weight, beta.float(), training=False, eps=p.eps)
        return [y.to(x.dtype)]


@register_op("CuDNNBatchNorm", hint="cudnnbatchnorm")
class CuDNNBatchNormOp(BatchNormOp):
    """reference cudnn_batch_norm-inl.h: the same semantics, an alias."""


@register_op("Dropout", hint="dropout")
class DropoutOp(OpDef):
    """The identity at inference; in training each element is kept with
    probability 1 - p and scaled by 1 / (1 - p) (reference dropout-inl.h),
    the mask drawn from the op context's generator."""
    params = [Param("p", float, default=0.5)]
    needs_rng = True

    def _drop(self, p, x, ctx, cuts):
        keep = 1.0 - p.p
        mask = ctx.draw(lambda s: torch.rand(s, generator=ctx.generator,
                                             device=x.device),
                        tuple(x.shape), cuts) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def forward(self, p, inputs, aux, ctx):
        """On this rank's rows of a batch cut over ``dp`` the mask of the
        global batch is drawn and this rank's rows kept, so the ranks
        together draw one device's mask."""
        x = inputs[0]
        if not ctx.is_train or p.p <= 0.0:
            return [x]
        return [self._drop(p, x, ctx, ctx.row_cuts(0))]

    def forward_layout(self, p, inputs, layouts, aux, ctx):
        """On a shard: the whole value's mask is drawn (the same numbers
        on every rank, as on one device) and this rank's slice kept."""
        lay, x = layouts[0], inputs[0]
        if lay is None or lay.partial or not ctx.is_train or p.p <= 0.0:
            return super().forward_layout(p, inputs, layouts, aux, ctx)
        cuts = ctx.row_cuts(0) + [(lay.dim, ctx.axis(lay.axis))]
        return [self._drop(p, x, ctx, cuts)], [lay]


@register_op("LRN", hint="lrn")
class LRNOp(OpDef):
    """reference lrn-inl.h: x · (knorm + alpha/nsize · Σ x²)^(-beta), the
    sum over a window of nsize channels padded (nsize//2,
    nsize-1-nsize//2) with zeros."""
    params = [Param("alpha", float, default=1e-4),
              Param("beta", float, default=0.75),
              Param("knorm", float, default=2.0),
              Param("nsize", int, required=True)]

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        c, half = x.shape[1], p.nsize // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, p.nsize - 1 - half))
        summed = sq[:, 0:c]
        for i in range(1, p.nsize):
            summed = summed + sq[:, i:i + c]
        return [x * torch.pow(p.knorm + (p.alpha / p.nsize) * summed,
                              -p.beta)]


@register_op("L2Normalization", hint="l2normalization")
class L2NormalizationOp(OpDef):
    """reference l2_normalization-inl.h: each instance divided by
    sqrt(Σ x² + eps) over its flattened non-batch axes."""
    params = [Param("eps", float, default=1e-10)]

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        flat = x.reshape(x.shape[0], -1)
        norm = torch.sqrt((flat * flat).sum(dim=1, keepdim=True) + p.eps)
        return [(flat / norm).reshape(x.shape)]


@register_op("UpSampling", hint="upsampling")
class UpSamplingOp(OpDef):
    """reference upsampling-inl.h.  Nearest: every input repeated
    ``scale`` times along H and W (each input by the same scale, as the
    JAX package does), then concatenated or summed.  Bilinear: the
    depthwise transposed convolution with the (C, 1, k, k) weight, k =
    2·scale - scale % 2, pad = ceil((scale - 1) / 2)."""
    params = [Param("scale", int, required=True),
              Param("num_filter", int, default=0),
              Param("sample_type", str, required=True,
                    enum=["nearest", "bilinear"]),
              Param("multi_input_mode", str, default="concat",
                    enum=["concat", "sum"]),
              Param("num_args", int, default=1),
              Param("workspace", int, default=512)]
    variable_args = "num_args"

    def list_arguments(self, p):
        if p.sample_type == "bilinear":
            return ["data", "weight"]
        if p.num_args == 1:
            return ["data"]
        return ["arg%d" % i for i in range(p.num_args)]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        oh, ow = d[2] * p.scale, d[3] * p.scale
        if p.sample_type == "bilinear":
            k = 2 * p.scale - p.scale % 2
            return [d, (d[1], 1, k, k)], [(d[0], d[1], oh, ow)], []
        if p.num_args == 1:
            return [d], [(d[0], d[1], oh, ow)], []
        c = int(np.sum([s[1] for s in in_shapes])) \
            if p.multi_input_mode == "concat" else d[1]
        return in_shapes, [(d[0], c, oh, ow)], []

    def forward(self, p, inputs, aux, ctx):
        s = p.scale
        if p.sample_type == "bilinear":
            x, w = inputs
            pad = int(np.ceil((s - 1) / 2.0))
            return [F.conv_transpose2d(x, w, None, stride=(s, s),
                                       padding=(pad, pad), groups=x.shape[1])]

        def up_nearest(x):
            n, c, h, w = x.shape
            return x[:, :, :, None, :, None].expand(
                n, c, h, s, w, s).reshape(n, c, h * s, w * s)
        ups = [up_nearest(x) for x in inputs]
        if len(ups) == 1:
            return [ups[0]]
        if p.multi_input_mode == "sum":
            out = ups[0]
            for u in ups[1:]:
                out = out + u
            return [out]
        return [torch.cat(ups, dim=1)]


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds penalty·(-t/ρ + (1-t)/(1-ρ))
    to every element, ρ the mean of this forward's whole input clipped to
    [1e-6, 1 - 1e-6] (the JAX package's rule: the batch's mean, not the
    moving average C++ MXNet reads)."""

    @staticmethod
    def forward(ctx, x, rho, target, penalty):
        ctx.save_for_backward(rho)
        ctx.target, ctx.penalty = target, penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rho, = ctx.saved_tensors
        rho = torch.clamp(rho, 1e-6, 1 - 1e-6)
        t = ctx.target
        return g + ctx.penalty * (-t / rho + (1 - t) / (1 - rho)), None, \
            None, None


@register_op("IdentityAttachKLSparseReg",
             hint="identityattachklsparsereg")
class IdentityAttachKLSparseRegOp(OpDef):
    """reference identity_attach_KL_sparse_reg-inl.h: identity forward
    with the KL sparsity penalty added to the gradient; a train forward
    returns the new ``moving_avg`` = momentum · old + (1 - momentum) · ρ."""
    params = [Param("sparseness_target", float, default=0.1),
              Param("penalty", float, default=0.001),
              Param("momentum", float, default=0.9)]

    def list_auxiliary_states(self, p):
        return ["moving_avg"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d], [d], [(1,)]

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        if not ctx.is_train:
            return [x]
        rho = x.detach().mean()
        if ctx.dp is not None:
            from ..parallel.collectives import all_reduce_
            rho = all_reduce_(rho.clone(), ctx.dp) / ctx.dp.size
        y = _KLSparseReg.apply(x, rho, p.sparseness_target, p.penalty) \
            if torch.is_grad_enabled() and x.requires_grad else x
        new_avg = p.momentum * aux[0] + (1 - p.momentum) * rho
        return [y], [new_avg]


def _softmax_output(p, data):
    """Softmax over the flattened non-batch axes (over axis 1 per
    position with ``multi_output``)."""
    n = data.shape[0]
    if p.multi_output:
        d3 = data.reshape(n, data.shape[1], -1)
        return torch.softmax(d3, dim=1).reshape(data.shape)
    return torch.softmax(data.reshape(n, -1), dim=1).reshape(data.shape)


def _onehot(lab, k, dtype, axis):
    """one_hot of integer labels along ``axis``; labels outside [0, k)
    (ignore_label) give a zero row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(k, device=lab.device)
    shape = [1] * (lab.dim() + 1)
    shape[axis] = k
    return (lab.unsqueeze(axis) == classes.reshape(shape)).to(dtype)


def _dp_count(count, dp):
    """A count over this rank's batch -> over the global batch of the
    data-parallel axis ``dp`` (None: one device)."""
    if dp is None:
        return count
    if isinstance(count, torch.Tensor):
        from ..parallel.collectives import all_reduce_
        return all_reduce_(count.clone(), dp)
    return count * dp.size


def softmax_output_grad(p, out, label, dp=None):
    """The reference's injected gradient (softmax_output-inl.h:96-195,
    ``mxnet_tpu/ops/nn.py`` ``_softmax_output_forward``):
    (softmax - onehot) * grad_scale, with ignore masking and the
    null/batch/valid normalization; a label of the output's shape takes
    the ``out - label`` branch.  Under a data-parallel axis ``dp`` the
    batch and valid counts are the global batch's."""
    if out.shape == label.shape:
        return (out - label) * p.grad_scale
    n = out.shape[0]
    if p.multi_output:
        k = out.shape[1]
        o3 = out.reshape(n, k, -1)
        lab = label.reshape(n, -1).to(torch.int32)
        grad = o3 - _onehot(lab, k, out.dtype, 1)
        if p.use_ignore:
            grad = grad * (label.reshape(n, 1, -1)
                           != p.ignore_label).to(grad.dtype)
        rest = o3.shape[2]
        if p.normalization == "batch":
            grad = grad * (p.grad_scale / (float(_dp_count(n, dp)) * rest))
        elif p.normalization == "valid":
            valid = torch.clamp_min(
                _dp_count((label != p.ignore_label).sum(), dp), 1)
            grad = grad * (p.grad_scale / valid.to(grad.dtype))
        else:
            grad = grad * (p.grad_scale / rest)
        return grad.reshape(out.shape)
    o2 = out.reshape(n, -1)
    lab = label.reshape(-1).to(torch.int32)
    grad = o2 - _onehot(lab, o2.shape[1], out.dtype, 1)
    if p.use_ignore:
        grad = grad * (label.reshape(-1, 1) != p.ignore_label).to(grad.dtype)
    if p.normalization == "batch":
        grad = grad * (p.grad_scale / _dp_count(n, dp))
    elif p.normalization == "valid":
        valid = torch.clamp_min(
            _dp_count((label != p.ignore_label).sum(), dp), 1)
        grad = grad * (p.grad_scale / valid.to(grad.dtype))
    else:
        grad = grad * p.grad_scale
    return grad.reshape(out.shape)


class _InjectedGrad(torch.autograd.Function):
    """``out = fwd(data)``; the backward ignores the head gradient and
    returns ``grad(out, label)`` for data and zeros for the label (the
    reference's custom_vjp of a loss layer).  Only ``out`` and the label
    are kept for backward."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad = grad
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return ctx.grad(out, label), dlabel, None, None


def inject(data, label, fwd, grad):
    """``fwd(data)``, with ``grad(out, label)`` as its gradient when
    autograd records; ``label`` may be None (MakeLoss)."""
    if torch.is_grad_enabled() and data.requires_grad:
        if label is None:
            label = data.new_zeros(())
        return _InjectedGrad.apply(data, label, fwd, grad)
    return fwd(data)


@register_op("SoftmaxOutput", hint="softmaxoutput")
class SoftmaxOutputOp(OpDef):
    """reference softmax_output-inl.h: softmax forward; in training its
    gradient is (softmax - onehot(label)) * grad_scale whatever the head
    gradient."""
    head_grad_optional = True
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
        return [inject(inputs[0], inputs[1],
                       lambda d: _softmax_output(p, d),
                       lambda out, lab: softmax_output_grad(p, out, lab,
                                                            ctx.dp))]


@register_op("LeakyReLU", hint="leakyrelu")
class LeakyReLUOp(OpDef):
    """Leaky, exponential and parametric rectifiers (reference
    leaky_relu-inl.h).  rrelu at inference uses the mean slope
    (lower + upper) / 2; in training it draws a slope per element from
    U(lower, upper) with the op context's generator (no gradient flows
    to the slopes)."""
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
                # one device's slopes over a batch cut over dp
                slope = ctx.draw(lambda s: torch.empty(
                    s, dtype=x.dtype, device=x.device).uniform_(
                    p.lower_bound, p.upper_bound, generator=ctx.generator),
                    tuple(x.shape), ctx.row_cuts(0))
                return [torch.where(x > 0, x, slope * x)]
            return [F.leaky_relu(x, (p.lower_bound + p.upper_bound) / 2.0)]
        raise MXNetError("unknown act_type %s" % p.act_type)


@register_op("Softmax", hint="softmax")
class SoftmaxOp(SoftmaxOutputOp):
    """Deprecated alias of SoftmaxOutput (reference softmax_output.cc)."""


@register_op("SoftmaxActivation", hint="softmaxactivation")
class SoftmaxActivationOp(OpDef):
    """reference softmax_activation-inl.h: softmax over the flattened
    non-batch axes (``instance``) or over axis 1 (``channel``); its
    gradient is autograd's."""
    params = [Param("mode", str, default="instance",
                    enum=["instance", "channel"])]

    def forward(self, p, inputs, aux, ctx):
        x = inputs[0]
        if p.mode == "channel":
            return [torch.softmax(x, dim=1)]
        return [torch.softmax(x.reshape(x.shape[0], -1),
                              dim=1).reshape(x.shape)]


def _regression_grad(kind, scale):
    """reference regression_output-inl.h backward: (out - label), or its
    sign for MAE, times grad_scale / the label's per-row size."""
    def grad(out, label):
        num_output = int(np.prod(label.shape[1:])) if label.dim() > 1 else 1
        lab = label.reshape(out.shape).to(out.dtype)
        g = torch.sign(out - lab) if kind == "mae" else out - lab
        return g * (scale / num_output)
    return grad


class _RegressionBase(OpDef):
    head_grad_optional = True
    params = [Param("grad_scale", float, default=1.0)]
    kind = "linear"

    def list_arguments(self, p):
        return ["data", "label"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        lab = in_shapes[1] if len(in_shapes) > 1 else None
        if lab is not None and int(np.prod(lab)) == int(np.prod(d)):
            # any label layout with the output's element count ((N, 1)
            # or (N,)): the backward reshapes it to the output's
            lshape = lab
        elif len(d) == 2 and d[1] == 1:
            lshape = (d[0],)
        else:
            lshape = d
        return [d, lshape], [d], []

    def forward(self, p, inputs, aux, ctx):
        if self.kind == "logistic":
            def fwd(x):
                return sigmoid(x.reshape(x.shape[0], -1)).reshape(x.shape)
        else:
            def fwd(x):
                return x
        return [inject(inputs[0], inputs[1], fwd,
                       _regression_grad(self.kind, p.grad_scale))]


@register_op("LinearRegressionOutput", hint="linearregressionoutput")
class LinearRegressionOutputOp(_RegressionBase):
    """Identity forward; gradient (out - label) * scale."""
    kind = "linear"


@register_op("LogisticRegressionOutput", hint="logisticregressionoutput")
class LogisticRegressionOutputOp(_RegressionBase):
    """Sigmoid forward; gradient (out - label) * scale."""
    kind = "logistic"


@register_op("MAERegressionOutput", hint="maeregressionoutput")
class MAERegressionOutputOp(_RegressionBase):
    """Identity forward; gradient sign(out - label) * scale."""
    kind = "mae"


@register_op("MakeLoss", hint="makeloss")
class MakeLossOp(OpDef):
    """reference make_loss-inl.h: identity forward; the backward injects
    grad_scale whatever the head gradient, divided by the batch size
    (``batch``) or by the count of elements above ``valid_thresh``
    (``valid``, at least 1)."""
    head_grad_optional = True
    params = [Param("grad_scale", float, default=1.0),
              Param("normalization", str, default="null",
                    enum=["null", "batch", "valid"]),
              Param("valid_thresh", float, default=0.0)]

    def forward(self, p, inputs, aux, ctx):
        def grad(x, _label):
            if p.normalization == "valid":
                valid = torch.clamp_min(
                    _dp_count((x > p.valid_thresh).sum(), ctx.dp), 1)
                return torch.full_like(x, p.grad_scale) / valid.to(x.dtype)
            scale = p.grad_scale
            if p.normalization == "batch":
                scale = scale / _dp_count(x.shape[0], ctx.dp)
            return torch.full_like(x, scale)
        return [inject(inputs[0], None, lambda x: x, grad)]


@register_op("SVMOutput", hint="svmoutput")
class SVMOutputOp(OpDef):
    """reference svm_output-inl.h: identity forward; the hinge-loss
    gradient (L2-SVM, or L1 with ``use_linear``) in the backward."""
    head_grad_optional = True
    params = [Param("margin", float, default=1.0),
              Param("regularization_coefficient", float, default=1.0),
              Param("use_linear", bool, default=False)]

    def list_arguments(self, p):
        return ["data", "label"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        return [d, (d[0],)], [d], []

    def forward(self, p, inputs, aux, ctx):
        def grad(data, label):
            k = data.shape[1]
            lab = label.to(torch.int32)
            onehot = _onehot(lab, k, data.dtype, 1)
            score_true = torch.gather(data, 1, lab.long()[:, None])
            coef = p.regularization_coefficient
            if p.use_linear:
                viol = (data - score_true + p.margin > 0).to(data.dtype)
                return coef * (viol * (1 - onehot) - onehot * torch.sum(
                    viol * (1 - onehot), dim=1, keepdim=True))
            m = torch.clamp_min(data - score_true + p.margin, 0.0) \
                * (1 - onehot)
            return 2 * coef * (m - onehot * torch.sum(m, dim=1,
                                                       keepdim=True))
        return [inject(inputs[0], inputs[1], lambda x: x, grad)]
