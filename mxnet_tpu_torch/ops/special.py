"""Vision ops that are hand-written CUDA kernels in the reference
(counterpart of ``mxnet_tpu/ops/special.py``).

Only ``Correlation`` (reference correlation.cu, the FlowNet correlation
layer) is ported.  ``ROIPooling`` and ``SpatialTransformer`` wait
(ROADMAP.md, queue 1 item 5).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import OpDef, Param, register_op


@register_op("Correlation", hint="correlation")
class CorrelationOp(OpDef):
    """reference correlation.cu (FlowNet correlation layer).

    At inference with ``kernel_size == 1``, ``stride1 == 1`` and
    ``pad_size == max_displacement`` (FlowNet's configuration) the op runs
    ``ops.cuda_kernels.correlation``: the hand-written kernel on a CUDA
    tensor.  Every other configuration, and training, takes the plain
    lowering below, as the JAX package takes its lax lowering there."""
    params = [Param("kernel_size", int, default=1),
              Param("max_displacement", int, default=1),
              Param("stride1", int, default=1),
              Param("stride2", int, default=1),
              Param("pad_size", int, default=0),
              Param("is_multiply", bool, default=True)]

    def list_arguments(self, p):
        return ["data1", "data2"]

    def _geom(self, p, d):
        n, c, h, w = d
        ph, pw = h + 2 * p.pad_size, w + 2 * p.pad_size
        kr = p.kernel_size // 2
        br = p.max_displacement + kr
        oh = int(np.ceil((ph - br * 2) / float(p.stride1)))
        ow = int(np.ceil((pw - br * 2) / float(p.stride1)))
        ng = p.max_displacement // p.stride2
        d2 = 2 * ng + 1
        return ph, pw, kr, br, oh, ow, ng, d2

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        _, _, _, _, oh, ow, _, d2 = self._geom(p, d)
        return [d, d], [(d[0], d2 * d2, oh, ow)], []

    def forward(self, p, inputs, aux, ctx):
        a, b = inputs
        n, c, h, w = a.shape
        ph, pw, kr, br, oh, ow, ng, d2 = self._geom(p, a.shape)
        if (p.kernel_size == 1 and p.stride1 == 1
                and p.pad_size == p.max_displacement
                and not getattr(ctx, "is_train", False)):
            from .cuda_kernels import correlation
            return [correlation(a, b, p.max_displacement, p.stride2,
                                p.is_multiply)]
        pad = (p.pad_size,) * 4
        ap = F.pad(a, pad)
        bp = F.pad(b, pad)
        ksz = p.kernel_size
        norm = float(c * ksz * ksz)
        outs = []
        for dy in range(-ng, ng + 1):
            for dx in range(-ng, ng + 1):
                sy, sx = dy * p.stride2, dx * p.stride2
                shifted = torch.roll(bp, shifts=(-sy, -sx), dims=(2, 3))
                prod = ap * shifted if p.is_multiply \
                    else (ap - shifted).abs()
                # sum over channels, then over the kernel window
                summed = prod.sum(dim=1, keepdim=True)
                if ksz > 1:
                    win = F.pad(summed, (kr, kr, kr, kr))
                    summed = sum(win[:, :, ky:ky + ph, kx:kx + pw]
                                 for ky in range(ksz) for kx in range(ksz))
                # sample the output grid from border br with stride1
                sl = summed[:, :, br:br + oh * p.stride1:p.stride1,
                            br:br + ow * p.stride1:p.stride1]
                outs.append(sl / norm)
        return [torch.cat(outs, dim=1)]
