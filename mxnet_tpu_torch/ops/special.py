"""Vision ops that are hand-written CUDA kernels in the reference
(counterpart of ``mxnet_tpu/ops/special.py``): ``ROIPooling``,
``SpatialTransformer`` and ``Correlation``.

``Correlation`` runs the port's hand-written kernel at FlowNet's
configuration.  ``ROIPooling`` and ``SpatialTransformer`` are PyTorch
programs, as the JAX package leaves them to XLA.  ``ROIPooling`` never
builds the JAX formulation's per-ROI (C, Ph, Pw, H, W) mask, which XLA
fuses into its reduction but eager PyTorch would materialize: it takes
each bin's maximum in two separable stages over a range table
(``_RangeMax``), and its backward splits a bin's gradient equally among
the bin's tied maxima, as JAX's reduce-max rule does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import OpDef, Param, register_op


def _scan_max_count(z):
    """Inclusive scans along the last axis, by doubling: the running
    maximum ``m[t] = max(z[:t+1])``, the flags ``z == m`` and the count of
    ``u <= t`` with ``z[u] == m[t]``.  Those u are the flagged u of t's
    run of equal running maxima; as ``m`` never decreases, a step adds
    the partial count d places back only when its maximum equals
    ``m[t]``.  Every step is an elementwise pass over the tensor."""
    n = z.shape[-1]
    m, d = z, 1
    while d < n:
        m = torch.cat([m[..., :d], torch.maximum(m[..., d:], m[..., :-d])],
                      -1)
        d *= 2
    flag = z == m
    c, d = flag.to(z.dtype), 1
    while d < n:
        same = m[..., d:] == m[..., :-d]
        c = torch.cat([c[..., :d], c[..., d:]
                       + torch.where(same, c[..., :-d], 0.0)], -1)
        d *= 2
    return m, c, flag


def _scan_push(m, flag, s):
    """The transpose of ``_scan_max_count``'s maximum for shares: each
    aggregate t hands its per-element share ``s[t]`` to every ``u <= t``
    with ``z[u] == m[t]``; u gets the sum over t >= u of its run (a
    reverse scan by doubling, in float64)."""
    n = s.shape[-1]
    acc, d = s.double(), 1
    while d < n:
        same = m[..., :-d] == m[..., d:]
        acc = torch.cat([acc[..., :-d] + torch.where(same, acc[..., d:], 0.0),
                         acc[..., -d:]], -1)
        d *= 2
    return torch.where(flag, acc, 0.0)


class _RangeMax:
    """A disjoint sparse table over the last axis of ``x`` (N, C, H, W):
    at level k >= 1 each block of 2^k positions holds, left of its middle,
    the (max, count of ties) of [t, middle) and, right of it, those of
    [middle, t]; level 0 is the element itself.  The range [a, b] with
    a != b is the union of two disjoint aggregates at level
    bit_length(a ^ b), so a query costs two gathers and no mask."""

    def __init__(self, x):
        self.x = x
        w = x.shape[-1]
        self.levels = max(1, int(np.ceil(np.log2(w))))
        self.width = 1 << self.levels
        self.xp = F.pad(x, (0, self.width - w), value=float("-inf"))

    def _scan_order(self, t, k):
        """(N, C, H, P) -> (N, C, H, blocks, 2, half) with each block's
        left half reversed: both halves then scan away from the middle."""
        h = 1 << (k - 1)
        z = t.reshape(t.shape[:3] + (self.width // (2 * h), 2, h))
        return torch.stack([z[..., 0, :].flip(-1), z[..., 1, :]], -2)

    def _table_order(self, z):
        return torch.stack([z[..., 0, :].flip(-1), z[..., 1, :]],
                           -2).reshape(self.xp.shape)

    def tables(self):
        """-> (max, count) stacked over levels, (levels + 1, N, C, H, P)."""
        tm = self.xp.new_empty((self.levels + 1,) + self.xp.shape)
        tc = torch.empty_like(tm)
        tm[0] = self.xp
        tc[0] = 1.0
        for k in range(1, self.levels + 1):
            m, c, _ = _scan_max_count(self._scan_order(self.xp, k))
            tm[k] = self._table_order(m)
            tc[k] = self._table_order(c)
        return tm, tc

    def push(self, g):
        """Per-element shares handed to the aggregates, (levels + 1, N,
        C, H, P) -> the gradient of x (N, C, H, W), float64."""
        out = g[0].double()
        for k in range(1, self.levels + 1):
            m, _, flag = _scan_max_count(self._scan_order(self.xp, k))
            out = out + self._table_order(
                _scan_push(m, flag, self._scan_order(g[k], k)))
        return out[..., :self.x.shape[-1]]

    def query(self, a, b):
        """Level and the two positions of each range [a, b] (a <= b): the
        level is the bit length of a ^ b, counted in integers."""
        diff = torch.bitwise_xor(a, b)
        lvl = sum((diff >= (1 << j)).long() for j in range(self.levels))
        return lvl, a, b


def _roi_bins(rois, scale, ph, pw, n, h, w):
    """The JAX op's integer geometry of each ROI, in float32 as it
    computes it: batch index (truncated, negatives wrapped once, then
    clamped as a dynamic index is), and each bin's [start, end) rows and
    columns, clipped to the image."""
    batch = rois[:, 0].to(torch.int32).long()
    batch = torch.where(batch < 0, batch + n, batch).clamp(0, n - 1)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale) for i in (1, 2, 3, 4))
    roi_h = torch.clamp_min(y2 - y1 + 1.0, 1.0)
    roi_w = torch.clamp_min(x2 - x1 + 1.0, 1.0)
    # XLA multiplies by the reciprocal of a constant divisor
    bin_h = roi_h * np.float32(1.0 / np.float32(ph))
    bin_w = roi_w * np.float32(1.0 / np.float32(pw))
    bh = torch.arange(ph, dtype=rois.dtype, device=rois.device)
    bw = torch.arange(pw, dtype=rois.dtype, device=rois.device)
    hs = torch.clamp(torch.floor(bh * bin_h[:, None]) + y1[:, None], 0, h)
    he = torch.clamp(torch.ceil((bh + 1) * bin_h[:, None]) + y1[:, None],
                     0, h)
    ws = torch.clamp(torch.floor(bw * bin_w[:, None]) + x1[:, None], 0, w)
    we = torch.clamp(torch.ceil((bw + 1) * bin_w[:, None]) + x1[:, None],
                     0, w)
    return batch, hs.long(), he.long(), ws.long(), we.long()


def _row_masks(hs, he, h):
    ys = torch.arange(h, device=hs.device)
    return (ys >= hs[..., None]) & (ys < he[..., None])    # (R, Ph, H)


class _ROIPool(torch.autograd.Function):
    """Stage 1: each ROI's column bins over every row of its image, from
    the range table of the data: A (R, Pw, C, H), the bin-row maxima, and
    their tie counts.  Stage 2: per row bin, the maximum of A over the
    bin's rows and the ties summed over the rows that reach it.  Backward:
    g / count to every tied element of a bin, summed over bins and ROIs."""

    @staticmethod
    def forward(ctx, data, rois, pooled, scale):
        ph, pw = pooled
        n, c, h, w = data.shape
        batch, hs, he, ws, we = _roi_bins(rois, scale, ph, pw, n, h, w)
        table = _RangeMax(data)
        tm, tc = table.tables()
        cols = we > ws                                       # (R, Pw)
        lvl, pa, pb = table.query(ws.clamp_max(w - 1),
                                  (we - 1).clamp(0, w - 1))
        row = lvl * n + batch[:, None]
        tm, tc = tm.flatten(0, 1), tc.flatten(0, 1)
        ml, mr = tm[row, :, :, pa], tm[row, :, :, pb]        # (R, Pw, C, H)
        cl, cr = tc[row, :, :, pa], tc[row, :, :, pb]
        del tm, tc
        amax = torch.maximum(ml, mr)
        two = (lvl > 0)[..., None, None]
        eql, eqr = ml == amax, (mr == amax) & two
        cnt_a = torch.where(eql, cl, 0.0) + torch.where(eqr, cr, 0.0)
        amax = torch.where(cols[..., None, None], amax, float("-inf"))
        del ml, mr, cl, cr
        rows = _row_masks(hs, he, h)
        neg = torch.tensor(float("-inf"), dtype=data.dtype,
                           device=data.device)
        ms, cnts = [], []
        for i in range(ph):
            rm = rows[:, i, None, None, :]
            m = torch.where(rm, amax, neg).amax(-1)          # (R, Pw, C)
            tie = rm & (amax == m[..., None])
            ms.append(m)
            cnts.append(torch.where(tie, cnt_a, 0.0).sum(-1))
        m, cnt = torch.stack(ms, 1), torch.stack(cnts, 1)    # (R, Ph, Pw, C)
        valid = (he > hs)[:, :, None, None] & cols[:, None, :, None]
        out = torch.where(valid, torch.clamp_min(
            m, torch.finfo(data.dtype).min), 0.0)
        ctx.save_for_backward(data, rois, amax, eql, eqr, m, cnt)
        ctx.geom = (pooled, scale)
        return out.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        data, rois, amax, eql, eqr, m, cnt = ctx.saved_tensors
        (ph, pw), scale = ctx.geom
        n, c, h, w = data.shape
        batch, hs, he, ws, we = _roi_bins(rois, scale, ph, pw, n, h, w)
        valid = (he > hs)[:, :, None, None] & (we > ws)[:, None, :, None] \
            & (m > float("-inf"))
        share = torch.where(valid, g.permute(0, 2, 3, 1) / cnt, 0.0)
        rows = _row_masks(hs, he, h)
        s = torch.zeros_like(amax)                           # (R, Pw, C, H)
        for i in range(ph):
            tie = rows[:, i, None, None, :] & (amax == m[:, i, ..., None])
            s = s + torch.where(tie, share[:, i, ..., None], 0.0)
        table = _RangeMax(data)
        lvl, pa, pb = table.query(ws.clamp_max(w - 1),
                                  (we - 1).clamp(0, w - 1))
        row = lvl * n + batch[:, None]
        acc = data.new_zeros(((table.levels + 1) * n, table.width, c, h))
        # lint: allow(moe-raw-scatter) — ROIPooling's backward: the rows
        # and columns are the sparse table's own, clamped into the input
        acc.index_put_((row, pa), torch.where(eql, s, 0.0), accumulate=True)
        # lint: allow(moe-raw-scatter) — the same in-range table indices
        acc.index_put_((row, pb), torch.where(eqr, s, 0.0), accumulate=True)
        grad = table.push(acc.permute(0, 2, 3, 1).reshape(
            (table.levels + 1, n, c, h, table.width)))
        return grad.to(data.dtype), None, None, None


@register_op("ROIPooling", hint="roipooling")
class ROIPoolingOp(OpDef):
    """reference roi_pooling.cc: max-pool each ROI (batch index, x1, y1,
    x2, y2 in image coordinates times ``spatial_scale``, rounded half to
    even) into a ``pooled_size`` grid; an empty bin gives 0.  The rois
    take no gradient (the JAX op's is zero: rounding has none)."""
    params = [Param("pooled_size", "shape", required=True),
              Param("spatial_scale", float, required=True)]

    def list_arguments(self, p):
        return ["data", "rois"]

    def infer_shape(self, p, in_shapes):
        d, r = in_shapes
        if d is None or r is None:
            return in_shapes, [None], []
        ph, pw = p.pooled_size
        return [d, r], [(r[0], d[1], ph, pw)], []

    def forward(self, p, inputs, aux, ctx):
        data, rois = inputs
        return [_ROIPool.apply(data, rois.detach(), tuple(p.pooled_size),
                               p.spatial_scale)]


def _jax_linspace(num):
    """``jnp.linspace(-1, 1, num)`` in float32 as XLA computes it: step =
    iota · f32(1/div), then one rounding of step - f32(1 - step)."""
    if num == 1:
        return np.array([-1.0], np.float32)
    div = num - 1
    it = np.arange(div, dtype=np.float32)
    c = np.float32(1) / np.float32(div)
    sub = (np.float32(1) - it * c).astype(np.float64)
    out = (it.astype(np.float64) * np.float64(c) - sub).astype(np.float32)
    return np.concatenate([out, np.array([1.0], np.float32)])


@register_op("SpatialTransformer", hint="spatialtransformer")
class SpatialTransformerOp(OpDef):
    """reference spatial_transformer-inl.h: an affine grid over the target
    in [-1, 1], mapped to source pixels by (s + 1)·(size - 1)/2 and
    sampled bilinearly, each corner outside the image counting 0.  Its
    gradients (data and ``loc``) are autograd's through the JAX package's
    formula."""
    params = [Param("target_shape", "shape", required=True),
              Param("transform_type", str, default="affine",
                    enum=["affine"]),
              Param("sampler_type", str, default="bilinear",
                    enum=["bilinear"])]

    def list_arguments(self, p):
        return ["data", "loc"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        th, tw = p.target_shape
        return [d, (d[0], 6)], [(d[0], d[1], th, tw)], []

    def forward(self, p, inputs, aux, ctx):
        data, loc = inputs
        n, c, h, w = data.shape
        th, tw = p.target_shape
        ys = torch.from_numpy(_jax_linspace(th)).to(data.device)
        xs = torch.from_numpy(_jax_linspace(tw)).to(data.device)
        gy, gx = ys[:, None].expand(th, tw).reshape(-1), \
            xs[None, :].expand(th, tw).reshape(-1)
        theta = loc.reshape(n, 2, 3)
        src = theta[:, :, 0:1] * gx + theta[:, :, 1:2] * gy \
            + theta[:, :, 2:3]                               # (n, 2, P)
        sx = (src[:, 0] + 1.0) * (w - 1) / 2.0
        sy = (src[:, 1] + 1.0) * (h - 1) / 2.0
        x0, y0 = torch.floor(sx).detach(), torch.floor(sy).detach()
        wx, wy = sx - x0, sy - y0
        flat = data.reshape(n, c, h * w)

        def sample(xi, yi):
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            vals = torch.gather(flat, 2, idx[:, None, :].expand(n, c, -1))
            return vals * valid.to(data.dtype)[:, None, :]

        wx, wy = wx[:, None, :], wy[:, None, :]
        out = (sample(x0, y0) * (1 - wx) * (1 - wy)
               + sample(x0 + 1, y0) * wx * (1 - wy)
               + sample(x0, y0 + 1) * (1 - wx) * wy
               + sample(x0 + 1, y0 + 1) * wx * wy)
        return [out.reshape(n, c, th, tw)]


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
