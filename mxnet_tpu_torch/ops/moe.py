"""MoE ops ``_moe_dispatch`` / ``_moe_expert_ffn`` / ``_moe_combine``
(counterpart of ``mxnet_tpu/ops/moe.py``; the same parameters, shape and
type rules).

The routing and the expert-buffer scatter/gather live in ``moe.router``
and ``moe.dispatch``; these ops bind them into the graph.  Gradients come
from autograd.  The expert FFN's two batched products are ``torch.einsum``
(cuBLAS batched GEMMs), as the JAX package computes them with
``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import OpDef, Param, register_op, to_shard

_ACTS = ["relu", "tanh", "sigmoid", "softrelu", "identity"]


def _act(name):
    return {"relu": torch.relu, "tanh": torch.tanh,
            "sigmoid": torch.sigmoid, "softrelu": F.softplus,
            "identity": lambda x: x}[name]


@register_op("_moe_dispatch", hint="moe_dispatch")
class MoEDispatchOp(OpDef):
    """Route ``data`` (T, D) by ``logits`` (T, E) into the capacity-
    bucketed expert buffer (E, C, D), with ``C = resolve_capacity(
    capacity_factor, T, E, k)`` (``capacity_factor <= 0``: C = T).
    Outputs: the buffer, the combine weights and slots (int32), the aux
    loss (1,), the accepted counts (E,) and the per-token hits (T, E)."""
    params = [Param("num_experts", int, required=True),
              Param("k", int, default=2),
              Param("capacity_factor", float, default=0.0),
              Param("renormalize", bool, default=False)]

    def list_arguments(self, p):
        return ["data", "logits"]

    def list_outputs(self, p):
        return ["dispatched", "weight", "slot", "aux", "counts", "hits"]

    def _cap(self, p, T):
        from ..moe.router import resolve_capacity
        return resolve_capacity(p.capacity_factor, T, p.num_experts, p.k)

    def infer_shape(self, p, in_shapes):
        d, lg = in_shapes
        if d is None:
            return in_shapes, [None] * 6, []
        if len(d) != 2:
            raise MXNetError("_moe_dispatch: data must be (tokens, dim), "
                             "got %r" % (d,))
        T, D = d
        E, k = p.num_experts, p.k
        if k < 1 or k > E:
            raise MXNetError("_moe_dispatch: k=%d outside [1, %d]" % (k, E))
        if lg is not None and tuple(lg) != (T, E):
            raise MXNetError("_moe_dispatch: logits must be (%d, %d), "
                             "got %r" % (T, E, lg))
        C = self._cap(p, T)
        return [d, (T, E)], \
            [(E, C, D), (T, k), (T, k), (1,), (E,), (T, E)], []

    def infer_type(self, p, in_types):
        t = in_types[0] if in_types[0] is not None else np.dtype(np.float32)
        f32 = np.dtype(np.float32)
        return [t, f32], \
            [t, f32, np.dtype(np.int32), f32, f32, f32], []

    def forward(self, p, inputs, aux, ctx):
        from ..moe.dispatch import dispatch
        from ..moe.router import route
        x, logits = inputs
        # under a dp axis the tokens are this rank's rows: the routing is
        # the global batch's, its capacity from the global token count
        dp = getattr(ctx, "dp", None)
        C = self._cap(p, x.shape[0] * (dp.size if dp is not None else 1))
        plan = route(logits, p.k, C, renormalize=p.renormalize, dp=dp)
        buf = dispatch(x, plan.slot, p.num_experts, C)
        return [buf, plan.weight, plan.slot, plan.aux.reshape(1),
                plan.counts, plan.hits]


@register_op("_moe_expert_ffn", hint="moe_experts")
class MoEExpertFFNOp(OpDef):
    """Per-expert two-layer FFN over the dispatched buffer:
    ``act(x[e] @ w1[e] + b1[e]) @ w2[e] + b2[e]`` for each expert e, with
    stacked weights (E, D, H) and (E, H, O)."""
    params = [Param("num_hidden", int, required=True),
              Param("output_dim", int, default=0),
              Param("act_type", str, default="relu", enum=_ACTS),
              Param("no_bias", bool, default=False)]

    def list_arguments(self, p):
        if p.no_bias:
            return ["data", "i2h_weight", "h2o_weight"]
        return ["data", "i2h_weight", "i2h_bias", "h2o_weight", "h2o_bias"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return in_shapes, [None], []
        if len(d) != 3:
            raise MXNetError("_moe_expert_ffn: data must be (experts, "
                             "capacity, dim), got %r" % (d,))
        E, C, D = d
        H = p.num_hidden
        O = p.output_dim or D
        if p.no_bias:
            shapes = [d, (E, D, H), (E, H, O)]
        else:
            shapes = [d, (E, D, H), (E, H), (E, H, O), (E, O)]
        return shapes, [(E, C, O)], []

    def forward_layout(self, p, inputs, layouts, aux, ctx):
        """Experts cut on dim 0 over an axis (``expert_axis``): the
        dispatched buffer is brought to the same cut (a narrow of the
        buffer every rank of the axis holds: the tokens are replicated
        over it), each rank runs its experts, and the output stays cut
        on the experts (the combine's default rule gathers it).  Each
        rank's buffer holds its own tokens' rows at the global capacity;
        the rows of other ranks' tokens are zero and read by no
        combine."""
        from ..parallel.mesh import Layout
        w = layouts[1]
        if w is None or w.partial or w.dim != 0:
            return super().forward_layout(p, inputs, layouts, aux, ctx)
        ins = [to_shard(t, lay, 0, w.axis, ctx, self.name)
               for t, lay in zip(inputs, layouts)]
        return self.forward(p, ins, aux, ctx), [Layout.shard(0, w.axis)]

    def forward(self, p, inputs, aux, ctx):
        act = _act(p.act_type)
        if p.no_bias:
            x, w1, w2 = inputs
            h = act(torch.einsum("ecd,edh->ech", x, w1))
            return [torch.einsum("ech,eho->eco", h, w2)]
        x, w1, b1, w2, b2 = inputs
        h = act(torch.einsum("ecd,edh->ech", x, w1) + b1.unsqueeze(1))
        return [torch.einsum("ech,eho->eco", h, w2) + b2.unsqueeze(1)]


@register_op("_moe_combine", hint="moe_combine")
class MoECombineOp(OpDef):
    """Gather expert outputs (E, C, O) back to token order (T, O),
    weighted by the routing plan's combine weights; the sentinel slot
    reads zero."""
    params = []

    def list_arguments(self, p):
        return ["data", "weight", "slot"]

    def infer_shape(self, p, in_shapes):
        d, w, s = in_shapes
        if d is None or (w is None and s is None):
            return in_shapes, [None], []
        if len(d) != 3:
            raise MXNetError("_moe_combine: data must be (experts, "
                             "capacity, dim), got %r" % (d,))
        tk = w if w is not None else s
        return [d, tuple(tk), tuple(tk)], [(tk[0], d[2])], []

    def infer_type(self, p, in_types):
        t = in_types[0] if in_types[0] is not None else np.dtype(np.float32)
        return [t, np.dtype(np.float32), np.dtype(np.int32)], [t], []

    def forward(self, p, inputs, aux, ctx):
        from ..moe.dispatch import combine
        x, weight, slot = inputs
        return [combine(x, slot, weight, x.shape[0], x.shape[1])]
