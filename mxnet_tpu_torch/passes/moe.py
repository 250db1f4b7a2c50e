"""MoEServeParityPass: no-drop routing on the serving graph (counterpart
of ``mxnet_tpu/passes/moe.py``).

Dropping tokens at a capacity factor is a training trade; at serve time a
dropped token is a corrupted answer that depends on what else shares the
batch.  This pass rewrites every ``_moe_dispatch`` node that still drops
to ``capacity_factor=0`` (the bucket holds every token), node attrs kept.
On by default in serving pipelines; ``MXNET_MOE_SERVE_EXACT=0`` keeps
the training capacity.
"""
from __future__ import annotations

from ..base import get_env
from .graph_passes import _make_node, rebuild
from .pipeline import Pass

__all__ = ["MoEServeParityPass", "default_moe_exact"]


def default_moe_exact() -> bool:
    """The ``MXNET_MOE_SERVE_EXACT`` default for serving pipelines."""
    return get_env("MXNET_MOE_SERVE_EXACT", True, bool)


class MoEServeParityPass(Pass):
    """``_moe_dispatch(capacity_factor=cf)`` -> ``capacity_factor=0`` on
    every node still carrying a dropping capacity."""

    name = "moe_serve_parity"
    order_after = ("quantize",)

    def apply(self, sym, params):
        rewritten = []

        def transform(node, new_inputs):
            if node.is_variable or \
                    getattr(node.op, "name", "") != "_moe_dispatch":
                return None
            p = node.params
            if not p.capacity_factor or p.capacity_factor <= 0:
                return None
            new = _make_node(
                "_moe_dispatch", node.name,
                {"num_experts": p.num_experts, "k": p.k,
                 "capacity_factor": 0.0, "renormalize": p.renormalize},
                new_inputs, attrs=node.attrs)
            rewritten.append(node.name)
            return [(new, i) for i in range(node.num_outputs())]

        out = rebuild(sym, transform)
        self.summary = {"rewritten": len(rewritten), "nodes": rewritten}
        return (out if rewritten else sym), params
