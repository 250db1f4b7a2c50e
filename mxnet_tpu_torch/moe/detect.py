"""Graph-side detection of MoE blocks (counterpart of
``mxnet_tpu/moe/detect.py``): the fused train step registers a
``MoeStats`` when its graph routes through ``_moe_dispatch``, and the
serving parity pass walks the same nodes."""
from __future__ import annotations

from typing import Dict

__all__ = ["MoEBlockSpec", "find_moe_blocks"]


class MoEBlockSpec:
    """One routed block: its name and static routing geometry."""

    __slots__ = ("name", "num_experts", "k", "capacity_factor",
                 "renormalize")

    def __init__(self, name: str, num_experts: int, k: int,
                 capacity_factor: float, renormalize: bool):
        self.name = name
        self.num_experts = int(num_experts)
        self.k = int(k)
        self.capacity_factor = float(capacity_factor)
        self.renormalize = bool(renormalize)

    def describe(self):
        return (self.name, self.num_experts, self.k,
                self.capacity_factor, self.renormalize)

    def __repr__(self):
        return ("MoEBlockSpec(name=%r, E=%d, k=%d, cf=%g, renorm=%r)"
                % (self.name, self.num_experts, self.k,
                   self.capacity_factor, self.renormalize))


def find_moe_blocks(symbol) -> Dict[str, MoEBlockSpec]:
    """``{dispatch_node_name: MoEBlockSpec}`` for every ``_moe_dispatch``
    node reachable from ``symbol``'s heads."""
    from ..symbol import _topo
    out: Dict[str, MoEBlockSpec] = {}
    for node in _topo(symbol._heads):
        if node.is_variable or \
                getattr(node.op, "name", "") != "_moe_dispatch":
            continue
        p = node.params
        out[node.name] = MoEBlockSpec(node.name, p.num_experts, p.k,
                                      p.capacity_factor, p.renormalize)
    return out
