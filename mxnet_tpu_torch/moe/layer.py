"""``MoEFeedForward``: the routed-expert block at the symbol level
(counterpart of ``mxnet_tpu/moe/layer.py``).

One call builds gate -> ``_moe_dispatch`` -> ``_moe_expert_ffn`` ->
``_moe_combine``; the load-balance aux loss stays an unconsumed output of
the dispatch node until ``with_aux_loss`` groups ``MakeLoss`` heads onto
the net.  ``expert_axis=`` stamps the reference's ``__sharding__`` attrs
on the stacked expert tensors, so the symbol JSON is the same in both
packages; under a named mesh with that axis (``fit(mesh="dp=2,ep=2")``)
each rank holds its experts, and the routing is the global batch's
(``router.route(dp=)``).
"""
from __future__ import annotations

from typing import List, Optional

from ..base import get_env
from .. import symbol as _sym

__all__ = ["MoEFeedForward", "aux_loss_symbols", "count_symbols",
           "hit_symbols", "with_aux_loss"]

# _moe_dispatch output indices (ops/moe.py list_outputs)
_AUX_IDX = 3
_COUNTS_IDX = 4
_HITS_IDX = 5


def MoEFeedForward(data, num_hidden: int, num_experts: int, k: int = 2,
                   capacity_factor: Optional[float] = None,
                   name: str = "moe", act_type: str = "relu",
                   renormalize: bool = False, output_dim: int = 0,
                   no_bias: bool = False,
                   expert_axis: Optional[str] = None):
    """One routed MoE feed-forward block over ``data`` (T, D).
    ``capacity_factor`` None reads ``MXNET_MOE_CAPACITY_FACTOR`` (default
    0: no dropping).  Returns the combined output symbol."""
    if capacity_factor is None:
        capacity_factor = get_env("MXNET_MOE_CAPACITY_FACTOR", 0.0, float)
    logits = _sym.FullyConnected(data, num_hidden=num_experts,
                                 no_bias=True, name=name + "_gate")
    disp = _sym._moe_dispatch(data, logits, num_experts=num_experts,
                              k=k, capacity_factor=capacity_factor,
                              renormalize=renormalize,
                              name=name + "_dispatch")

    def expert_var(suffix, spec):
        attr = {"__sharding__": spec} if expert_axis else None
        return _sym.Variable("%s_experts_%s" % (name, suffix), attr=attr)

    row3 = "%s,None,None" % expert_axis
    row2 = "%s,None" % expert_axis
    args = [disp[0], expert_var("i2h_weight", row3)]
    if not no_bias:
        args.append(expert_var("i2h_bias", row2))
    args.append(expert_var("h2o_weight", row3))
    if not no_bias:
        args.append(expert_var("h2o_bias", row2))
    ffn = _sym._moe_expert_ffn(*args, num_hidden=num_hidden,
                               output_dim=output_dim, act_type=act_type,
                               no_bias=no_bias, name=name + "_experts")
    return _sym._moe_combine(ffn, disp[1], disp[2],
                             name=name + "_combine")


def _dispatch_heads(symbol, out_idx: int) -> List:
    from ..symbol import Symbol, _topo
    return [Symbol([(node, out_idx)]) for node in _topo(symbol._heads)
            if not node.is_variable
            and getattr(node.op, "name", "") == "_moe_dispatch"]


def aux_loss_symbols(symbol) -> List:
    """The ``(1,)`` aux-loss head of every MoE block reachable from
    ``symbol``, in topological order."""
    return _dispatch_heads(symbol, _AUX_IDX)


def count_symbols(symbol) -> List:
    """The ``(E,)`` accepted-count head of every MoE block."""
    return _dispatch_heads(symbol, _COUNTS_IDX)


def hit_symbols(symbol) -> List:
    """The ``(T, E)`` per-token accepted-assignment head of every MoE
    block; a decode graph adds it onto its per-slot hits state, which
    ``DecodeEngine(moe_hits_state=)`` samples into ``moe_report()``."""
    return _dispatch_heads(symbol, _HITS_IDX)


def with_aux_loss(net, grad_scale: Optional[float] = None):
    """Group a ``MakeLoss`` head for every MoE block's aux loss onto
    ``net`` (``grad_scale`` None reads ``MXNET_MOE_AUX_COEF``, default
    0.01); ``net`` unchanged when it has no MoE block."""
    if grad_scale is None:
        grad_scale = get_env("MXNET_MOE_AUX_COEF", 0.01, float)
    auxes = aux_loss_symbols(net)
    if not auxes:
        return net
    heads = [net]
    for aux in auxes:
        heads.append(_sym.MakeLoss(aux, grad_scale=float(grad_scale),
                                   name="%s_aux" % aux._heads[0][0].name))
    return _sym.Group(heads)
