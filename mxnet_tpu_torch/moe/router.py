"""Top-k softmax routing with capacity-factor dropping (counterpart of
``mxnet_tpu/moe/router.py``).

Every tensor of the routing plan has a shape fixed by (tokens, experts,
k, capacity), so the fused train step captures it in a CUDA graph and the
decode engine runs it at one shape per slot count.  An over-capacity
token-choice folds to the one sentinel slot ``E * C``: dispatch writes it
into a scratch row past the expert buffer, combine reads it as zero, and
its gate weight is 0.

The top k come from a stable descending sort, so ties go to the lower
expert index first, as ``jax.lax.top_k`` orders them (``torch.topk``
promises no order on ties).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["resolve_capacity", "route", "RoutingPlan"]


def resolve_capacity(capacity_factor: float, n_tokens: int,
                     num_experts: int, k: int) -> int:
    """Static per-expert bucket size: ``capacity_factor <= 0`` (or None)
    means no dropping, ``C = n_tokens``; otherwise ``C = ceil(cf * T * k
    / E)`` clamped to ``[1, n_tokens]``."""
    n_tokens = int(n_tokens)
    worst = max(1, n_tokens)
    if capacity_factor is None or capacity_factor <= 0:
        return worst
    cap = int(math.ceil(float(capacity_factor) * n_tokens * int(k)
                        / float(max(1, int(num_experts)))))
    return max(1, min(worst, cap))


class RoutingPlan(NamedTuple):
    """``slot`` (T, k) int32 in ``[0, E*C]`` (``E*C`` is the sentinel),
    ``weight`` (T, k) float32 combine weights (0 on folded slots),
    ``counts`` (E,) accepted tokens per expert, ``assigned`` (E,) routed
    tokens per expert before capacity, ``hits`` (T, E) per-token accepted
    one-hots, ``aux`` () the load-balance loss, ``dropped`` () the
    token-choices folded to the sentinel.  ``counts``, ``assigned``,
    ``hits`` and ``dropped`` carry no gradient."""
    slot: torch.Tensor
    weight: torch.Tensor
    counts: torch.Tensor
    assigned: torch.Tensor
    hits: torch.Tensor
    aux: torch.Tensor
    dropped: torch.Tensor


def top_k(gates: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last axis,
    largest first and the lower index first on ties."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, k: int, capacity: int,
          renormalize: bool = False, dp=None) -> RoutingPlan:
    """Route ``(T, E)`` gate logits into capacity buckets with GShard's
    priority: every first choice, in token order, claims capacity before
    any second choice (a cumsum over the ``(k*T, E)`` one-hot).

    ``dp`` (a ``collectives.Axis``): the tokens are this rank's rows of a
    batch cut over ``dp``, and the plan is the global batch's, as the
    JAX package routes it under GSPMD: ``capacity`` is the global one,
    each choice's position counts the earlier choices of every rank and
    this choice on the ranks before this one (one all-gather of the
    ``(k, E)`` counts), and ``counts``, ``assigned``, ``dropped`` and
    ``aux`` are the global batch's.  ``slot`` and ``hits`` are this
    rank's tokens'."""
    T, E = logits.shape
    k = int(k)
    capacity = int(capacity)
    gates = torch.softmax(logits.float(), dim=-1)
    gate_k, expert_k = top_k(gates, k)                      # (T, k)
    if renormalize:
        gate_k = gate_k / torch.clamp(gate_k.sum(dim=-1, keepdim=True),
                                      min=1e-9)
    experts = torch.arange(E, device=logits.device)
    onehot = (expert_k.unsqueeze(-1) == experts).to(torch.int32)  # (T,k,E)
    if dp is not None:
        return _route_global(gates, gate_k, expert_k, onehot, capacity, dp)
    flat = onehot.transpose(0, 1).reshape(k * T, E)
    # the running count down the k*T rows, as a scan along the last axis
    # of the (E, k*T) transpose: the card's scan over an outer axis of
    # E columns runs each column serially
    running = torch.cumsum(flat.t().contiguous(), dim=1,
                           dtype=torch.int32).t() - flat
    pos = (running * flat).sum(dim=-1).reshape(k, T).transpose(0, 1)
    over = pos >= capacity                                    # (T, k)
    slot = torch.where(over, torch.full_like(pos, E * capacity),
                       expert_k * capacity + pos).to(torch.int32)
    weight = torch.where(over, torch.zeros_like(gate_k), gate_k)
    assigned = flat.sum(dim=0).float()                       # (E,)
    counts = torch.clamp(assigned, max=float(capacity))
    hits = (onehot.float() * (~over).unsqueeze(-1).float()).sum(dim=1)
    dropped = over.sum().float()
    # mean gate mass x routed fraction per expert, times E: a uniform
    # router scores 1.0
    me = gates.mean(dim=0)
    ce = assigned / float(max(1, T * k))
    aux = (me * ce).sum() * float(E)
    return RoutingPlan(slot=slot, weight=weight, counts=counts.detach(),
                       assigned=assigned.detach(), hits=hits.detach(),
                       aux=aux, dropped=dropped.detach())


def _route_global(gates, gate_k, expert_k, onehot, capacity: int, dp):
    """``route`` over a batch cut over ``dp`` (see ``route``)."""
    from ..parallel import collectives as C
    T, k, E = onehot.shape
    mine = onehot.sum(dim=0)                                   # (k, E)
    every = C._gather_raw(mine.unsqueeze(0), dp, 0)            # (dp, k, E)
    total = every.sum(dim=0)                                   # (k, E)
    offset = (torch.cumsum(total, dim=0) - total) \
        + every[:dp.index].sum(dim=0)
    running = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = ((running + offset.to(torch.int32)) * onehot).sum(dim=-1)
    over = pos >= capacity                                     # (T, k)
    slot = torch.where(over, torch.full_like(pos, E * capacity),
                       expert_k * capacity + pos).to(torch.int32)
    weight = torch.where(over, torch.zeros_like(gate_k), gate_k)
    assigned = total.sum(dim=0).float()                        # (E,)
    counts = torch.clamp(assigned, max=float(capacity))
    hits = (onehot.float() * (~over).unsqueeze(-1).float()).sum(dim=1)
    dropped = torch.clamp(assigned - float(capacity), min=0.0).sum()
    n = T * dp.size
    me = C.all_reduce(gates.sum(dim=0), dp) / float(n)
    ce = assigned / float(max(1, n * k))
    aux = (me * ce).sum() * float(E)
    return RoutingPlan(slot=slot, weight=weight, counts=counts.detach(),
                       assigned=assigned.detach(), hits=hits.detach(),
                       aux=aux, dropped=dropped.detach())
