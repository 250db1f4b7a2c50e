"""Capacity-bucketed dispatch and combine (counterpart of
``mxnet_tpu/moe/dispatch.py``), the one place that writes an expert
buffer.

The reference scatters into an ``(E*C, D)`` buffer in ``mode="drop"``, so
the sentinel slot ``E*C`` falls away.  On the card an out-of-range index
is a device assert, so the buffer here has one scratch row past the end:
every sentinel lands there and the row is sliced off.  No real row is
ever the target of a dropped token.  Neither function reads anything back
to the host, so both run inside a captured CUDA graph.
"""
from __future__ import annotations

import torch

__all__ = ["dispatch", "combine"]


def dispatch(x: torch.Tensor, slot: torch.Tensor, num_experts: int,
             capacity: int) -> torch.Tensor:
    """Scatter ``(T, D)`` tokens into the ``(E, C, D)`` expert buffer at
    the routing plan's ``(T, k)`` slots.  Slots below the sentinel are
    unique, so this is a plain write; the gradient of ``x`` gathers the
    buffer's gradient at each slot (0 for a dropped one)."""
    E, C = int(num_experts), int(capacity)
    T, D = x.shape
    k = slot.shape[1]
    rows = x.unsqueeze(1).expand(T, k, D).reshape(T * k, D)
    buf = x.new_zeros((E * C + 1, D)).index_put(
        (slot.reshape(T * k).long(),), rows)
    return buf[:E * C].reshape(E, C, D)


def combine(expert_out: torch.Tensor, slot: torch.Tensor,
            weight: torch.Tensor, num_experts: int,
            capacity: int) -> torch.Tensor:
    """Gather ``(E, C, O)`` expert outputs back to ``(T, O)``, weighted.
    The sentinel is clipped to the last real row for the gather and
    masked to zero, as the reference does, so a dropped token reads
    exactly nothing whatever its weight."""
    E, C = int(num_experts), int(capacity)
    n = E * C
    T, k = slot.shape
    flat = expert_out.reshape(n, expert_out.shape[-1])
    idx = torch.clamp(slot, max=n - 1).reshape(T * k).long()
    rows = flat[idx].reshape(T, k, -1)
    live = (slot < n).unsqueeze(-1).to(flat.dtype)
    w = weight.unsqueeze(-1).to(flat.dtype)
    return (rows * live * w).sum(dim=1)
