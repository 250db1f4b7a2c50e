"""Attention across a sequence (counterpart of ``mxnet_tpu/parallel/ring.py``).

Only :func:`attention_reference` is ported: plain single-device attention,
which is also the plain version of the flash-attention kernel
(``ops/cuda_kernels.py``).  ``ring_attention``, ``ulysses_attention`` and
``make_ring_attention`` come with scale-out (ROADMAP.md, queue 1 item 10).
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain single-device attention, (B, T, H, D) -> (B, T, H, D), scale
    1/sqrt(D); with ``causal`` query i sees keys up to i + Tk - Tq."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=s.device).tril(tk - tq)
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
