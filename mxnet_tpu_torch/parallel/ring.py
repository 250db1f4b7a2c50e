"""Sequence parallelism: ring attention and Ulysses all-to-all
(counterpart of ``mxnet_tpu/parallel/ring.py``).

* ``ring_attention``: each rank holds a sequence shard of Q/K/V; the K/V
  blocks rotate around the axis (``collectives.ring_shift``) while an
  online softmax accumulates in float32, with the reference's guards
  for fully masked rows and ``l`` clamped at 1e-20.  The running max is
  a constant shift of the softmax (the output does not depend on it),
  so it is taken out of autograd.
* ``ulysses_attention``: one all-to-all each way re-shards (sequence,
  all heads) <-> (full sequence, H/sp heads); each rank runs plain
  attention on its heads.  Needs ``H % sp == 0``.

Both are einsums, as in the JAX package, not the flash kernel, and both
are differentiable (the collectives carry autograd rules).  They take
per-rank shards and an ``Axis`` (``mesh.axis("sp")``);
``make_ring_attention`` wraps one for GLOBAL (B, T, H, D) tensors: it
slices this rank's T shard and all-gathers the output.
"""
from __future__ import annotations

import math

import torch

from . import collectives as C

__all__ = ["attention_reference", "ring_attention", "ulysses_attention",
           "make_ring_attention"]


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


def ring_attention(q, k, v, axis, causal: bool = False):
    """Blockwise ring attention; q, k, v are this rank's (B, T_local, H,
    D) shards of a sequence sharded over ``axis`` in rank order."""
    size, me = axis.size, axis.index
    b, tl, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    m = torch.full((b, h, tl), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, tl, h, d), dtype=torch.float32, device=dev)
    pos = torch.arange(tl, device=dev)
    kc, vc = k, v
    for step in range(size):
        src = (me + step) % size
        s = (torch.einsum("bqhd,bkhd->bhqk", q, kc) * scale).float()
        if causal:
            mask = (me * tl + pos)[:, None] >= (src * tl + pos)[None, :]
            s = s.masked_fill(~mask[None, None], -math.inf)
        with torch.no_grad():
            new_m = torch.maximum(m, s.amax(dim=-1))
            # guard fully masked rows (exp(-inf - -inf))
            safe_m = torch.where(torch.isinf(new_m),
                                 torch.zeros_like(new_m), new_m)
            corr = torch.where(torch.isinf(m), torch.zeros_like(m),
                               torch.exp(m - safe_m))
        inf = torch.isinf(s)
        p = torch.exp(s.masked_fill(inf, -math.inf) - safe_m[..., None])
        p = p.masked_fill(inf, 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vc.float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = new_m
        if step < size - 1:
            # rank i takes rank i+1's block next
            kc = C.ring_shift(kc, axis, -1)
            vc = C.ring_shift(vc, axis, -1)
    l = torch.clamp_min(l, 1e-20)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, axis, causal: bool = False):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): full
    attention over the whole sequence for H/sp heads on each rank."""
    size = axis.size
    b, tl, h, d = q.shape
    if h % size:
        raise ValueError("ulysses attention needs heads (%d) divisible by "
                         "the axis size (%d)" % (h, size))
    hl = h // size

    def to_heads(x):
        x = x.reshape(b, tl, size, hl, d)
        x = C.all_to_all(x, axis, split_dim=2, concat_dim=1)
        return x.reshape(b, tl * size, hl, d)

    oh = attention_reference(to_heads(q), to_heads(k), to_heads(v),
                             causal=causal)
    oh = oh.reshape(b, size, tl, 1, hl, d)
    out = C.all_to_all(oh, axis, split_dim=1, concat_dim=3)
    return out.reshape(b, tl, h, d)


def make_ring_attention(mesh, axis: str = "sp", causal: bool = False,
                        impl: str = "ring"):
    """-> fn(q, k, v) over GLOBAL (B, T, H, D) tensors: this rank
    computes its T shard with ring or Ulysses attention over ``axis``
    and the output comes back all-gathered on T."""
    inner = ring_attention if impl == "ring" else ulysses_attention

    def fn(q, k, v):
        ax = mesh.axis(axis)
        t = q.shape[1]
        if t % ax.size:
            raise ValueError("sequence length %d is not divisible by %s=%d"
                             % (t, axis, ax.size))
        tl = t // ax.size

        def shard(x):
            return x.narrow(1, ax.index * tl, tl)
        out = inner(shard(q), shard(k), shard(v), ax, causal=causal)
        return C.all_gather(out, ax, dim=1)
    return fn
