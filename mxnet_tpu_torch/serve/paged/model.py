"""A small causal transformer LM for the paged serving path (counterpart of
``mxnet_tpu/serve/paged/model.py``).

Embedding + learned positions, pre-RMSNorm blocks, a tanh-GELU MLP and a
tied unembedding.  The forward hands attention to its caller through an
``attend(layer, q, k, v)`` callback, so one forward serves the paged
engine (KV append + paged attention), the dense-stripe layout and a plain
whole-sequence reference without knowing which is live.

``init_lm_params`` is the JAX package's numpy code, so one seed gives
bitwise the same arrays in both packages;
:func:`mxnet_tpu_torch.convert.convert_lm_params` moves such a blob onto
a device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["LMConfig", "init_lm_params", "lm_forward", "param_bytes",
           "causal_attend"]


class LMConfig(NamedTuple):
    """Static model geometry."""
    vocab: int
    dim: int
    heads: int
    layers: int
    max_context: int
    mlp_ratio: int = 4

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def init_lm_params(cfg: LMConfig, seed: int = 0, scale: float = 0.02,
                   embed=None) -> Dict[str, np.ndarray]:
    """Deterministic float32 parameter blob (numpy), bitwise the JAX
    package's for the same arguments.  ``embed`` (vocab, dim) overrides
    the embedding table — pass the target's to build a high-acceptance
    draft."""
    if cfg.dim % cfg.heads:
        raise ValueError("dim %d not divisible by heads %d"
                         % (cfg.dim, cfg.heads))
    rng = np.random.RandomState(seed)

    def w(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    p = {"embed": (np.array(embed, np.float32) if embed is not None
                   else w(cfg.vocab, cfg.dim)),
         "pos": w(cfg.max_context, cfg.dim),
         "lnf": np.ones((cfg.dim,), np.float32)}
    if p["embed"].shape != (cfg.vocab, cfg.dim):
        raise ValueError("embed shape %s != (vocab, dim) %s"
                         % (p["embed"].shape, (cfg.vocab, cfg.dim)))
    mlp = cfg.dim * cfg.mlp_ratio
    for l in range(cfg.layers):
        p["l%d.ln1" % l] = np.ones((cfg.dim,), np.float32)
        p["l%d.ln2" % l] = np.ones((cfg.dim,), np.float32)
        p["l%d.wq" % l] = w(cfg.dim, cfg.dim)
        p["l%d.wk" % l] = w(cfg.dim, cfg.dim)
        p["l%d.wv" % l] = w(cfg.dim, cfg.dim)
        p["l%d.wo" % l] = w(cfg.dim, cfg.dim)
        p["l%d.w1" % l] = w(cfg.dim, mlp)
        p["l%d.w2" % l] = w(mlp, cfg.dim)
    return p


def param_bytes(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(v.numel() * v.element_size()) for v in params.values())


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # the JAX package's formula: eps inside the root, gain over the root
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * (g / torch.sqrt(var + 1e-6))


def lm_forward(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
               positions: torch.Tensor, attend: Callable,
               cfg: LMConfig) -> torch.Tensor:
    """One step over a (S, C) token window -> (S, C, vocab) logits.

    ``attend(layer, q, k, v)`` receives the window's fresh projections
    ((S, C, H, Dh) each) and returns the attention output over whatever
    context the caller manages.  ``positions`` (S, C) index the learned
    position table after clipping to ``[0, max_context - 1]``; rows past
    a slot's valid window may hold anything — the caller discards their
    logits."""
    s, c = tokens.shape
    pos = positions.long().clamp(0, cfg.max_context - 1)
    x = params["embed"][tokens.long()] + params["pos"][pos]
    for l in range(cfg.layers):
        h = _rmsnorm(x, params["l%d.ln1" % l])
        q = (h @ params["l%d.wq" % l]).reshape(s, c, cfg.heads, cfg.head_dim)
        k = (h @ params["l%d.wk" % l]).reshape(s, c, cfg.heads, cfg.head_dim)
        v = (h @ params["l%d.wv" % l]).reshape(s, c, cfg.heads, cfg.head_dim)
        a = attend(l, q, k, v).reshape(s, c, cfg.dim)
        x = x + a @ params["l%d.wo" % l]
        h2 = _rmsnorm(x, params["l%d.ln2" % l])
        # jax.nn.gelu's default is the tanh form
        x = x + F.gelu(h2 @ params["l%d.w1" % l],
                       approximate="tanh") @ params["l%d.w2" % l]
    x = _rmsnorm(x, params["lnf"])
    return x @ params["embed"].T


def causal_attend(layer: int, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """``attend`` for a window that is the whole sequence: plain causal
    softmax attention of each row over the window's own keys, in float32.
    The reference for a teacher-forced pass over a full stream."""
    d = q.shape[-1]
    s = torch.einsum("sqhd,skhd->shqk", q.float(), k.float()) / math.sqrt(d)
    c = q.shape[1]
    mask = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("shqk,skhd->sqhd", p, v.float()).to(q.dtype)
