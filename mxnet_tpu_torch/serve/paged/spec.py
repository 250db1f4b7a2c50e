"""Speculative decode: a draft model proposes, the target verifies
(counterpart of ``mxnet_tpu/serve/paged/spec.py``).

The draft proposes K tokens one at a time (C = 1 steps), then the target
scores all K+1 positions in ONE chunk-width step.  With greedy argmax on
both sides the emitted stream is token-identical to plain target decode:
an accepted token is what the target would have produced, and the first
disagreement is replaced by the target's own argmax (the "bonus" token).

Cache discipline: the draft holds its own K/V view over the SAME
allocator and page table as the target, so speculation can never
out-allocate the admission reservation; rejected positions roll back by
moving length counters only (stale rows past the committed length are
masked and overwritten later); ``catch_up`` feeds committed tokens the
draft has not seen through it before each proposal round (chunk-width on
first contact with a stream, then C = 1).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...convert import convert_lm_params
from .engine import paged_step
from .model import LMConfig

__all__ = ["SpecDecoder"]


class SpecDecoder:
    """Draft-model side of speculative decode; owned and driven by one
    PagedDecodeEngine (every call happens on the engine's decode
    thread)."""

    def __init__(self, engine, draft_params: Dict, draft_cfg: LMConfig):
        self._engine = engine
        self.cfg = draft_cfg
        self.params = convert_lm_params(draft_params, engine.device)
        engine.pool.add_view("draft", draft_cfg.layers, draft_cfg.heads,
                             draft_cfg.head_dim)

    def run(self, tokens, positions, n_valid, lengths) -> np.ndarray:
        """One draft step over a (S, C) window against the draft KV view
        (same page table as the target)."""
        engine = self._engine
        kv_k, kv_v = engine.pool.view("draft")
        toks = paged_step(self.params, kv_k, kv_v,
                          *engine._to_device(tokens, positions, n_valid,
                                             lengths),
                          cfg=self.cfg, use_kernel=engine.use_kernel)
        engine.pool.set_view("draft", kv_k, kv_v)
        engine.forward_counts["draft"] += 1
        return toks.cpu().numpy()

    def catch_up(self, active) -> None:
        """Feed each slot's committed-but-draft-unseen tokens through the
        draft: the whole prompt on first contact (chunk-width), the bonus
        token after a fully-accepted round (C = 1)."""
        engine = self._engine
        while True:
            lagging = [(i, sl) for i, sl in active
                       if sl.draft_len < sl.cache_len]
            if not lagging:
                return
            width = engine.chunk if any(
                sl.cache_len - sl.draft_len > 1 for _, sl in lagging) \
                else 1
            tokens, positions, n_valid, lengths = engine._staging(width)
            for i, sl in lagging:
                c = min(width, sl.cache_len - sl.draft_len)
                for t in range(c):
                    tokens[i, t] = sl.committed(sl.draft_len + t)
                n_valid[i] = c
                positions[i, :c] = sl.draft_len + np.arange(c)
                lengths[i] = sl.draft_len + c
            self.run(tokens, positions, n_valid, lengths)
            for i, sl in lagging:
                sl.draft_len += int(n_valid[i])

    def propose(self, active, k_eff: Dict[int, int]) -> Dict[int, List[int]]:
        """Up to ``k_eff[i]`` draft proposals per slot over ``max(k_eff)``
        batched C = 1 draft steps (slots with a smaller depth sit out the
        later steps with an empty window).  Returns {slot: [tokens...]}."""
        engine = self._engine
        self.catch_up(active)
        k_round = max(k_eff.values()) if k_eff else 0
        props: Dict[int, List[int]] = {i: [] for i, _ in active
                                       if k_eff[i] > 0}
        if k_round == 0:
            return props
        tip = {i: sl.next_tok for i, sl in active}
        for r in range(k_round):
            # one host sync per proposal step: K small draft syncs buy
            # one batched target step
            tokens, positions, n_valid, lengths = engine._staging(1)
            for i, sl in active:
                if k_eff[i] > r:
                    tokens[i, 0] = tip[i]
                    n_valid[i] = 1
                    positions[i, 0] = sl.draft_len + r
                    lengths[i] = sl.draft_len + r + 1
                    engine.pool.ensure(i, sl.draft_len + r + 1)
            toks = self.run(tokens, positions, n_valid, lengths)
            for i, sl in active:
                if k_eff[i] > r:
                    t = int(toks[i, 0])
                    props[i].append(t)
                    tip[i] = t
        return props
