"""Deduped sparse lookup and update (counterpart of
``mxnet_tpu/embed/sparse.py``), on tensors of a fixed shape.

* **dedup**: ``dedup_ids`` maps a batch of ids to ``(uniq[cap],
  inv[N])`` without reading a size back to the host (``torch.unique``
  does, which a CUDA graph capture cannot take): a stable sort, a mark at
  each new value, a cumsum for the segment of every sorted position (its
  row in ``uniq``, scattered back to batch order as ``inv``), and a
  scatter of the sorted values into a ``cap``-long buffer filled with the
  sentinel.  Past ``cap`` the distinct values are dropped, as the
  reference's ``jnp.unique(size=cap)`` truncates them: their ``inv``
  runs past the buffer and a lookup reads NaN there.
* **lookup**: the unique rows gathered once, out-of-range ids read as
  zero vectors, then a take over ``inv``.
* **update**: the per-occurrence gradients summed onto the unique rows,
  then the optimizer's in-place update on those rows only (the lazy
  update: untouched rows keep their weights and slots bit for bit).

Sentinels.  Every out-of-range id, negative ones included, folds to the
one sentinel ``vocab`` before any index op.  The reference's scatters
drop it (``mode="drop"``); on the card an out-of-range index is a device
assert, so a table that takes a scatter is stored with one scratch row
past the end (``vocab + 1`` rows, the table a view of the first
``vocab``): the sentinel writes land there and nothing reads them back
unmasked.  No sentinel is ever clamped onto row ``vocab - 1``.

Sums.  ``dedup_scatter_add`` and the take's gradient are
``index_put_(accumulate=True)``, which sorts the indices and adds each
row's values in sorted order on the card: deterministic, so a replayed
CUDA graph equals the eager step bit for bit, with no atomics.  (On the
CPU it sums in parallel above its grain size, in the same order only
under ``torch.use_deterministic_algorithms(True)``.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["dedup_ids", "dedup_lookup", "naive_lookup", "block_rows",
           "dedup_scatter_add", "naive_scatter_add", "sparse_apply_rows",
           "slot_leaves_row_shaped", "resolve_cap", "map_slots"]


def resolve_cap(cap: Optional[int], n_ids: int, vocab: int) -> int:
    """The unique-buffer size: the worst case ``min(n_ids, vocab + 1)``
    (every id distinct plus the sentinel) for 0/None, else the caller's
    count of distinct real ids plus the sentinel slot, clamped into
    ``[1, worst]``."""
    worst = max(1, min(int(n_ids), int(vocab) + 1))
    if not cap:
        return worst
    return max(1, min(int(cap) + 1, worst))


def dedup_ids(flat_ids: torch.Tensor, cap: int,
              sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(uniq[cap] int32, inv[N] int64)`` for a flat id batch: ``uniq``
    ascending and padded with ``sentinel``, ``inv`` each position's row
    in ``uniq``.  Ids outside ``[0, sentinel)`` (float ids truncate
    toward zero first) fold to the sentinel."""
    ids = flat_ids.reshape(-1).to(torch.int32)
    oov = (ids < 0) | (ids >= sentinel)
    ids = torch.where(oov, torch.full_like(ids, sentinel), ids)
    n = ids.numel()
    srt, perm = torch.sort(ids, stable=True)
    new = torch.ones(n, dtype=torch.bool, device=ids.device)
    new[1:] = srt[1:] != srt[:-1]
    seg = torch.cumsum(new, dim=0) - 1                   # int64
    inv = torch.empty_like(seg).scatter_(0, perm, seg)
    # one slot past the buffer takes every value that overflows cap
    buf = torch.full((cap + 1,), sentinel, dtype=torch.int32,
                     device=ids.device)
    buf.scatter_(0, torch.clamp(seg, max=cap), srt)
    return buf[:cap], inv


def block_rows(uniq: torch.Tensor, lo: int, size: int):
    """Where the unique ids sit in a row-sharded table's block of
    ``size`` rows from row ``lo``: -> (each id's row in the block's
    storage, the owned mask).  Ids of other blocks, and the sentinel,
    index the storage's scratch row ``size``."""
    loc = uniq.long() - lo
    own = (loc >= 0) & (loc < size)
    return torch.where(own, loc, torch.full_like(loc, size)), own


def _mask_oov_rows(rows: torch.Tensor, uniq: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """Zero the gathered rows whose id is out of table range."""
    ok = (uniq >= 0) & (uniq < vocab)
    return torch.where(ok.unsqueeze(-1), rows, torch.zeros_like(rows))


def dedup_lookup(table: torch.Tensor, ids: torch.Tensor,
                 cap: Optional[int] = None):
    """Deduped lookup ``ids (...,) -> (..., dim)``: out-of-range ids read
    zero vectors, and an ``inv`` past a truncated buffer a NaN row (the
    port's ``Embedding`` gather, as ``jnp.take``'s fill mode).  -> ``(out,
    uniq, inv)``."""
    from ..ops.tensor import embedding
    vocab = table.shape[0]
    flat = ids.reshape(-1)
    k = resolve_cap(cap, flat.shape[0], vocab)
    uniq, inv = dedup_ids(flat, k, sentinel=vocab)
    rows = table[torch.clamp(uniq, max=vocab - 1).long()]
    rows = _mask_oov_rows(rows, uniq, vocab)
    out = embedding(inv, rows).reshape(tuple(ids.shape) + (table.shape[1],))
    return out, uniq, inv


def naive_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One gather per id; out-of-range ids clip to the first or last row
    (``jnp.take(mode="clip")``, the reference's baseline)."""
    idx = torch.clamp(ids.reshape(-1).to(torch.int64), 0,
                      table.shape[0] - 1)
    return table[idx].reshape(tuple(ids.shape) + (table.shape[1],))


def dedup_scatter_add(grads_flat: torch.Tensor, inv: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """Sum per-occurrence rows onto their unique rows: ``(N, dim) x
    inv[N] -> (cap, dim)``; an ``inv`` past the buffer drops, as
    ``segment_sum`` drops it."""
    out = grads_flat.new_zeros((cap + 1, grads_flat.shape[-1]))
    out.index_put_((torch.clamp(inv, max=cap).long(),), grads_flat,
                   accumulate=True)
    return out[:cap]


def naive_scatter_add(table: torch.Tensor, flat_ids: torch.Tensor,
                      grads_flat: torch.Tensor) -> torch.Tensor:
    """The baseline: one scatter-add into the full table per id
    occurrence; out-of-range ids (negative ones too) drop.  -> a new
    table."""
    vocab = table.shape[0]
    idx = flat_ids.reshape(-1).to(torch.int64)
    idx = torch.where((idx < 0) | (idx >= vocab),
                      torch.full_like(idx, vocab), idx)
    big = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    big.index_put_((idx,), grads_flat.to(table.dtype), accumulate=True)
    return big[:vocab]


def map_slots(fn, slots):
    """``fn`` over the tensors of an optimizer state (None, a tensor or
    a tuple of them), keeping its structure."""
    if slots is None:
        return None
    if isinstance(slots, (tuple, list)):
        return tuple(map_slots(fn, s) for s in slots)
    return fn(slots)


def sparse_apply_rows(store: torch.Tensor, slot_store, uniq: torch.Tensor,
                      grad_rows: torch.Tensor, opt_update, lr, wd, t):
    """Lazy per-row optimizer step, in place, on the rows ``uniq`` names.

    ``store`` is the table's storage with its scratch row (``vocab + 1``
    rows) and ``slot_store`` the optimizer state made for it; every
    row-shaped leaf is gathered at ``uniq``, the optimizer's in-place
    update runs on the gathered rows (elementwise, so it is the dense
    update restricted to them) and the rows are written back.  Sentinel
    entries of ``uniq`` read and write the scratch row only."""
    rows_n = store.shape[0]
    idx = uniq.long()

    def row_shaped(leaf):
        return leaf.dim() >= 1 and leaf.shape[0] == rows_n

    rows = store[idx]
    slot_rows = map_slots(lambda s: s[idx] if row_shaped(s) else s,
                          slot_store)
    opt_update(rows, grad_rows, slot_rows, lr, wd, t)
    store.index_put_((idx,), rows)
    for s, r in zip(_leaves(slot_store), _leaves(slot_rows)):
        if row_shaped(s):
            s.index_put_((idx,), r)


def _leaves(slots):
    if slots is None:
        return []
    if isinstance(slots, (tuple, list)):
        return [x for s in slots for x in _leaves(s)]
    return [slots]


def slot_leaves_row_shaped(opt_init, vocab: int, dim: int,
                           dtype=torch.float32) -> bool:
    """Whether an optimizer's fused state for a ``(vocab, dim)`` table
    is entirely row-shaped (every leaf has leading dim vocab), the
    condition for the lazy update to be the dense update restricted to
    the touched rows.  Decided on a meta tensor: nothing is allocated."""
    probe = torch.empty((vocab, dim), dtype=dtype, device="meta")
    return all(leaf.dim() >= 1 and leaf.shape[0] == vocab
               for leaf in _leaves(opt_init(probe)))
