"""EmbeddingTable: a ``(vocab, dim)`` table as a device object
(counterpart of ``mxnet_tpu/embed/table.py``).

Three programs per table, plain functions on tensors (eager PyTorch
calls: nothing for the compile cache to build or keep):

* ``lookup(ids)``        deduped gather (``embed/sparse.py``), optional
                         sum/mean pooling with padded ids masked
* ``update(ids, grads)`` deduped sum of the gradients and the lazy
                         per-row optimizer step, in place
* ``accumulate(ids, v)`` the optimizer-free deduped scatter-add (the
                         kvstore's default merge of a push)

The rows live in a ``(vocab + 1, dim)`` storage whose last row is
scratch for the sentinel writes (see ``embed/sparse.py``); ``rows`` is
the view of the first ``vocab``.  The optimizer slots are made for the
storage, so they carry the scratch row too.

**Row sharding** (``mesh=``/``spec=``, reference ``table.py:79-146``):
each rank of the spec's axis stores its block of ``vocab / n`` rows (and
its slots), plus a scratch row of its own; ``rows`` is that block.
``lookup``, ``update`` and ``accumulate`` are then collectives over the
axis: every rank calls them, each with its own ids (and gradients), and
the result is one device's over the ranks' ids concatenated in axis
order.  The ids are all-gathered and deduped alike on every rank (the
unique cap resolved against the whole batch, as on one device); each
owner gathers, or updates, the unique rows that fall in its block and
the rows are summed over the axis (the other ranks give zeros), so each
rank gets its ids' rows back in its own order, and each owner applies
the summed gradients of its rows.  ``as_numpy``, ``state`` and
``restore`` carry the whole table as numpy, so a table saved on one
mesh restores onto another or into one process.  The collectives go
through ``parallel/collectives.py`` (gloo's host staging or NCCL).

``lookup`` is an ``embed:lookup`` trace span and ``update`` /
``accumulate`` an ``embed:update`` one (host time; under a CUDA graph
capture none is recorded).
"""
from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch

from .. import trace as _trace
from ..base import MXNetError, get_env
from ..context import Context, current_context
from ..ndarray import NDArray, torch_dtype
from .sparse import (_leaves, block_rows, dedup_ids, dedup_scatter_add,
                     map_slots, resolve_cap, slot_leaves_row_shaped,
                     sparse_apply_rows)
from .stats import EmbedStats

__all__ = ["EmbeddingTable"]


def _host(x) -> np.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class EmbeddingTable:
    """Device-resident embedding table.

    ``vocab``, ``dim``: the geometry; ids outside ``[0, vocab)`` read as
    zero vectors and their updates drop.  ``dtype``: the row dtype
    (float32).  ``unique_cap``: distinct real ids a batch may hold (a
    sentinel slot is reserved on top; 0/None, or
    ``MXNET_EMBED_UNIQUE_CAP``, is the safe worst case); a batch past it
    raises under ``MXNET_EMBED_CHECK_CAP`` (default on).  ``optimizer``:
    one with a fused form and row-shaped state (SGD, NAG, AdaGrad,
    Adam); arms ``update``.  ``ctx``: where the table lives (default: the
    current context, the card).
    """

    def __init__(self, vocab: int, dim: int, mesh=None, spec=None,
                 dtype=np.float32, unique_cap: Optional[int] = None,
                 optimizer=None, initializer=None, name: str = "embed",
                 ctx: Optional[Context] = None):
        if vocab < 1 or dim < 1:
            raise MXNetError("EmbeddingTable needs vocab, dim >= 1 "
                             "(got %d, %d)" % (vocab, dim))
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.name = name
        self.dtype = np.dtype(dtype)
        self.mesh = mesh
        # the axis owning the row blocks, this rank's first row and the
        # block size (the whole table without a mesh)
        self._axis = self._row_axis(mesh, spec)
        n = self._axis.size if self._axis is not None else 1
        self._block = self.vocab // n
        self._lo = self._axis.index * self._block \
            if self._axis is not None else 0
        ctx = ctx if ctx is not None else current_context()
        self.device = ctx.torch_device()
        if unique_cap is None:
            unique_cap = get_env("MXNET_EMBED_UNIQUE_CAP", 0, int)
        self.unique_cap = int(unique_cap) or None
        self._check_cap = get_env("MXNET_EMBED_CHECK_CAP", True, bool)
        self.stats = EmbedStats(name)
        from .. import profiler
        profiler.register_embed_stats(self.stats)
        self._t = 0
        self.optimizer = None
        self._opt_update = None
        self._opt_init = None
        self._slot_store = None
        self._store = torch.zeros((self._block + 1, self.dim),
                                  dtype=torch_dtype(self.dtype),
                                  device=self.device)
        self._store[:self._block] = torch.as_tensor(
            self._init_rows(initializer)[self._lo:self._lo + self._block])
        if optimizer is not None:
            self.set_optimizer(optimizer)

    # -- construction -------------------------------------------------------
    def _row_axis(self, mesh, spec):
        """The mesh axis the rows are cut over (None: no mesh), checked as
        the reference checks it (reference ``table.py:129-146``)."""
        if mesh is None:
            if spec is not None:
                raise MXNetError("EmbeddingTable spec= without mesh=")
            return None
        from ..parallel.mesh import (Mesh, PartitionSpec, make_mesh,
                                     normalize_spec, spec_pairs,
                                     validate_spec)
        if not isinstance(mesh, Mesh):
            mesh = self.mesh = make_mesh(mesh)
        if spec is None:
            spec = PartitionSpec(mesh.axis_names[0], None)
        elif isinstance(spec, str) and "," not in spec:
            spec = PartitionSpec(spec, None)
        else:
            spec = normalize_spec(spec)
        validate_spec("%s_weight" % self.name, spec, mesh,
                      shape=(self.vocab, self.dim))
        self.row_spec = spec
        pairs = spec_pairs(spec, 2)
        if not pairs:
            return None
        if len(pairs) != 1 or pairs[0][0] != 0:
            raise MXNetError(
                "EmbeddingTable %r spec %s: the port shards a table's rows "
                "over one mesh axis, (axis, None)" % (self.name,
                                                      tuple(spec)))
        return mesh.axis(pairs[0][1])
    def _init_rows(self, initializer) -> np.ndarray:
        if initializer is None:
            return np.zeros((self.vocab, self.dim), self.dtype)
        if callable(initializer):
            from ..context import cpu
            from ..ndarray import zeros
            out = zeros((self.vocab, self.dim), ctx=cpu())
            initializer("%s_weight" % self.name, out)
            return out.asnumpy().astype(self.dtype)
        arr = _host(initializer)
        if tuple(arr.shape) != (self.vocab, self.dim):
            raise MXNetError(
                "EmbeddingTable %r init value shape %s != (%d, %d)"
                % (self.name, tuple(arr.shape), self.vocab, self.dim))
        return arr.astype(self.dtype)

    @property
    def rows(self) -> torch.Tensor:
        """The rows this rank stores, a view of the storage without its
        scratch row: the table, or this rank's block of a row-sharded
        one."""
        return self._store[:self._block]

    @property
    def slots(self):
        """The optimizer state of :attr:`rows` (views without the scratch
        row), or None."""
        return map_slots(lambda s: s[:self._block], self._slot_store)

    def set_optimizer(self, optimizer) -> None:
        """Arm the sparse update with ``optimizer``'s fused form, taken
        now (re-call after changing its hyperparameters); its state must
        be row-shaped.  Fresh slots, and the step count back to 0."""
        fused = optimizer.fused_update_fn()
        if fused is None:
            raise MXNetError(
                "optimizer %s has no fused functional form; the sparse "
                "embedding update needs one" % type(optimizer).__name__)
        opt_init, opt_update = fused
        if not slot_leaves_row_shaped(opt_init, self._block, self.dim,
                                      torch_dtype(self.dtype)):
            raise MXNetError(
                "optimizer %s state for a (%d, %d) table is not row-"
                "shaped; the lazy per-row sparse update cannot express "
                "it — use SGD/NAG/Adagrad/Adam or the dense path"
                % (type(optimizer).__name__, self.vocab, self.dim))
        self.optimizer = optimizer
        self._opt_update = opt_update
        self._opt_init = opt_init
        self._slot_store = opt_init(self._store)
        self._t = 0

    # -- helpers ------------------------------------------------------------
    def _distinct(self, ids_h: np.ndarray) -> int:
        """Distinct dedup-buffer values of a host batch: in-range ids
        once each, every out-of-range id the one sentinel."""
        flat = ids_h.reshape(-1).astype(np.int64)
        return int(np.unique(
            np.where((flat < 0) | (flat >= self.vocab), self.vocab,
                     flat)).size)

    def _cap(self, ids_h: np.ndarray, n_distinct: int) -> int:
        cap = resolve_cap(self.unique_cap, ids_h.size, self.vocab)
        if self._check_cap and self.unique_cap is not None \
                and n_distinct > cap:
            raise MXNetError(
                "EmbeddingTable %r: batch holds %d distinct ids "
                "(out-of-range ids count as one) but unique_cap=%d "
                "admits only %d dedup slots; the dedup would truncate "
                "and corrupt the result.  Raise unique_cap / "
                "MXNET_EMBED_UNIQUE_CAP (0 = safe worst case), or "
                "set MXNET_EMBED_CHECK_CAP=0 to run unchecked."
                % (self.name, n_distinct, self.unique_cap, cap))
        return cap

    def _ids(self, ids_h: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(ids_h.astype(np.int64)).to(self.device)

    def _values(self, v) -> torch.Tensor:
        t = v._get() if isinstance(v, NDArray) else torch.as_tensor(
            v if isinstance(v, torch.Tensor) else np.asarray(v))
        return t.to(device=self.device, dtype=self._store.dtype)

    def _batch(self, ids):
        """-> (the ids of every rank of the axis, concatenated in axis
        order, on the host; where this rank's start; how many it has).
        Without a mesh, this call's ids."""
        ids_h = _host(ids).reshape(-1).astype(np.int64)
        if self._axis is None or self._axis.size < 2:
            return ids_h, 0, ids_h.size
        from ..parallel.collectives import _gather_raw
        ax = self._axis
        sizes = _gather_raw(torch.tensor([ids_h.size], dtype=torch.int64),
                            ax, 0).tolist()
        pad = np.zeros(max(sizes), np.int64)
        pad[:ids_h.size] = ids_h
        every = _gather_raw(torch.from_numpy(pad), ax, 0).numpy()
        parts = [every[r * len(pad):r * len(pad) + n]
                 for r, n in enumerate(sizes)]
        return np.concatenate(parts), int(sum(sizes[:ax.index])), \
            ids_h.size

    def _dedup(self, ids, lookup: bool = False):
        """The dedup of the axis's whole batch: -> (uniq, inv of this
        call's ids, cap).  A lookup resolves the checked cap once more
        (a sentinel slot on top), as the reference's lookup program
        does."""
        every, off, n = self._batch(ids)
        n_uniq = self._distinct(every)
        cap = self._cap(every, n_uniq)
        self.stats.note_ids("%s_weight" % self.name, every, n_uniq=n_uniq)
        k = resolve_cap(cap, every.size, self.vocab) if lookup else cap
        uniq, inv = dedup_ids(self._ids(every), k, self.vocab)
        return uniq, inv[off:off + n], cap

    def _local(self, uniq: torch.Tensor):
        """-> (each unique id's row in this rank's storage, the owned
        mask or None): ids of other ranks' blocks, and the sentinel,
        index the scratch row."""
        if self._axis is None:
            return uniq.long(), None
        return block_rows(uniq, self._lo, self._block)

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the row axis, in place (a no-op without)."""
        if self._axis is not None and self._axis.size > 1:
            from ..parallel.collectives import all_reduce_
            all_reduce_(t, self._axis)
        return t

    def _unique_rows(self, uniq: torch.Tensor) -> torch.Tensor:
        """The unique ids' rows (out-of-range ids zero): from the owners,
        summed over the axis."""
        idx, own = self._local(uniq)
        rows = self._store[idx]
        ok = (uniq >= 0) & (uniq < self.vocab)
        if own is not None:
            ok = ok & own
        return self._sum(torch.where(ok.unsqueeze(-1), rows,
                                     torch.zeros_like(rows)))

    # -- public surface -----------------------------------------------------
    def _traced(self, name: str, t0: float) -> None:
        if not (self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _trace.complete(name, t0, _time.perf_counter() - t0,
                            cat="embed")

    def lookup(self, ids, combiner: Optional[str] = None) -> torch.Tensor:
        """Deduped lookup ``ids (...,) -> (..., dim)``, or pooled over the
        last ids axis with ``combiner="sum"|"mean"`` (padded ids masked;
        the mean divides by the real ids, at least 1).  Row-sharded:
        every rank of the axis calls it, each with its own ids."""
        if combiner not in (None, "sum", "mean"):
            raise MXNetError("combiner must be None|'sum'|'mean', got %r"
                             % (combiner,))
        t0 = _time.perf_counter()
        out = self._lookup(ids, combiner)
        self._traced("embed:lookup", t0)
        return out

    def _lookup(self, ids, combiner):
        shape = tuple(_host(ids).shape)
        with torch.no_grad():
            uniq, inv, _cap = self._dedup(ids, lookup=True)
            from ..ops.tensor import embedding
            out = embedding(inv, self._unique_rows(uniq)).reshape(
                shape + (self.dim,))
            if combiner is None:
                return out
            ids_t = self._ids(_host(ids))
            pooled = torch.sum(out, dim=-2)
            if combiner == "sum":
                return pooled
            n = torch.sum((ids_t >= 0) & (ids_t < self.vocab),
                          dim=-1).to(out.dtype)
            return pooled / torch.clamp(n, min=1).unsqueeze(-1)

    def update(self, ids, grads, lr: Optional[float] = None):
        """Deduped sparse train step: the optimizer on the rows ``ids``
        names, with per-occurrence gradients ``grads`` (``ids.shape +
        (dim,)``).  Row-sharded: every rank of the axis calls it with its
        own ids and gradients; their sum is applied.  -> ``rows``."""
        if self._opt_update is None:
            raise MXNetError(
                "EmbeddingTable %r has no optimizer; call set_optimizer "
                "(or use accumulate for optimizer-free scatter-add)"
                % self.name)
        size = int(np.prod(_host(ids).shape))
        g = self._values(grads).reshape(-1, self.dim)
        if g.shape[0] != size:
            raise MXNetError("EmbeddingTable %r update: %d gradient rows "
                             "for %d ids" % (self.name, g.shape[0], size))
        if lr is None:
            lr = self.optimizer.base_lr()
        t_next = self._t + 1
        t0 = _time.perf_counter()
        with torch.no_grad():
            uniq, inv, cap = self._dedup(ids)
            self.stats.note_update("%s_weight" % self.name, cap)
            grows = self._sum(dedup_scatter_add(g, inv, cap))
            idx, _own = self._local(uniq)
            sparse_apply_rows(
                self._store, self._slot_store, idx, grows,
                self._opt_update,
                torch.tensor(float(lr), dtype=torch.float32,
                             device=self.device),
                float(self.optimizer.wd),
                torch.tensor(float(t_next), dtype=torch.float32,
                             device=self.device))
        self._t = t_next
        self._traced("embed:update", t0)
        return self.rows

    def accumulate(self, ids, values):
        """Optimizer-free deduped scatter-add (row-sharded: every rank
        of the axis adds its own).  -> ``rows``."""
        v = self._values(values).reshape(-1, self.dim)
        t0 = _time.perf_counter()
        with torch.no_grad():
            uniq, inv, cap = self._dedup(ids)
            vrows = self._sum(dedup_scatter_add(v, inv, cap))
            idx, _own = self._local(uniq)
            self._store.index_put_((idx,), vrows, accumulate=True)
        self._traced("embed:update", t0)
        return self.rows

    def set_rows(self, value) -> None:
        """Replace the whole table (each rank keeps its block)."""
        arr = _host(value)
        if tuple(arr.shape) != (self.vocab, self.dim):
            raise MXNetError(
                "EmbeddingTable %r set_rows shape %s != (%d, %d)"
                % (self.name, tuple(arr.shape), self.vocab, self.dim))
        self.rows.copy_(torch.as_tensor(
            arr[self._lo:self._lo + self._block].astype(self.dtype)))

    def _whole(self, t: torch.Tensor) -> np.ndarray:
        """A block-shaped leaf gathered whole over the axis, on the
        host."""
        t = t.detach()
        if self._axis is not None and self._axis.size > 1:
            from ..parallel.collectives import _gather_raw
            t = _gather_raw(t.contiguous(), self._axis, 0)
        return t.cpu().numpy()

    def as_numpy(self) -> np.ndarray:
        """The full table on the host (row-sharded: gathered, a
        collective every rank of the axis calls)."""
        return self._whole(self.rows)

    # -- checkpoint ---------------------------------------------------------
    def state(self) -> dict:
        """``{"rows", "slots", "t"}``, the JAX package's tree (slots
        without the scratch row).  Row-sharded: the whole table and
        slots as numpy, gathered (a collective every rank calls)."""
        if self._axis is None:
            return {"rows": self.rows, "slots": self.slots,
                    "t": torch.tensor(self._t, dtype=torch.int32)}
        return {"rows": self._whole(self.rows),
                "slots": map_slots(self._whole, self.slots),
                "t": np.asarray(self._t, np.int32)}

    def _mine(self, x) -> torch.Tensor:
        """A whole leaf's rows of this rank's block (a leaf of the
        block's shape as it is)."""
        t = self._values(x)
        if t.shape[0] == self.vocab and self._block != self.vocab:
            t = t[self._lo:self._lo + self._block]
        return t

    def restore(self, tree: dict) -> None:
        """Restore from :meth:`state` output of either package (host or
        device leaves; whole, or this rank's block), onto this table's
        layout: a table saved on one mesh restores onto another.  A tree
        without slots into an optimizer-armed table re-arms fresh slots
        and the step count 0."""
        self.rows.copy_(self._mine(tree["rows"]))
        slots = tree.get("slots")
        if slots is not None and self.optimizer is None:
            raise MXNetError(
                "EmbeddingTable %r restore carries optimizer slots but "
                "no optimizer is set; call set_optimizer first"
                % self.name)
        self._t = int(_host(tree.get("t", 0)))
        if self.optimizer is None:
            return
        if slots is None:
            self._slot_store = self._opt_init(self._store)
            self._t = 0
            return
        live = _leaves(self._slot_store)
        saved = _leaves(tuple(slots) if isinstance(slots, list)
                        else slots)
        if len(live) != len(saved):
            raise MXNetError("EmbeddingTable %r restore: %d slot leaves "
                             "for an optimizer with %d"
                             % (self.name, len(saved), len(live)))
        for dst, src in zip(live, saved):
            dst[:self._block].copy_(self._mine(src))
            dst[self._block:].zero_()

