"""EmbeddingTable: a ``(vocab, dim)`` table as a device object
(counterpart of ``mxnet_tpu/embed/table.py``).

Three programs per table, plain functions on tensors (the compile cache
is ROADMAP queue 1 item 11):

* ``lookup(ids)``        deduped gather (``embed/sparse.py``), optional
                         sum/mean pooling with padded ids masked
* ``update(ids, grads)`` deduped sum of the gradients and the lazy
                         per-row optimizer step, in place
* ``accumulate(ids, v)`` the optimizer-free deduped scatter-add (the
                         kvstore's default merge of a push)

The rows live in a ``(vocab + 1, dim)`` storage whose last row is
scratch for the sentinel writes (see ``embed/sparse.py``); ``rows`` is
the view of the first ``vocab``.  The optimizer slots are made for the
storage, so they carry the scratch row too.  Row sharding over a mesh
(``mesh=``/``spec=``) is ROADMAP queue 1 item 10c.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..context import Context, current_context
from ..ndarray import NDArray, torch_dtype
from .sparse import (_leaves, dedup_ids, dedup_lookup, dedup_scatter_add,
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
        if mesh is not None or spec is not None:
            raise NotImplementedError(
                "EmbeddingTable(mesh=, spec=): row sharding is not in the "
                "port yet (ROADMAP.md, queue 1 item 10c)")
        if vocab < 1 or dim < 1:
            raise MXNetError("EmbeddingTable needs vocab, dim >= 1 "
                             "(got %d, %d)" % (vocab, dim))
        self.vocab = int(vocab)
        self.dim = int(dim)
        self.name = name
        self.dtype = np.dtype(dtype)
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
        self._store = torch.zeros((self.vocab + 1, self.dim),
                                  dtype=torch_dtype(self.dtype),
                                  device=self.device)
        self._store[:self.vocab] = torch.as_tensor(
            self._init_rows(initializer))
        if optimizer is not None:
            self.set_optimizer(optimizer)

    # -- construction -------------------------------------------------------
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
        """The table, a view of the storage's first ``vocab`` rows."""
        return self._store[:self.vocab]

    @property
    def slots(self):
        """The optimizer state of the table (views without the scratch
        row), or None."""
        return map_slots(lambda s: s[:self.vocab], self._slot_store)

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
        if not slot_leaves_row_shaped(opt_init, self.vocab, self.dim,
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

    # -- public surface -----------------------------------------------------
    def lookup(self, ids, combiner: Optional[str] = None) -> torch.Tensor:
        """Deduped lookup ``ids (...,) -> (..., dim)``, or pooled over the
        last ids axis with ``combiner="sum"|"mean"`` (padded ids masked;
        the mean divides by the real ids, at least 1)."""
        if combiner not in (None, "sum", "mean"):
            raise MXNetError("combiner must be None|'sum'|'mean', got %r"
                             % (combiner,))
        ids_h = _host(ids)
        n_uniq = self._distinct(ids_h)
        cap = self._cap(ids_h, n_uniq)
        self.stats.note_ids("%s_weight" % self.name, ids_h, n_uniq=n_uniq)
        ids_t = self._ids(ids_h)
        with torch.no_grad():
            out, _uniq, _inv = dedup_lookup(self.rows, ids_t, cap=cap)
            if combiner is None:
                return out
            pooled = torch.sum(out, dim=-2)
            if combiner == "sum":
                return pooled
            n = torch.sum((ids_t >= 0) & (ids_t < self.vocab),
                          dim=-1).to(out.dtype)
            return pooled / torch.clamp(n, min=1).unsqueeze(-1)

    def update(self, ids, grads, lr: Optional[float] = None):
        """Deduped sparse train step: the optimizer on the rows ``ids``
        names, with per-occurrence gradients ``grads`` (``ids.shape +
        (dim,)``).  -> ``rows``."""
        if self._opt_update is None:
            raise MXNetError(
                "EmbeddingTable %r has no optimizer; call set_optimizer "
                "(or use accumulate for optimizer-free scatter-add)"
                % self.name)
        ids_h = _host(ids)
        n_uniq = self._distinct(ids_h)
        cap = self._cap(ids_h, n_uniq)
        g = self._values(grads).reshape(-1, self.dim)
        if g.shape[0] != ids_h.size:
            raise MXNetError("EmbeddingTable %r update: %d gradient rows "
                             "for %d ids" % (self.name, g.shape[0],
                                             ids_h.size))
        self.stats.note_ids("%s_weight" % self.name, ids_h, n_uniq=n_uniq)
        self.stats.note_update("%s_weight" % self.name, cap)
        if lr is None:
            lr = self.optimizer.base_lr()
        t_next = self._t + 1
        with torch.no_grad():
            uniq, inv = dedup_ids(self._ids(ids_h), cap, self.vocab)
            grows = dedup_scatter_add(g, inv, cap)
            sparse_apply_rows(
                self._store, self._slot_store, uniq, grows,
                self._opt_update,
                torch.tensor(float(lr), dtype=torch.float32,
                             device=self.device),
                float(self.optimizer.wd),
                torch.tensor(float(t_next), dtype=torch.float32,
                             device=self.device))
        self._t = t_next
        return self.rows

    def accumulate(self, ids, values):
        """Optimizer-free deduped scatter-add.  -> ``rows``."""
        ids_h = _host(ids)
        n_uniq = self._distinct(ids_h)
        cap = self._cap(ids_h, n_uniq)
        v = self._values(values).reshape(-1, self.dim)
        self.stats.note_ids("%s_weight" % self.name, ids_h, n_uniq=n_uniq)
        with torch.no_grad():
            uniq, inv = dedup_ids(self._ids(ids_h), cap, self.vocab)
            vrows = dedup_scatter_add(v, inv, cap)
            self._store.index_put_((uniq.long(),), vrows, accumulate=True)
        return self.rows

    def set_rows(self, value) -> None:
        """Replace the whole table."""
        arr = _host(value)
        if tuple(arr.shape) != (self.vocab, self.dim):
            raise MXNetError(
                "EmbeddingTable %r set_rows shape %s != (%d, %d)"
                % (self.name, tuple(arr.shape), self.vocab, self.dim))
        self.rows.copy_(torch.as_tensor(arr.astype(self.dtype)))

    def as_numpy(self) -> np.ndarray:
        """The full table on the host."""
        return self.rows.detach().cpu().numpy()

    # -- checkpoint ---------------------------------------------------------
    def state(self) -> dict:
        """``{"rows", "slots", "t"}``, the JAX package's tree (slots
        without the scratch row)."""
        return {"rows": self.rows, "slots": self.slots,
                "t": torch.tensor(self._t, dtype=torch.int32)}

    def restore(self, tree: dict) -> None:
        """Restore from :meth:`state` output of either package (host or
        device leaves).  A tree without slots into an optimizer-armed
        table re-arms fresh slots and the step count 0."""
        self.rows.copy_(self._values(tree["rows"]))
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
            dst[:self.vocab].copy_(self._values(src))
            dst[self.vocab:].zero_()

