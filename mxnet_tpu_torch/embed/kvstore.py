"""``kvstore.create("device_embed")``: the seed's pull/push surface over
device-resident embedding tables (counterpart of
``mxnet_tpu/embed/kvstore.py``).

Each sparse key wraps an :class:`~mxnet_tpu_torch.embed.EmbeddingTable`
whose rows and optimizer slots live on the device; dense keys delegate
to a plain ``device`` KVStore, so one store serves a rec model's dense
tower and its tables.

* ``init(key, value)``: a 2-D value of at least ``sparse_bound()`` rows
  (``MXNET_EMBED_SPARSE_BOUND``, 2048) becomes a table; ``sparse=`` says
  so explicitly.
* ``pull(key, out=)``: a sparse key writes its whole table into ``out``.
* ``row_sparse_pull(key, out=, row_ids=)``: the deduped gather of
  ``row_ids`` (out-of-range ids read zero rows).
* ``push(key, (row_ids, values))``: with an optimizer the rows take the
  lazy deduped update, without one the values scatter-add into the
  table.

``mesh=``/``spec=`` row-shard every table (``EmbeddingTable``'s
``mesh``/``spec``, reference ``kvstore.py:61-71``): its pushes, pulls
and row-sparse pulls are then collectives every rank of the axis calls,
each with its own ids; the pushes are summed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..base import MXNetError, get_env
from .table import EmbeddingTable, _host

__all__ = ["KVStoreDeviceEmbed", "sparse_bound"]


def sparse_bound() -> int:
    """Row count from which an init'd 2-D value becomes a table."""
    return get_env("MXNET_EMBED_SPARSE_BOUND", 2048, int)


def _ids_array(row_ids) -> np.ndarray:
    return _host(row_ids).astype(np.int64).reshape(-1)


def _keys(key):
    if isinstance(key, (int, str)):
        return [key], False
    return list(key), True


def _write(dst, value) -> None:
    for d in (dst if isinstance(dst, (list, tuple)) else [dst]):
        d[:] = value


class KVStoreDeviceEmbed:
    """Single-process store with first-class sparse keys (see the module
    docstring).  ``ctx``: where the tables live (default: the current
    context)."""

    def __init__(self, kv_type: str = "device_embed", mesh=None,
                 spec=None, ctx=None):
        from ..kvstore import KVStore
        self._dense = KVStore("device")
        self._type = kv_type
        self._tables = {}
        self._ctx = ctx
        self._mesh = mesh
        self._spec = spec
        self._optimizer = None

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def is_sparse_key(self, key) -> bool:
        return key in self._tables

    def table(self, key) -> EmbeddingTable:
        """The EmbeddingTable behind a sparse key."""
        if key not in self._tables:
            raise MXNetError("key %r is not a sparse embedding key"
                             % (key,))
        return self._tables[key]

    def init(self, key, value, sparse: Optional[bool] = None):
        """Initialize key(s); 2-D values of at least ``sparse_bound()``
        rows (or ``sparse=True``) become tables."""
        keys, multi = _keys(key)
        values = value if multi else [value]
        for k, v in zip(keys, values):
            v0 = v[0] if isinstance(v, (list, tuple)) else v
            arr = _host(v0)
            is_sparse = sparse if sparse is not None else (
                arr.ndim == 2 and arr.shape[0] >= sparse_bound())
            if not is_sparse:
                self._dense.init(k, v)
                continue
            if arr.ndim != 2:
                raise MXNetError(
                    "sparse key %r needs a 2-D (vocab, dim) value, got "
                    "shape %s" % (k, tuple(arr.shape)))
            tab = EmbeddingTable(arr.shape[0], arr.shape[1],
                                 mesh=self._mesh, spec=self._spec,
                                 dtype=arr.dtype, initializer=arr,
                                 name="kv:%s" % k, ctx=self._ctx)
            if self._optimizer is not None:
                tab.set_optimizer(self._optimizer)
            self._tables[k] = tab

    def push(self, key, value, priority=0):
        keys, multi = _keys(key)
        values = value if multi else [value]
        for k, v in zip(keys, values):
            if k not in self._tables:
                self._dense.push(k, v)
                continue
            tab = self._tables[k]
            if not (isinstance(v, tuple) and len(v) == 2):
                raise MXNetError(
                    "sparse key %r push wants the row-sparse form "
                    "(row_ids, values); got %s — use pull/push on a "
                    "dense key for whole-table writes" % (k, type(v)))
            ids = _ids_array(v[0])
            g = _host(v[1])
            if g.shape != (ids.size, tab.dim):
                raise MXNetError(
                    "sparse push %r: values shape %s != (%d, %d)"
                    % (k, tuple(g.shape), ids.size, tab.dim))
            if tab.optimizer is not None:
                tab.update(ids, g)
            else:
                tab.accumulate(ids, g)

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull requires out=")
        keys, multi = _keys(key)
        outs = out if multi else [out]
        for k, o in zip(keys, outs):
            if k not in self._tables:
                self._dense.pull(k, out=o)
                continue
            _write(o, self._tables[k].as_numpy())

    def row_sparse_pull(self, key, out=None, row_ids=None, priority=0):
        """``out`` receives the rows of ``row_ids`` (out-of-range ids
        read zero rows)."""
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull requires out= and row_ids=")
        keys, multi = _keys(key)
        outs = out if multi else [out]
        idss = row_ids if multi else [row_ids]
        for k, o, ids in zip(keys, outs, idss):
            if k not in self._tables:
                raise MXNetError(
                    "row_sparse_pull on dense key %r (init it with "
                    "sparse=True or >= %d rows)" % (k, sparse_bound()))
            rows = self._tables[k].lookup(_ids_array(ids))
            _write(o, rows.cpu().numpy())

    def set_optimizer(self, optimizer):
        """Sparse keys take the lazy deduped update on push; dense keys
        the classic per-key updater."""
        self._optimizer = optimizer
        for tab in self._tables.values():
            tab.set_optimizer(optimizer)
        self._dense.set_optimizer(optimizer)

    def set_updater(self, updater):
        # dense keys only: the sparse update is the table's own
        self._dense.set_updater(updater)

    _set_updater = set_updater

    def barrier(self):
        pass

    _barrier = barrier

    def save_state(self) -> dict:
        """``{key: table state}`` for every sparse key (rows, slots,
        step)."""
        return {str(k): t.state() for k, t in self._tables.items()}

    def load_state(self, tree: dict) -> None:
        for k, t in self._tables.items():
            if str(k) in tree:
                t.restore(tree[str(k)])
