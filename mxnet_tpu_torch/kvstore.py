"""KVStore: parameter aggregation over several devices of one process
(counterpart of ``mxnet_tpu/kvstore.py``'s local modes).

``local``, ``local_update_cpu`` and ``local_allreduce_cpu`` keep the
stored values where ``init`` put them (the host, for the module's
params); ``device`` and ``local_allreduce_device`` move each value onto
the device of the first value pushed to it, so merge and update run on
the card.  ``_merge`` adds the pushed values in list order onto
``vals[0]``'s device, the order that makes the sums equal the JAX
package's bit for bit on one device.  ``push`` passes the fault point
``kvstore.push``.

``device_embed`` is the sparse embedding store
(``embed.KVStoreDeviceEmbed``).  The dist modes wait for scale-out
(ROADMAP.md, queue 1 item 10) and raise.
"""
from __future__ import annotations

from typing import Dict, List, Union

import torch

from .base import MXNetError
from .faults import point as _fault_point
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
               "device", "local_allreduce_device")


def _key_list(key):
    if isinstance(key, (int, str)):
        return [key]
    return list(key)


def _val_list(key_count, vals):
    """Normalize to list-of-lists: per key, the list of per-device
    values."""
    if isinstance(vals, NDArray):
        return [[vals]]
    assert isinstance(vals, (list, tuple))
    if key_count == 1 and all(isinstance(v, NDArray) for v in vals):
        return [list(vals)]
    return [[v] if isinstance(v, NDArray) else list(v) for v in vals]


class KVStore:
    """Key-value store of one process (reference kvstore.py:38)."""

    def __init__(self, kv_type: str = "local"):
        self._type = kv_type
        self._store: Dict[Union[int, str], NDArray] = {}
        self._updater = None
        self._optimizer = None
        self._on_device = "device" in kv_type

    @property
    def type(self) -> str:
        return self._type

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def init(self, key, value):
        """Store a copy of each key's (first) value."""
        keys = _key_list(key)
        for k, vs in zip(keys, _val_list(len(keys), value)):
            self._store[k] = vs[0].copy()

    def _merge(self, vals: List[NDArray]) -> torch.Tensor:
        """Sum a per-device value list onto ``vals[0]``'s device, in list
        order (reference kvstore.py:95-106)."""
        acc = vals[0]._get()
        if len(vals) == 1:
            return acc.clone()
        for v in vals[1:]:
            acc = acc + v._get().to(acc.device, non_blocking=True)
        return acc

    def push(self, key, value, priority=0):
        _fault_point("kvstore.push")
        keys = _key_list(key)
        for k, vs in zip(keys, _val_list(len(keys), value)):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % k)
            merged = self._merge(vs)
            stored = self._store[k]
            if self._on_device and stored._get().device != merged.device:
                # the device modes keep the value where the merge runs
                stored = self._store[k] = NDArray(
                    stored._get().to(merged.device))
            merged = NDArray(merged.to(stored._get().device))
            if self._updater is not None:
                self._updater(k, merged, stored)
            else:
                stored[:] = merged

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull requires out=")
        keys = _key_list(key)
        if isinstance(out, NDArray):
            outs = [[out]]
        elif len(keys) == 1 and all(isinstance(o, NDArray) for o in out):
            outs = [list(out)]
        else:
            outs = [[o] if isinstance(o, NDArray) else list(o) for o in out]
        for k, os_ in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % k)
            for o in os_:
                self._store[k].copyto(o)

    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """The optimizer becomes the store's updater (reference
        kvstore.py:231-254 ships it to servers in the dist modes)."""
        from . import optimizer as opt_mod
        self._optimizer = optimizer
        self.set_updater(opt_mod.get_updater(optimizer))

    def barrier(self):
        """One process: nothing to wait for."""


def create(name: str = "local", **kwargs):
    """Create a KVStore (reference kvstore.py:341-373); ``device_embed``
    takes the ``KVStoreDeviceEmbed`` keywords (``ctx=``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name_l = name.lower()
    if name_l == "device_embed":
        from .embed.kvstore import KVStoreDeviceEmbed
        return KVStoreDeviceEmbed("device_embed", **kwargs)
    if name_l.startswith("dist"):
        raise NotImplementedError(
            "kvstore %r is not in the port yet (ROADMAP.md, queue 1 item "
            "10); one process takes 'local' or 'device'" % name)
    if name_l in LOCAL_TYPES:
        return KVStore(name_l)
    raise MXNetError("unknown kvstore type %r" % name)
