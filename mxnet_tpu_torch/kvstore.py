"""KVStore: parameter aggregation (counterpart of
``mxnet_tpu/kvstore.py``).

One process: ``local``, ``local_update_cpu`` and ``local_allreduce_cpu``
keep the stored values where ``init`` put them (the host, for the
module's params); ``device`` and ``local_allreduce_device`` move each
value onto the device of the first value pushed to it, so merge and
update run on the card.  ``_merge`` adds the pushed values in list order
onto ``vals[0]``'s device, the order that makes the sums equal the JAX
package's bit for bit on one device.  ``push`` passes the fault point
``kvstore.push``.

Several processes:

* ``dist_sync``, ``dist_sync_tpu``, ``dist_sync_device``: every rank of
  the process group (``dist.boot``; ``tools/launch.py -n W``) holds a
  replica; ``init`` broadcasts rank 0's value, ``push`` sums the local
  values, all-reduces the sum over the ranks
  (``parallel.collectives``), then ``stored += merged`` or the updater;
  ``barrier`` waits for every rank.  No server processes.
* ``dist_async`` under the parameter-server envs (``tools/launch.py -s
  N``): the worker side of ``ps.py``; servers apply each push at once.
  Without those envs it is the synchronous store, as in the JAX package.

``device_embed`` is the sparse embedding store
(``embed.KVStoreDeviceEmbed``).
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Union

import numpy as np
import torch

from .base import MXNetError, get_env
from .faults import point as _fault_point
from .ndarray import NDArray

__all__ = ["KVStore", "KVStoreDistSync", "KVStoreDistAsync", "create"]

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
                self._combine(stored, merged)

    def _combine(self, stored: NDArray, merged: NDArray) -> None:
        """The store's update without an updater: replace."""
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
        """The optimizer becomes the store's updater; with servers
        (``dist_async``) rank 0 ships it pickled to them (reference
        kvstore.py:231-254)."""
        from . import optimizer as opt_mod
        if self._is_distributed_server_mode():
            if self.rank == 0:
                self._send_command_to_servers(0, pickle.dumps(optimizer))
            self.barrier()
            return
        self._optimizer = optimizer
        self.set_updater(opt_mod.get_updater(optimizer))

    def _is_distributed_server_mode(self):
        return False

    def _send_command_to_servers(self, head, body):
        raise MXNetError("no server processes in %s kvstore" % self._type)

    def barrier(self):
        """One process: nothing to wait for."""

    _barrier = barrier


class KVStoreDistSync(KVStore):
    """Synchronous data-parallel store over the process group
    (reference ``KVStoreDistTPU``): a replica on every rank, pushes
    all-reduced, ``stored += merged`` without an updater (the nightly
    arithmetic relies on it), a replicated updater with one.  One rank
    gives the local semantics with accumulation."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        from .parallel.mesh import make_mesh
        from .dist import boot
        boot.ensure_group()
        self._axis = make_mesh([("dp", -1)]).axis("dp")

    @property
    def rank(self) -> int:
        return self._axis.index

    @property
    def num_workers(self) -> int:
        return self._axis.size

    def init(self, key, value):
        """Rank 0's value wins: broadcast."""
        from .parallel.collectives import broadcast_
        super().init(key, value)
        for k in _key_list(key):
            broadcast_(self._store[k]._get(), self._axis)

    def _merge(self, vals: List[NDArray]) -> torch.Tensor:
        from .parallel.collectives import all_reduce_
        return all_reduce_(super()._merge(vals), self._axis)

    def _combine(self, stored: NDArray, merged: NDArray) -> None:
        stored[:] = stored._get() + merged._get()

    def barrier(self):
        from .parallel.collectives import barrier
        barrier(self._axis)

    _barrier = barrier


class KVStoreDistAsync(KVStore):
    """The worker side of the asynchronous parameter server
    (``ps.PSWorkerClient``; reference ``KVStoreDistAsync``): servers
    apply each push at once, pulls read what they hold."""

    def __init__(self, kv_type="dist_async"):
        super().__init__(kv_type)
        from .ps import PSWorkerClient
        self._client = PSWorkerClient()

    @property
    def rank(self) -> int:
        return self._client.rank

    @property
    def num_workers(self) -> int:
        return get_env("DMLC_NUM_WORKER", 1, int)

    def init(self, key, value):
        """Rank 0's value wins; a barrier so pushes cannot race inits."""
        keys = _key_list(key)
        for k, vs in zip(keys, _val_list(len(keys), value)):
            self._store[k] = vs[0].copy()
            if self.rank == 0:
                self._client.init(k, vs[0].asnumpy())
        self._client.barrier()

    def push(self, key, value, priority=0):
        _fault_point("kvstore.push")
        keys = _key_list(key)
        for k, vs in zip(keys, _val_list(len(keys), value)):
            if k not in self._store:
                raise MXNetError("key %r has not been initialized" % k)
            self._client.push(k, self._merge(vs).detach().cpu().numpy())

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
            ref = self._store[k]
            val = self._client.pull(k, tuple(ref.shape), np.dtype(ref.dtype))
            for o in os_:
                o[:] = val

    def _is_distributed_server_mode(self):
        return True

    def _send_command_to_servers(self, head, body):
        self._client.send_command_to_servers(head, body)

    def barrier(self):
        self._client.barrier()

    _barrier = barrier

    def close(self):
        self._client.close()


def create(name: str = "local", **kwargs):
    """Create a KVStore (reference kvstore.py:341-373); ``device_embed``
    takes the ``KVStoreDeviceEmbed`` keywords (``ctx=``).  ``dist_async``
    is the parameter-server worker when ``DMLC_PS_ROOT_URI`` is set, the
    synchronous store otherwise; every other ``dist*`` name is the
    synchronous store."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name_l = name.lower()
    if name_l == "device_embed":
        from .embed.kvstore import KVStoreDeviceEmbed
        return KVStoreDeviceEmbed("device_embed", **kwargs)
    if name_l == "dist_async" and get_env("DMLC_PS_ROOT_URI", ""):
        return KVStoreDistAsync(name_l)
    if name_l.startswith("dist"):
        return KVStoreDistSync(name_l)
    if name_l in LOCAL_TYPES:
        return KVStore(name_l)
    raise MXNetError("unknown kvstore type %r" % name)
