"""Full train-state capture and restore for Module (counterpart of
``mxnet_tpu/checkpoint/module_state.py``, in its schema, so either
package restores the other's checkpoints).

Everything the next step depends on:

* params / aux / fixed params: the fused step's device state when it is
  engaged (the copy from before a pending speculative step, when there
  is one), else the host param dicts;
* optimizer slots (momentum, Adam's m and v): the fused state's ``opt``
  tree, or the classic updater's per-index states keyed by param name,
  so a fused save restores into a classic module and back;
* the schedule: ``optimizer.num_update``, the per-param update counts
  and ``lr_scheduler.state_dict()``;
* the random stream.  The JAX package keeps threefry key data under
  ``rng``; the port's generators are Philox (card) and Mersenne Twister
  (host), whose streams differ (ROADMAP.md parity rules).  The port
  writes a threefry-shaped ``rng`` leaf (two uint32 words of its seed)
  that the JAX package can load, its generator's own state under
  ``rng_state``, and tags the checkpoint ``rng_package``.  Restoring the
  other package's checkpoint takes everything else and re-seeds from the
  key data, with a log line.

The tree is ``{"params", "fixed", "aux", "opt", "rng"}`` (plus the port's
``rng_state``), every scalar in ``meta``.

Sharded state (a fused step over a mesh with specs, or the sharded
weight update): a capture for a checkpoint carries each cut leaf as
this rank's ``sharded.ShardedLeaf`` (its index in the whole, and
whether this rank writes it); ``gather=True`` (a re-mesh) gathers every
leaf whole instead.  A restore cuts whole values to the live layout,
and ``restore_module`` asks the store for this rank's slices only.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["capture_train_state", "restore_train_state", "save_module",
           "restore_module"]

STATE_FORMAT = 1
RNG_PACKAGE = "mxnet_tpu_torch"
_LOG = logging.getLogger("mxnet_tpu_torch.checkpoint")


def _updater_of(module):
    upd = getattr(module, "_updater", None)
    if upd is None and getattr(module, "_update_on_kvstore", False):
        upd = getattr(getattr(module, "_kvstore", None), "_updater", None)
    return upd


def _name_index(module, i: int) -> int:
    """The classic updater's index of param i's first device copy (the
    ``idx * num_device + dev`` convention of model._update_params)."""
    if getattr(module, "_update_on_kvstore", False):
        return i
    return i * len(getattr(module, "_context", [None]))


def _to_tensor(x):
    from ..ndarray import NDArray
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_to_tensor(e) for e in x)
    if isinstance(x, NDArray):
        return x._get()
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _rng_device(module):
    ctx = getattr(module, "_context", None)
    return ctx[0].torch_device() if ctx else torch.device("cpu")


def _rng_leaves(module) -> Dict[str, Any]:
    from .. import random as _random
    gen = _random.generator(_rng_device(module))
    seed = int(gen.initial_seed()) & 0xFFFFFFFFFFFFFFFF
    key = np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)
    return {"rng": key, "rng_state": gen.get_state()}


def _shard_leaves(fused, tree: Dict) -> Dict:
    """The cut leaves of a fused state tree as ``ShardedLeaf``s."""
    from ..parallel.mesh import shard_index, writes_shard
    from .sharded import ShardedLeaf
    from .snapshot import map_structure

    def wrap(g, n, t):
        if not fused._is_cut(g, n, t):
            return t
        cuts = fused.leaf_cuts(g, n)
        shape = fused._global[n]
        return ShardedLeaf(t, shape, shard_index(shape, cuts, fused.mesh),
                           writes_shard(cuts, fused.mesh))
    return {g: {n: map_structure(lambda t, _g=g, _n=n: wrap(_g, _n, t), v)
                for n, v in tree[g].items()} for g in tree}


def capture_train_state(module, extra_meta: Optional[Dict] = None,
                        gather: bool = False) -> Tuple[Dict, Dict]:
    """-> (tree, meta): the module's complete train state.  A sharded
    fused state's cut leaves come as this rank's ``ShardedLeaf``s, or
    gathered whole with ``gather=True`` (a collective: every rank
    calls it)."""
    assert module.binded and module.params_initialized, \
        "capture_train_state needs a bound, initialized module"
    opt = getattr(module, "_optimizer", None)
    meta: Dict[str, Any] = {"state_format": STATE_FORMAT,
                            "rng_package": RNG_PACKAGE}
    if opt is not None:
        meta["optimizer"] = type(opt).__name__
        meta["num_update"] = int(opt.num_update)
        sched = getattr(opt, "lr_scheduler", None)
        if sched is not None:
            meta["lr_scheduler"] = sched.state_dict()
    fused = getattr(module, "_fused", None)
    if fused is not None and fused.state is not None:
        st = module._spec_state() or fused.state
        if gather and fused.sharded:
            tree = fused.gathered_state(st)
        else:
            tree = {"params": {n: t.detach()
                               for n, t in st["params"].items()},
                    "fixed": dict(st["fixed"]), "aux": dict(st["aux"]),
                    "opt": dict(st["opt"])}
            if fused.sharded:
                tree = _shard_leaves(fused, tree)
        meta["state_path"] = "fused"
        meta["t"] = int(module._fused_t)
    else:
        arg_params, aux_params = module.get_params()
        tree = {"params": {n: v._get() for n, v in arg_params.items()},
                "fixed": {}, "aux": {n: v._get()
                                     for n, v in aux_params.items()},
                "opt": {}}
        meta["state_path"] = "classic"
        updater = _updater_of(module)
        if updater is not None and getattr(updater, "states", None):
            counts = {}
            for i, n in enumerate(module._param_names):
                idx = _name_index(module, i)
                st = updater.states.get(idx)
                if st is not None:
                    tree["opt"][n] = _to_tensor(st)
                if opt is not None and idx in opt._index_update_count:
                    counts[n] = int(opt._index_update_count[idx])
            meta["index_update_count"] = counts
    tree.update(_rng_leaves(module))
    meta.update(extra_meta or {})
    return tree, meta


# -- restore ------------------------------------------------------------------

def _lookup(tree: Dict, group: str, name: str):
    val = (tree.get(group) or {}).get(name)
    if val is None and group == "params":
        val = (tree.get("fixed") or {}).get(name)
    if val is None and group == "fixed":
        val = (tree.get("params") or {}).get(name)
    return val


def _copy_into(live, value, name):
    """Write ``value`` into the live tensor(s) ``live`` in place (the
    captured graphs read those buffers)."""
    if isinstance(live, (tuple, list)):
        if not isinstance(value, (tuple, list)) or len(value) != len(live):
            raise MXNetError(
                "optimizer state structure mismatch for %r: saved %r vs "
                "live %r (was the optimizer changed between save and "
                "resume?)" % (name, type(value).__name__,
                              type(live).__name__))
        for a, b in zip(live, value):
            _copy_into(a, b, name)
        return
    if isinstance(value, (tuple, list)):
        raise MXNetError(
            "optimizer state structure mismatch for %r: saved %r vs live "
            "tensor (was the optimizer changed between save and resume?)"
            % (name, type(value).__name__))
    live.detach().copy_(_to_tensor(value).to(live.device, live.dtype))


def _restore_rng(module, tree: Dict, meta: Dict) -> None:
    from .. import random as _random
    gen = _random.generator(_rng_device(module))
    if meta.get("rng_package") == RNG_PACKAGE and \
            tree.get("rng_state") is not None:
        state = _to_tensor(tree["rng_state"]).to("cpu", torch.uint8)
        gen.set_state(state.contiguous())
        return
    if tree.get("rng") is None:
        return
    kd = tree["rng"]
    kd = (kd.numpy() if isinstance(kd, torch.Tensor) else np.asarray(kd))
    kd = kd.astype(np.uint64).ravel()
    seed = int(kd[-1]) | (int(kd[0]) << 32 if kd.size > 1 else 0)
    _LOG.info("checkpoint random state is another package's (threefry "
              "key data); re-seeding the %s generator from it",
              _rng_device(module).type)
    gen.manual_seed(seed)


def _local(fused, group: str, name: str, value):
    """``value`` (a leaf or a slot tuple) cut to the live layout."""
    if not fused.sharded or value is None:
        return value
    if isinstance(value, (tuple, list)):
        return type(value)(_local(fused, group, name, v) for v in value)
    return fused.shard_of(group, name, _to_tensor(value))


def _restore_fused(module, tree: Dict, meta: Dict) -> None:
    fused = module._fused
    module._discard_speculation()
    st = fused.state
    with torch.no_grad():
        for group in ("params", "fixed", "aux"):
            for n, live in st[group].items():
                val = _lookup(tree, group, n)
                if val is None:
                    raise MXNetError(
                        "checkpoint is missing %s %r; cannot resume "
                        "bitwise-consistently" % (group, n))
                _copy_into(live, _local(fused, group, n, val), n)
        saved_opt = tree.get("opt") or {}
        for n, live in st["opt"].items():
            if live is None:
                continue
            if saved_opt.get(n) is None:
                raise MXNetError(
                    "checkpoint has no optimizer state for %r; resuming "
                    "would silently reset its slots (save with the same "
                    "optimizer, or restore params only via load_params)"
                    % n)
            _copy_into(live, _local(fused, "opt", n, saved_opt[n]), n)
        t = int(meta.get("t", meta.get("num_update", 0)))
        st["t"].fill_(float(t))
    module._fused_t = t
    module._fused_pending = None
    module._fused_outputs = None
    module._fused_copies = None
    module._params_dirty = True


def _restore_classic(module, tree: Dict, meta: Dict) -> None:
    from ..ndarray import NDArray

    def nd(v):
        return NDArray(_to_tensor(v).detach().to("cpu", copy=True))

    arg_params = {n: nd(v) for group in ("params", "fixed")
                  for n, v in (tree.get(group) or {}).items()}
    aux_params = {n: nd(v) for n, v in (tree.get("aux") or {}).items()}
    module.set_params(arg_params, aux_params)
    opt = getattr(module, "_optimizer", None)
    updater = _updater_of(module)
    saved_opt = tree.get("opt") or {}
    counts = meta.get("index_update_count") or {}
    if not counts and meta.get("t"):
        # a fused save: one step count for every param
        counts = {n: int(meta["t"]) for n in saved_opt}
    if updater is None:
        return
    num_dev = len(getattr(module, "_context", [None]))
    for i, n in enumerate(module._param_names):
        if n not in saved_opt:
            continue
        if getattr(module, "_update_on_kvstore", False):
            targets = [(i, module._kvstore._store[i])]
        else:
            targets = [(i * num_dev + dev,
                        module._exec_group.param_arrays[i][dev])
                       for dev in range(num_dev)]
        for idx, like in targets:
            def to_nd(x):
                if x is None:
                    return None
                if isinstance(x, (tuple, list)):
                    return tuple(to_nd(e) for e in x)
                return NDArray(_to_tensor(x).detach().to(
                    like._get().device, copy=True))
            updater.states[idx] = to_nd(saved_opt[n])
            if opt is not None and n in counts:
                opt._index_update_count[idx] = int(counts[n])


def restore_train_state(module, tree: Dict, meta: Dict) -> None:
    """Install a captured train state into a bound module, on either
    path (fused or classic, whichever saved it)."""
    assert module.binded and module.params_initialized, \
        "restore_train_state needs a bound, initialized module"
    meta = meta or {}
    opt = getattr(module, "_optimizer", None)
    if getattr(module, "_fused", None) is not None and \
            module.optimizer_initialized:
        _restore_fused(module, tree, meta)
    else:
        _restore_classic(module, tree, meta)
    _restore_rng(module, tree, meta)
    if opt is not None:
        if "num_update" in meta:
            opt.num_update = int(meta["num_update"])
        sched = getattr(opt, "lr_scheduler", None)
        if sched is not None and meta.get("lr_scheduler"):
            sched.load_state_dict(meta["lr_scheduler"])


def save_module(manager, module, step: int, meta: Optional[Dict] = None,
                blocking: Optional[bool] = None) -> None:
    """Capture ``module``'s train state and checkpoint it as ``step``."""
    tree, state_meta = capture_train_state(module, extra_meta=meta)
    manager.save(step, tree, state_meta, blocking=blocking)


def restore_module(manager, module, step: Optional[int] = None
                   ) -> Optional[Dict]:
    """Restore ``module`` from the newest committed step (or ``step``);
    -> the checkpoint's meta, or None when the store is empty.  With the
    fused step engaged, leaves are read straight onto its device."""
    if step is None:
        step = manager.latest_step()
        if step is None:
            return None
    like = None
    fused = getattr(module, "_fused", None)
    if fused is not None and module.optimizer_initialized:
        like = {g: fused.state[g] for g in ("params", "fixed", "aux", "opt")}
        if fused.sharded:
            # each rank reads the slices of its shards only
            like = _shard_leaves(fused, like)
    tree, meta = manager.restore(step=step, like=like)
    restore_train_state(module, tree, meta)
    _LOG.info("restored train state from step %d under %r", step,
              manager.directory)
    return meta
