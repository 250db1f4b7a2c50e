"""CheckpointManager: policy and async orchestration over the layout and
shard primitives (counterpart of ``mxnet_tpu/checkpoint/manager.py``).

::

    mgr = checkpoint.CheckpointManager("/ckpt/run7", keep_last_n=3,
                                       keep_every_k=1000,
                                       save_every_steps=100)
    mgr.save(step, state_tree, meta)         # async
    tree, meta = mgr.restore()               # newest committed step
    print(mx.profiler.checkpoint_report_str())

``save`` snapshots on the calling (train) thread, device clones and
non-blocking copies into pinned host memory (``snapshot.py``), and
hands serialization and the atomic commit to the background writer.
``restore`` reads the newest committed step (torn saves are skipped,
see layout.py); leaves come back as host arrays, or on the device and
in the dtype of a ``like`` template's tensors.  Retention (keep-last-N,
keep-every-K) runs after every commit, and a new manager sweeps the
``.tmp-*`` wreckage of crashed writers.  ``install_preemption_handler``
arms SIGTERM for snapshot-then-exit (``Module.fit`` polls ``preempted``
each batch).  The trace spans the reference emits here wait for
``trace/`` (item 12).

Several processes (a group of world > 1, reference manager.py:99-102,
244-283): every rank calls ``save`` with its part of the state (its
shards as ``sharded.ShardedLeaf``s; a plain leaf is replicated and rank
0 writes it).  Rank 0 makes one shared temporary directory, each rank
writes the files of the shards it owns and its own index
(``index.p<rank>.json``), rank 0 merges the indexes into ``index.json``
(``process_count`` = the world) and commits with the one-process
protocol, a barrier between each stage.  The barriers are collectives
of the process group the training thread uses, so these saves run on
the calling thread (``async_save`` applies to one process).  Discovery,
retention and the sweep of stale temporary directories are rank 0's.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError, make_lock
from . import layout
from .sharded import (ShardedLeaf, flatten_state, merge_indexes, read_leaf,
                      write_leaf)
from .snapshot import AsyncWriter, snapshot_tree

__all__ = ["CheckpointManager", "CheckpointStats"]

_FORMAT = 1


class CheckpointStats:
    """Save and restore counters of one manager, in
    ``mx.profiler.checkpoint_report()``: the train thread's stall per
    save (``overhead_s``), the writer's commit wall (``save_s``), the
    bytes and the pinned host bytes of the last save."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("checkpoint.manager")
        self._c: Dict[str, float] = {
            "saves_started": 0, "saves_committed": 0, "save_failures": 0,
            "restores": 0, "last_step": -1,
            "save_s": 0.0, "last_save_s": 0.0,
            "bytes": 0, "last_bytes": 0, "last_bytes_per_s": 0.0,
            "overhead_s": 0.0, "last_overhead_s": 0.0,
            "last_pinned_bytes": 0,
            "restore_s": 0.0, "last_restore_s": 0.0,
        }

    def add(self, **kwargs) -> None:
        with self._lock:
            for k, v in kwargs.items():
                if k.startswith("last_") or k == "last_step":
                    self._c[k] = v
                else:
                    self._c[k] += v

    def report(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._c)
        for k in ("save_s", "last_save_s", "overhead_s", "last_overhead_s",
                  "restore_s", "last_restore_s", "last_bytes_per_s"):
            out[k] = round(out[k], 4)
        return out

    def report_str(self) -> str:
        r = self.report()
        return ("checkpoint manager %r\n"
                "  saves: %d committed / %d started (%d failed), "
                "last step %d\n"
                "  save wall:   %.3fs last, %.3fs total, %.1f MB/s last\n"
                "  train-thread overhead: %.4fs last, %.4fs total\n"
                "  restores: %d, %.3fs last" % (
                    self.name, r["saves_committed"], r["saves_started"],
                    r["save_failures"], r["last_step"], r["last_save_s"],
                    r["save_s"], r["last_bytes_per_s"] / 1e6,
                    r["last_overhead_s"], r["overhead_s"], r["restores"],
                    r["last_restore_s"]))


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def _processes():
    """(this process's rank, the world) of the process group; (0, 1)
    when none is up."""
    from ..dist import boot
    return boot.rank(), boot.world_size()


def _barrier() -> None:
    """Every rank of the process group (a host all-reduce)."""
    from ..parallel.mesh import make_mesh
    from ..parallel.collectives import barrier
    barrier(make_mesh([("world", -1)]).axis("world"))


def _shape(x):
    return tuple(int(d) for d in np.shape(x)) \
        if not isinstance(x, torch.Tensor) else tuple(x.shape)


class CheckpointManager:
    """Async, crash-safe checkpoint store rooted at one directory (see
    the module docstring)."""

    def __init__(self, directory: str, keep_last_n: Optional[int] = 3,
                 keep_every_k: Optional[int] = None,
                 save_every_steps: Optional[int] = None,
                 async_save: bool = True, max_pending: int = 2,
                 name: Optional[str] = None):
        self.directory = str(directory)
        self.keep_last_n = keep_last_n
        self.keep_every_k = keep_every_k
        self.save_every_steps = save_every_steps
        self.async_save = async_save
        self.name = name or os.path.basename(os.path.normpath(self.directory))
        self.stats = CheckpointStats(self.name)
        from .. import profiler
        profiler.register_checkpoint_stats(self.stats)
        self._writer = AsyncWriter(name="ckpt-writer-%s" % self.name,
                                   max_pending=max_pending) \
            if async_save else None
        self._closed = False
        self.preempted = False
        self._prev_handlers: Dict[int, Any] = {}
        self._proc, self._nproc = _processes()
        # no save can be in flight for this root before its manager
        # exists: the wreckage of a crashed writer goes
        if self._proc == 0:
            layout.clean_stale_tmp(self.directory)

    # -- discovery ------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Newest committed step (torn and uncommitted saves are never
        visible here)."""
        return layout.latest_step(self.directory)

    def all_steps(self):
        return layout.all_steps(self.directory)

    def should_save(self, step: int) -> bool:
        return bool(self.save_every_steps) and step > 0 \
            and step % self.save_every_steps == 0

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, meta: Optional[Dict] = None,
             blocking: Optional[bool] = None) -> None:
        """Checkpoint ``tree`` (a tree of tensors/arrays) and JSON-able
        ``meta`` as ``step``.  Async by default: the call costs the
        device clones and the start of their copies to the host;
        serialization and the atomic commit run on the writer thread.
        ``blocking=True`` (or ``async_save=False``) commits before
        returning."""
        if self._closed:
            raise MXNetError("CheckpointManager %r is closed" % self.name)
        step = int(step)
        blocking = (not self.async_save) if blocking is None else blocking
        t0 = time.perf_counter()
        snap = snapshot_tree(tree)
        meta = dict(meta or {})
        meta.setdefault("step", step)
        self.stats.add(saves_started=1, last_pinned_bytes=snap.pinned_bytes)
        if self._nproc > 1:
            if self._writer is not None:
                self._writer.wait()
            self._write_state_multiprocess(step, snap, meta)
        elif self._writer is None or blocking:
            if self._writer is not None:
                self._writer.wait()     # commits stay ordered by step
            self._write_state(step, snap, meta)
        else:
            self._writer.submit(lambda: self._write_state(step, snap, meta))
        dt = time.perf_counter() - t0
        self.stats.add(last_overhead_s=dt, overhead_s=dt)

    def _write_state(self, step: int, snap, meta: Dict) -> None:
        t0 = time.perf_counter()
        try:
            tree = snap.ready()
            tmp = layout.begin_step(self.directory, step)
            try:
                self._write_shards(tmp, step, tree, meta)
                layout.commit_step(self.directory, step, tmp)
            except BaseException:
                layout.abort_step(tmp)
                raise
        except BaseException:
            self.stats.add(save_failures=1)
            raise
        dt = max(time.perf_counter() - t0, 1e-9)
        nbytes = self._dir_bytes(step)
        self.stats.add(saves_committed=1, last_step=step,
                       save_s=dt, last_save_s=dt, bytes=nbytes,
                       last_bytes=nbytes, last_bytes_per_s=nbytes / dt)
        layout.apply_retention(self.directory, self.keep_last_n,
                               self.keep_every_k)

    def _write_shards(self, tmp: str, step: int, tree, meta: Dict) -> None:
        leaves, spec = flatten_state(tree)
        entries = {leaf_id: write_leaf(tmp, leaf_id, arr)
                   for leaf_id, arr in leaves.items()}
        index = {"format": _FORMAT, "step": step, "process_count": 1,
                 "spec": spec, "leaves": entries}
        _write_json(os.path.join(tmp, layout.INDEX_FILE), index)
        _write_json(os.path.join(tmp, layout.META_FILE), meta)

    def _write_state_multiprocess(self, step: int, snap, meta: Dict) -> None:
        """The several-process protocol (see the module docstring)."""
        import shutil
        proc, nproc = self._proc, self._nproc
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory,
                           layout.step_dir_name(step) + ".tmp-shared")
        try:
            if proc == 0:
                os.makedirs(self.directory, exist_ok=True)
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
            _barrier()
            tree = snap.ready()
            leaves, spec = flatten_state(tree)
            if proc != 0:
                # a plain leaf is replicated: rank 0 writes it
                leaves = {k: v if isinstance(v, ShardedLeaf)
                          else ShardedLeaf(v, _shape(v),
                                           [[0, d] for d in _shape(v)],
                                           writes=False)
                          for k, v in leaves.items()}
            entries = {leaf_id: write_leaf(tmp, leaf_id, arr,
                                           process_index=proc)
                       for leaf_id, arr in leaves.items()}
            _write_json(os.path.join(tmp, "index.p%d.json" % proc),
                        {"format": _FORMAT, "step": step,
                         "process_count": nproc, "spec": spec,
                         "leaves": entries})
            _barrier()
            if proc == 0:
                per_proc = []
                for p in range(nproc):
                    with open(os.path.join(tmp, "index.p%d.json" % p)) as f:
                        per_proc.append(json.load(f)["leaves"])
                _write_json(os.path.join(tmp, layout.INDEX_FILE),
                            {"format": _FORMAT, "step": step,
                             "process_count": nproc, "spec": spec,
                             "leaves": merge_indexes(per_proc)})
                _write_json(os.path.join(tmp, layout.META_FILE), meta)
                layout.commit_step(self.directory, step, tmp)
            _barrier()
        except BaseException:
            self.stats.add(save_failures=1)
            if proc == 0:
                layout.abort_step(tmp)
            raise
        dt = max(time.perf_counter() - t0, 1e-9)
        nbytes = self._dir_bytes(step)
        self.stats.add(saves_committed=1, last_step=step,
                       save_s=dt, last_save_s=dt, bytes=nbytes,
                       last_bytes=nbytes, last_bytes_per_s=nbytes / dt)
        if proc == 0:
            layout.apply_retention(self.directory, self.keep_last_n,
                                   self.keep_every_k)

    def _dir_bytes(self, step: int) -> int:
        d = os.path.join(self.directory, layout.step_dir_name(step))
        try:
            return sum(os.path.getsize(os.path.join(d, f))
                       for f in os.listdir(d))
        except OSError:
            return 0

    # -- restore --------------------------------------------------------------
    def restore(self, step: Optional[int] = None, like=None):
        """-> (tree, meta) of ``step`` (default: the newest committed).

        ``like``: a template tree of the same structure; a leaf whose
        template is a tensor comes back as a tensor on that tensor's
        device and in its dtype.  Without one, leaves are host arrays
        (torch tensors for bfloat16)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise MXNetError(
                    "no committed checkpoint under %r (torn/uncommitted "
                    "saves are skipped; see latest_step())" % self.directory)
        if not layout.is_committed(self.directory, step):
            raise MXNetError(
                "checkpoint step %d under %r is missing or uncommitted "
                "(committed steps: %s)"
                % (step, self.directory, self.all_steps()))
        t0 = time.perf_counter()
        d = os.path.join(self.directory, layout.step_dir_name(step))
        with open(os.path.join(d, layout.INDEX_FILE)) as f:
            index = json.load(f)
        meta: Dict = {}
        try:
            with open(os.path.join(d, layout.META_FILE)) as f:
                meta = json.load(f)
        except OSError:
            pass
        tree = self._read_tree(d, index["spec"], index["leaves"], like)
        dt = time.perf_counter() - t0
        self.stats.add(restores=1, restore_s=dt, last_restore_s=dt)
        return tree, meta

    def _read_tree(self, d: str, spec, entries, like):
        kind = spec["kind"]
        if kind == "none":
            return None
        if kind == "dict":
            tpl = like if isinstance(like, dict) else {}
            return {k: self._read_tree(d, v, entries, tpl.get(k))
                    for k, v in spec["items"].items()}
        if kind in ("tuple", "list"):
            tpl = like if isinstance(like, (tuple, list)) \
                and len(like) == len(spec["items"]) \
                else [None] * len(spec["items"])
            vals = [self._read_tree(d, v, entries, t)
                    for v, t in zip(spec["items"], tpl)]
            return tuple(vals) if kind == "tuple" else vals
        entry = entries[spec["id"]]
        if isinstance(like, ShardedLeaf):
            t = like.local
            return read_leaf(d, entry, target_dtype=t.dtype,
                             index=like.index).to(t.device)
        if isinstance(like, torch.Tensor):
            return read_leaf(d, entry, target_dtype=like.dtype).to(
                like.device)
        return read_leaf(d, entry)

    # -- lifecycle ------------------------------------------------------------
    def wait(self) -> None:
        """Block until every queued async save has committed; re-raises
        a writer failure."""
        if self._writer is not None:
            self._writer.wait()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._writer is not None:
            self._writer.close()
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- preemption -----------------------------------------------------------
    def install_preemption_handler(
            self, state_fn: Optional[Callable[[], Tuple[int, Any, Dict]]]
            = None, exit_after: bool = True,
            signals=(signal.SIGTERM,)) -> None:
        """Arm SIGTERM (by default) for preemption.  Without ``state_fn``
        the handler only sets ``self.preempted``, which ``Module.fit``
        polls every batch (it then snapshots at the batch boundary and
        returns).  With ``state_fn`` (-> ``(step, tree, meta)``) the
        handler itself runs a blocking save and, with ``exit_after``,
        exits with code 128 + signum.  Only the main thread can install
        a signal handler."""
        def _handler(signum, frame):
            self.preempted = True
            if state_fn is not None:
                step, tree, meta = state_fn()
                meta = dict(meta or {})
                meta["preempted"] = True
                self.save(step, tree, meta, blocking=True)
                if exit_after:
                    sys.exit(128 + signum)

        for sig in signals:
            try:
                self._prev_handlers.setdefault(sig, signal.getsignal(sig))
                signal.signal(sig, _handler)
            except ValueError as e:
                raise MXNetError(
                    "preemption handler must be installed from the main "
                    "thread: %s" % e) from e
