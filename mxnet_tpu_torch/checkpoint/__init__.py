"""mxnet_tpu_torch.checkpoint: async, crash-safe checkpoints of the full
train state (counterpart of ``mxnet_tpu/checkpoint/``, in its file
format: a directory either package writes restores in the other).

* **async snapshot** (snapshot.py): device clones and non-blocking
  copies into pinned host memory on the train thread, serialization and
  commit on a background writer;
* **shard files** (sharded.py): one ``.npy`` per shard plus
  ``index.json``;
* **atomic commit** (layout.py): ``step-N.tmp`` -> fsync -> rename ->
  ``COMMIT`` marker; :func:`latest_step` never sees a torn save;
* **full train-state capture** (module_state.py): params, aux, optimizer
  slots, ``num_update``, the lr schedule, the random state, and the
  epoch and batch cursor in ``meta``;
* **policy and preemption** (manager.py): keep-last-N and keep-every-K
  retention, ``Module.fit(checkpoint=...)``, SIGTERM snapshot-then-exit;
* ``mx.profiler.checkpoint_report()``.

Quick start::

    mgr = mx.checkpoint.CheckpointManager("/ckpt/run7", keep_last_n=3,
                                          save_every_steps=100)
    mod.fit(train_iter, num_epoch=50, checkpoint=mgr, resume=True)
"""
from __future__ import annotations

from .layout import (all_steps, latest_step, step_dir_name,
                     COMMIT_MARKER, INDEX_FILE, META_FILE)
from .manager import CheckpointManager, CheckpointStats
from .module_state import (capture_train_state, restore_train_state,
                           save_module, restore_module)
from .snapshot import snapshot_tree

__all__ = ["CheckpointManager", "CheckpointStats", "latest_step",
           "all_steps", "step_dir_name", "snapshot_tree",
           "capture_train_state", "restore_train_state", "save_module",
           "restore_module", "COMMIT_MARKER", "INDEX_FILE", "META_FILE"]
