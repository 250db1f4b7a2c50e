"""Directory layout and atomic commit protocol for checkpoints
(counterpart of ``mxnet_tpu/checkpoint/layout.py``; the same layout, so
either package reads the other's directories).

One checkpoint root holds one directory per saved step::

    <root>/
      step-00000100/            # committed: COMMIT marker present
        index.json              # shard index (see sharded.py)
        meta.json               # scalar train state (epoch, cursors, ...)
        <leaf>.p0.s0.npy        # one file per shard
        COMMIT
      step-00000200.tmp-1234/   # torn save (crash mid-write): never read

Commit protocol (crash-safe at every point):

1. write every shard + ``index.json`` + ``meta.json`` into a fresh
   ``step-N.tmp-<pid>`` directory, fsync each file;
2. fsync the tmp directory, then ``os.rename`` it to ``step-N``;
3. write + fsync the ``COMMIT`` marker inside, fsync the directory and
   the root.

A directory without ``COMMIT`` is skipped by :func:`latest_step` (as is
one with an unreadable index), so a reader never sees a torn checkpoint.
Retention (:func:`apply_retention`) deletes only committed directories,
removing their ``COMMIT`` marker first.  The protocol's stages
(``"shards_written"``, ``"before_rename"``, ``"after_rename"``,
``"after_commit"``) are ``checkpoint.commit`` fault points
(:mod:`mxnet_tpu_torch.faults`).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import List, Optional

from ..base import fsync_dir
from ..faults import point as _fault_point

__all__ = ["step_dir_name", "parse_step", "is_committed", "latest_step",
           "all_steps", "begin_step", "commit_step", "abort_step",
           "apply_retention", "clean_stale_tmp",
           "COMMIT_MARKER", "INDEX_FILE", "META_FILE"]

COMMIT_MARKER = "COMMIT"
INDEX_FILE = "index.json"
META_FILE = "meta.json"

_STEP_RE = re.compile(r"^step-(\d{8,})$")


def _fault(stage: str, step: int, path: str) -> None:
    _fault_point("checkpoint.commit", stage=stage, step=step, path=path)


def step_dir_name(step: int) -> str:
    return "step-%08d" % int(step)


def parse_step(name: str) -> Optional[int]:
    m = _STEP_RE.match(name)
    return int(m.group(1)) if m else None


def is_committed(root: str, step: int) -> bool:
    d = os.path.join(root, step_dir_name(step))
    if not os.path.isfile(os.path.join(d, COMMIT_MARKER)):
        return False
    try:
        with open(os.path.join(d, INDEX_FILE)) as f:
            json.load(f)
    except (OSError, ValueError):
        return False
    return True


def all_steps(root: str) -> List[int]:
    """Committed, readable steps under ``root``, ascending.  Uncommitted
    (no marker), torn (``.tmp`` suffix) and corrupt-index directories are
    skipped — this is the documented discovery API for resume."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        step = parse_step(name)
        if step is not None and is_committed(root, step):
            steps.append(step)
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    """Newest committed step under ``root`` (None when there is none)."""
    steps = all_steps(root)
    return steps[-1] if steps else None


def begin_step(root: str, step: int) -> str:
    """Create and return the scratch directory for one save attempt."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, "%s.tmp-%d" % (step_dir_name(step), os.getpid()))
    if os.path.exists(tmp):           # a same-pid retry: start clean
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def commit_step(root: str, step: int, tmp: str) -> str:
    """Run the rename + marker protocol; returns the committed path."""
    final = os.path.join(root, step_dir_name(step))
    _fault("shards_written", step, tmp)
    fsync_dir(tmp)
    if os.path.exists(final):
        # overwriting a committed step (re-save after rollback): uncommit
        # the old one first so no reader sees a half-replaced directory
        try:
            os.unlink(os.path.join(final, COMMIT_MARKER))
        except OSError:
            pass
        shutil.rmtree(final)
    _fault("before_rename", step, tmp)
    os.rename(tmp, final)
    fsync_dir(root)
    _fault("after_rename", step, final)
    marker = os.path.join(final, COMMIT_MARKER)
    with open(marker, "w") as f:
        f.write('{"step": %d}\n' % step)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(final)
    fsync_dir(root)
    _fault("after_commit", step, final)
    return final


def abort_step(tmp: str) -> None:
    """Best-effort cleanup of a failed save attempt's scratch dir."""
    try:
        shutil.rmtree(tmp)
    except OSError:
        pass


def apply_retention(root: str, keep_last_n: Optional[int] = None,
                    keep_every_k: Optional[int] = None) -> List[int]:
    """Delete committed steps not covered by the policy; returns the
    steps removed.  A step survives when it is among the newest
    ``keep_last_n`` or divisible by ``keep_every_k``.  ``keep_last_n``
    of None (or 0) keeps everything."""
    if not keep_last_n:
        return []
    steps = all_steps(root)
    recent = set(steps[-keep_last_n:])
    removed = []
    for step in steps:
        if step in recent:
            continue
        if keep_every_k and step % keep_every_k == 0:
            continue
        d = os.path.join(root, step_dir_name(step))
        try:       # uncommit first: a crash mid-rmtree leaves a skipped dir
            os.unlink(os.path.join(d, COMMIT_MARKER))
            shutil.rmtree(d)
            removed.append(step)
        except OSError:
            pass
    return removed


def clean_stale_tmp(root: str) -> List[str]:
    """Remove ``.tmp-*`` wreckage from crashed writers.  Only call when
    no save can be in flight for this root (manager init does)."""
    if not os.path.isdir(root):
        return []
    removed = []
    for name in os.listdir(root):
        if ".tmp-" in name and parse_step(name.split(".tmp-")[0]) is not None:
            try:
                shutil.rmtree(os.path.join(root, name))
                removed.append(name)
            except OSError:
                pass
    return removed
