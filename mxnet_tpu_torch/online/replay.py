"""Replay sealed capture shards as a training feed (counterpart of
``mxnet_tpu/online/replay.py``).

The bridge from :mod:`mxnet_tpu_torch.online.capture` back into the feed
subsystem: a snapshot of the sealed shard set becomes a deterministic
per-epoch source, assembled into the same ``Pipeline``/``FeedDataIter``
shape ``feed.record_pipeline`` produces — so ``Module.fit``'s
checkpointed feed cursor (``state()``/``restore()``) resumes it
**exactly**, and a supervised fine-tune crash-restarts bitwise.

Admission discipline: a shard is readable iff its SEALED marker exists
(:func:`capture.is_sealed`).  Every reader in this module routes
through :func:`load_shard`, which enforces that at runtime.
The shard *snapshot* is taken once, at source construction — shards
sealed later belong to the next round, never to a resumed epoch (a
growing shard list would silently shift the epoch boundary and break
cursor-exact resume).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from .capture import is_sealed, sealed_shards

__all__ = ["load_shard", "replay_source", "replay_pipeline",
           "UnsealedShardError"]


class UnsealedShardError(MXNetError):
    """A reader touched a capture shard whose SEALED marker is absent —
    a torn or in-progress tail that must never be replayed."""


def load_shard(path: str):
    """-> (data, label) arrays of one SEALED shard.  The single
    sanctioned reader: it gates on the marker before touching the
    file, so torn tails surface as :class:`UnsealedShardError`, not as
    silently-short training data."""
    if not is_sealed(path):
        raise UnsealedShardError(
            "capture shard %r has no SEALED marker (torn or in-progress "
            "tail) — it must not be replayed" % path)
    with np.load(path) as z:
        return z["data"], z["label"]


def replay_source(directory: str, shards=None):
    """-> (factory, n_items): a zero-arg per-epoch generator factory
    over a FIXED snapshot of the sealed shards (taken now unless an
    explicit ``shards`` list pins it), yielding ``(data_i, label_i)``
    pairs — the ``SourceStage`` callable-source shape.  Every epoch
    re-reads the same shard list in the same order: deterministic, so
    drain-based feed restore is exact."""
    snapshot = list(shards) if shards is not None \
        else sealed_shards(directory)
    if not snapshot:
        raise MXNetError("no sealed capture shards under %r — nothing "
                         "to replay" % directory)
    n_items = 0
    for path in snapshot:
        data, _label = load_shard(path)
        n_items += int(data.shape[0])

    def epoch():
        for path in snapshot:
            data, label = load_shard(path)
            for i in range(data.shape[0]):
                yield (data[i], label[i])
    return epoch, n_items


def replay_pipeline(directory: str, batch_size: int, shards=None,
                    max_epochs=None, to_device: bool = False,
                    label_name: str = "softmax_label",
                    data_name: str = "data", name: str = "online-replay"):
    """Sealed shards -> a :class:`feed.FeedDataIter` ready for
    ``Module.fit``: SourceStage over the shard snapshot, BatchStage
    (pad-partial, like record_pipeline), staging ring, optional
    device put.  Labels are flattened to the trailing scalar per item
    (capture stores the served output; a classification label is its
    argmax — do that before capture, or pass full outputs and a custom
    fit metric)."""
    from .. import feed
    from ..feed import pipeline as fp
    from ..feed import stages as fs
    factory, _n = replay_source(directory, shards=shards)
    probe = next(iter(factory()))
    data_shape = tuple(np.asarray(probe[0]).shape)

    stage_list = [
        fs.SourceStage(factory, max_epochs=max_epochs, name="replay"),
        fs.BatchStage(batch_size, partial="pad"),
        fs.StagingStage(),
    ]
    if to_device:
        stage_list.append(fs.DevicePutStage())
    pipe = fp.Pipeline(stage_list, name=name)
    return feed.FeedDataIter(pipe, data_shape, batch_size,
                             data_name=data_name, label_name=label_name)
