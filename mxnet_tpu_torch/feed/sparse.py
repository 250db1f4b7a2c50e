"""Fixed-shape padded id-list batches for the feed pipeline (counterpart
of ``mxnet_tpu/feed/sparse.py``).

Rec models consume per-user id LISTS (clicked items, feature hashes) of
varying length; every stage of the feed subsystem — the ParallelReader's
shared-memory rings above all — wants FIXED-shape samples.  The bridge
is the padded-indices sample type: each id list becomes a ``(max_len,)``
int32 row, right-padded with ``PAD_ID`` (-1, out of every table's range,
so the embed engine's lookup reads pad positions as zero vectors and
its update drops them: the fused step's dedup folds -1 into the sentinel
row -- no mask tensor ever ships).

* :func:`pad_ids` — one list -> one fixed row (truncates over-long
  lists from the LEFT, keeping the most recent ids, the rec convention)
* :func:`make_ids_decode` — the ParallelReader/MapStage decode fn for
  RecordIO payloads holding little-endian int32 id lists
* :func:`write_ids_record` — pack ``(label, ids)`` samples into such a
  .rec file (bench/test fixture writer)
* :func:`ids_pipeline` — the full staged pipeline as a DataIter:
  ``("rec", path)`` sources stream through ParallelReader processes
  exactly like image pipelines (same rings, shuffle window, crash
  restart, mid-epoch cursors — the samples are just int rows now);
  callable sources run in-process through SourceStage
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np

__all__ = ["PAD_ID", "pad_ids", "make_ids_decode", "write_ids_record",
           "ids_pipeline"]

# out of range for EVERY table (embed masks ids outside [0, vocab)), so
# no per-model pad value needs threading through the pipeline
PAD_ID = -1


def pad_ids(ids, max_len: int, pad_id: int = PAD_ID) -> np.ndarray:
    """One variable-length id list -> a ``(max_len,)`` int32 row.
    Over-long lists keep their LAST ``max_len`` ids."""
    arr = np.asarray(ids, np.int32).reshape(-1)
    if arr.size >= max_len:
        return np.ascontiguousarray(arr[arr.size - max_len:])
    out = np.full((max_len,), pad_id, np.int32)
    out[:arr.size] = arr
    return out


def make_ids_decode(max_len: int, pad_id: int = PAD_ID) -> Callable:
    """Decode fn for id-list sources: ``(label, payload) ->
    ((max_len,) int32, f32 label)``.  ``payload`` is either raw bytes of
    little-endian int32 (the :func:`write_ids_record` wire) or an id
    sequence (in-memory sources)."""
    def decode(item):
        label, payload = item
        if isinstance(payload, (bytes, bytearray, memoryview)):
            ids = np.frombuffer(payload, dtype="<i4")
        else:
            ids = np.asarray(payload, np.int32)
        return pad_ids(ids, max_len, pad_id), np.float32(label)

    return decode


def write_ids_record(path: str, samples) -> int:
    """Write ``(label, ids)`` samples as a RecordIO file whose payloads
    are little-endian int32 id lists (what :func:`make_ids_decode`
    parses); returns the sample count."""
    from .. import recordio
    rec = recordio.MXRecordIO(path, "w")
    n = 0
    try:
        for label, ids in samples:
            payload = np.asarray(ids, "<i4").tobytes()
            header = recordio.IRHeader(0, float(label), n, 0)
            rec.write(recordio.pack(header, payload))
            n += 1
    finally:
        rec.close()
    return n


def ids_pipeline(source: Union[str, Tuple, Callable], batch_size: int,
                 max_len: int, workers: int = 2,
                 reader_procs: Optional[int] = None,
                 shuffle_window: Optional[int] = None,
                 buffer_size: int = 4, max_epochs: Optional[int] = None,
                 to_device: bool = True, sharding=None, seed: int = 0,
                 pad_id: int = PAD_ID, data_name: str = "ids",
                 name: str = "ids_feed", partial: str = "pad",
                 hold: Optional[bool] = None):
    """The staged padded-ids pipeline as a DataIter (the id-list twin of
    ``record_pipeline``; same knobs, fixed ``(batch_size, max_len)``
    int32 batches).

    ``source``: a .rec path / ``("rec", path)`` (streams through
    ``reader_procs`` forked ParallelReader processes when > 0, else the
    in-process thread pool), or a zero-arg callable returning one
    epoch's ``(label, ids)`` iterator (SourceStage).  ``to_device``
    lands the batches on ``sharding`` (a Context or ``torch.device``),
    by default the current context, as ``record_pipeline`` does."""
    from ..base import get_env
    from . import FeedDataIter, staging_stages
    from .parallel import ParallelReader
    from .pipeline import Pipeline
    from .stages import BatchStage, MapStage, SourceStage
    if reader_procs is None:
        reader_procs = get_env("MXNET_FEED_WORKERS", 0, int)
    if shuffle_window is None:
        shuffle_window = get_env("MXNET_FEED_SHUFFLE_WINDOW", 256, int)
    decode = make_ids_decode(max_len, pad_id)
    if callable(source):
        stages = [
            SourceStage(source, max_epochs=max_epochs),
            MapStage(decode, workers=workers, name="pad_ids"),
            BatchStage(batch_size, partial=partial),
        ]
    elif reader_procs > 0:
        stages = [
            ParallelReader(source, decode, workers=reader_procs,
                           sample_shape=(max_len,),
                           sample_dtype=np.int32,
                           shuffle_window=shuffle_window, seed=seed,
                           max_epochs=max_epochs,
                           hold=True if hold is None else hold),
            BatchStage(batch_size, partial=partial),
        ]
    else:
        path = source[1] if isinstance(source, tuple) else source
        stages = [
            SourceStage(_record_source_ids(path), max_epochs=max_epochs),
            MapStage(decode, workers=workers, name="pad_ids"),
            BatchStage(batch_size, partial=partial),
        ]
    stages += staging_stages(buffer_size, to_device, sharding)
    pipe = Pipeline(stages, buffer_size=buffer_size, name=name)
    return FeedDataIter(pipe, (max_len,), batch_size,
                        data_name=data_name)


def _record_source_ids(path: str):
    """Epoch factory over an ids .rec: yields (label, payload bytes)."""
    from .. import recordio

    def epoch():
        rec = recordio.MXRecordIO(path, "r")
        try:
            while True:
                s = rec.read()
                if s is None:
                    return
                header, payload = recordio.unpack(s)
                label = np.asarray(header.label,
                                   np.float32).reshape(-1)[0]
                yield float(label), payload
        finally:
            rec.close()

    return epoch
