"""Sampled request/response capture at the serve seam (counterpart of
``mxnet_tpu/online/capture.py``; shards and markers byte-compatible).

Production retraining starts with the traffic the live model actually
served.  :class:`CaptureWriter` sits on the ServeRouter's success path
(``ServeRouter(capture=...)``) — or anywhere a ``(data, output)`` pair
exists — samples at a deterministic rate, and spills fixed-size shards
to disk with the same crash discipline the checkpoint store uses:

* every shard is published via ``base.atomic_local_write`` (tmp name in
  the same directory, fsync, ``os.replace``, fsync dir) — a crash
  mid-spill leaves only tmp wreckage, never a half shard under the
  published name;
* a shard only becomes replayable when its ``SEALED`` marker lands
  (written atomically AFTER the shard file), mirroring the checkpoint
  COMMIT-marker protocol: a torn or unsealed tail is invisible to
  :mod:`mxnet_tpu_torch.online.replay` and is never trained on.

Sampling is deterministic every-Nth via a rate accumulator rather than
a coin flip, so the captured fraction is exact and verifiable from the
serve report counters (``captured / completed``), and a supervised
re-capture of the same request stream reproduces the same shards
byte for byte — the property the chaos acceptance test leans on.

The fault plane hooks the seam at ``online.capture@seal`` (between the
shard publish and its marker): a ``torn`` fault tears exactly the state
the SEALED discipline exists to quarantine.
"""
from __future__ import annotations

import os
import json

import numpy as np

from ..base import (MXNetError, atomic_local_write, get_env, make_lock)
from ..faults import point as _fault_point

__all__ = ["CaptureWriter", "shard_path", "seal_path", "is_sealed",
           "sealed_shards", "shard_index"]

_SHARD_FMT = "shard-%08d.npz"
_SEAL_SUFFIX = ".SEALED"


def shard_path(directory: str, idx: int) -> str:
    """Published name of shard ``idx``."""
    return os.path.join(directory, _SHARD_FMT % idx)


def seal_path(shard: str) -> str:
    """The SEALED marker guarding ``shard`` (path or bare name)."""
    base, _ext = os.path.splitext(shard)
    return base + _SEAL_SUFFIX


def shard_index(shard: str) -> int:
    """-> the numeric index embedded in a shard (or marker) name."""
    name = os.path.basename(shard)
    stem = name.split(".", 1)[0]
    try:
        return int(stem.split("-", 1)[1])
    except (IndexError, ValueError):
        raise MXNetError("not a capture shard name: %r" % name)


def is_sealed(shard: str) -> bool:
    """True iff ``shard``'s SEALED marker exists — the replay
    admission test.  A shard without its marker is a torn or
    in-progress tail and MUST NOT be read."""
    return os.path.exists(seal_path(shard))


def sealed_shards(directory: str):
    """Sorted list of replayable shard paths: published AND sealed.
    Torn tails (file without marker) and orphaned markers (marker
    whose shard a cleanup removed) are both skipped."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    out = []
    for name in sorted(names):
        if name.startswith("shard-") and name.endswith(".npz"):
            path = os.path.join(directory, name)
            if is_sealed(path):
                out.append(path)
    return out


class CaptureWriter:
    """Rate-sampled, crash-tolerant capture of served ``(data, output)``
    pairs into sealed shards under ``directory``.

    Parameters
    ----------
    directory : str
        Where shards land; created if missing.
    sample : float
        Fraction of offered pairs to keep, in ``[0, 1]``
        (``MXNET_ONLINE_SAMPLE``, default 1.0).  Deterministic
        every-Nth via a rate accumulator — exactly
        ``round(sample * offered)`` pairs survive, independent of
        thread interleaving (the accumulator is lock-protected).
    shard_items : int
        Pairs per shard (``MXNET_ONLINE_SHARD_ITEMS``, default 64).
        A shard seals when full; :meth:`flush` seals a partial tail.
    fresh : bool
        True wipes existing shards/markers/tmp wreckage first — the
        deterministic-restart shape the chaos child uses (re-capture
        reproduces the identical shard sequence).  Default False
        continues after the highest existing index; an unsealed torn
        tail is left behind, permanently invisible to replay.
    transform : callable(data, output) -> (data, label)
        Applied to each SAMPLED pair before buffering — the hook that
        turns a served response into a training label (e.g. the
        self-distillation shape ``lambda d, o: (d, np.argmax(o))``).
        Default: store both sides as offered.

    Thread-safe: ``offer`` may be called from any number of router
    completion threads.  A spill failure (including an injected torn
    fault) is remembered and re-raised by :meth:`flush`/:meth:`close`
    and every later :meth:`offer` — a writer that tore a shard refuses
    to keep capturing, so the supervised loop dies loud and re-captures
    clean instead of training on a gapped stream.
    """

    def __init__(self, directory: str, sample: float = None,
                 shard_items: int = None, fresh: bool = False,
                 transform=None, name: str = "capture"):
        if sample is None:
            sample = get_env("MXNET_ONLINE_SAMPLE", 1.0, float)
        if not 0.0 <= float(sample) <= 1.0:
            raise MXNetError("capture sample rate must be in [0, 1], "
                             "got %r" % (sample,))
        if shard_items is None:
            shard_items = get_env("MXNET_ONLINE_SHARD_ITEMS", 64, int)
        if int(shard_items) < 1:
            raise MXNetError("shard_items must be >= 1, got %r"
                             % (shard_items,))
        self.name = name
        self.directory = str(directory)
        self.sample = float(sample)
        self.shard_items = int(shard_items)
        self.transform = transform
        self._lock = make_lock("online.capture")
        self._acc = 0.0
        self._data = []
        self._labels = []
        self._error = None
        self._offered = 0
        self._kept = 0
        self._shards = 0
        self._items_sealed = 0
        os.makedirs(self.directory, exist_ok=True)
        if fresh:
            for fname in os.listdir(self.directory):
                if fname.startswith("shard-"):
                    try:
                        os.unlink(os.path.join(self.directory, fname))
                    except OSError:
                        pass
            self._next = 0
        else:
            self._next = self._resume_index()
        from .. import profiler
        profiler.register_online_stats(self)

    def _resume_index(self) -> int:
        nxt = 0
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        for name in names:
            if name.startswith("shard-") and ".tmp-" not in name:
                try:
                    nxt = max(nxt, shard_index(name) + 1)
                except MXNetError:
                    pass
        return nxt

    # -- capture -----------------------------------------------------------
    def offer(self, data, output) -> bool:
        """Offer one served pair; -> True iff it was sampled in.  Both
        sides are coerced to numpy; every kept ``data`` must share one
        shape/dtype (they stack into the shard), same for ``output``."""
        with self._lock:
            if self._error is not None:
                raise self._error
            self._offered += 1
            self._acc += self.sample
            if self._acc < 1.0:
                return False
            self._acc -= 1.0
            self._kept += 1
            if self.transform is not None:
                data, output = self.transform(data, output)
            self._data.append(np.asarray(data))
            self._labels.append(np.asarray(output))
            if len(self._data) >= self.shard_items:
                self._spill_locked()
            return True

    def _spill_locked(self) -> None:
        idx = self._next
        path = shard_path(self.directory, idx)
        data = np.stack(self._data)
        labels = np.stack(self._labels)
        try:
            with atomic_local_write(path, "wb") as f:
                np.savez(f, data=data, label=labels)
            # the seam the chaos schedule tears: shard published, marker
            # not yet down — exactly the state replay must never read
            _fault_point("online.capture", stage="seal", shard=idx,
                         path=path)
            meta = {"shard": idx, "items": int(data.shape[0]),
                    "data_shape": list(data.shape[1:]),
                    "data_dtype": str(data.dtype),
                    "label_shape": list(labels.shape[1:]),
                    "label_dtype": str(labels.dtype)}
            with atomic_local_write(seal_path(path), "w") as f:
                json.dump(meta, f)
        except BaseException as e:
            self._error = e if isinstance(e, Exception) else \
                MXNetError("capture spill aborted: %r" % (e,))
            raise
        self._next = idx + 1
        self._shards += 1
        self._items_sealed += int(data.shape[0])
        self._data = []
        self._labels = []

    def flush(self) -> None:
        """Seal the partial tail (if any).  Re-raises a remembered
        spill failure — the caller of a torn capture run must see it
        even if the tearing ``offer`` happened on a completion thread
        that swallowed the exception."""
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._data:
                self._spill_locked()

    def close(self) -> None:
        self.flush()

    # -- introspection -----------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            return {
                "kind": "capture",
                "sample": self.sample,
                "offered": self._offered,
                "kept": self._kept,
                "kept_frac": round(self._kept / self._offered, 4)
                if self._offered else 0.0,
                "shards_sealed": self._shards,
                "items_sealed": self._items_sealed,
                "pending": len(self._data),
                "errored": self._error is not None,
            }

    def report_str(self) -> str:
        r = self.report()
        return ("capture %r: %d/%d kept (%.3f of %.3f target), "
                "%d shards sealed (%d items), %d pending%s"
                % (self.name, r["kept"], r["offered"], r["kept_frac"],
                   r["sample"], r["shards_sealed"], r["items_sealed"],
                   r["pending"], ", ERRORED" if r["errored"] else ""))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # an exceptional exit must not mask the original error with a
        # remembered spill failure
        if exc and exc[0] is None:
            self.close()
