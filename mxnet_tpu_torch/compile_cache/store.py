"""On-disk entry store: atomic publish, corruption tolerance, LRU bound
(counterpart of ``mxnet_tpu/compile_cache/store.py``).

Layout (flat, two files per entry)::

    <dir>/<key>.exe    the blob (a kernel library, as nvcc wrote it)
    <dir>/<key>.meta   pickled sidecar: the blob's sha256, its name and
                       what keyed it
    <dir>/<fast>.idx   a fast key's entry key (the index)

Publish order is blob first, meta second, each written to a temporary
file of its own (named by process and thread) and moved onto its name
with ``os.replace``: a reader needs both files and checks the meta's
digest against the blob, so a crash between the two writes, or two
processes publishing one key at once, leaves a complete entry or none,
never a torn one.  Any malformed entry is a miss, warned about once, and
deleted, so the slot is built again and published anew.

Recency is the files' mtime: a hit touches the pair, and eviction drops
the oldest pairs until the directory fits ``size_mb``.  The store is
generic over bytes: it knows nothing of CUDA.
"""
from __future__ import annotations

import logging
import os
import pickle
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..base import fsync_dir, make_lock
from .fingerprint import blob_digest

logger = logging.getLogger(__name__)

META_VERSION = 1

_warned: set = set()
_warned_lock = make_lock("compile_cache.store_warned")


def warn_once(category: str, msg: str) -> None:
    """Log one warning per category per process: a cache degrades
    quietly, and a cold start is news once, not once per program."""
    with _warned_lock:
        if category in _warned:
            return
        _warned.add(category)
    logger.warning(msg)


def _reset_warnings() -> None:   # test hook
    with _warned_lock:
        _warned.clear()


def _publish(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: a temporary file in the same
    directory (unique to this process and thread), fsync, ``os.replace``."""
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-%d-%d-" % (
        os.getpid(), threading.get_ident()))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(d)


class CacheStore:
    """Filesystem half of the compile cache."""

    def __init__(self, directory: str, size_mb: float):
        self.directory = os.path.abspath(directory)
        self.size_bytes = int(float(size_mb) * 1024 * 1024)
        self._lock = make_lock("compile_cache.store")
        os.makedirs(self.directory, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def blob_path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".exe")

    def _meta_path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".meta")

    def _idx_path(self, fast_key: str) -> str:
        return os.path.join(self.directory, fast_key + ".idx")

    # -- fast-key index ----------------------------------------------------
    def save_index(self, fast_key: str, key: str) -> None:
        """Publish fast_key -> entry key."""
        try:
            _publish(self._idx_path(fast_key), key.encode())
        except Exception:
            pass     # the index is an optimization

    def load_index(self, fast_key: str) -> Optional[str]:
        """-> entry key, or None (a malformed index is dropped)."""
        try:
            with open(self._idx_path(fast_key)) as f:
                key = f.read().strip()
        except OSError:
            return None
        if len(key) != 64 or not all(c in "0123456789abcdef" for c in key):
            self.drop_index(fast_key)
            return None
        return key

    def drop_index(self, fast_key: str) -> None:
        try:
            os.unlink(self._idx_path(fast_key))
        except OSError:
            pass

    # -- read --------------------------------------------------------------
    def load(self, key: str) -> Optional[Tuple[bytes, Dict[str, Any]]]:
        """-> (blob, meta) or None.  Every way an entry can be malformed
        (a missing half, meta that does not unpickle, another meta
        version, a digest mismatch from truncation or flipped bits)
        reads as a miss with one warning, and the entry is removed."""
        exe, mp = self.blob_path(key), self._meta_path(key)
        try:
            with open(mp, "rb") as f:
                meta = pickle.load(f)
            if not isinstance(meta, dict) or \
                    meta.get("version") != META_VERSION:
                raise ValueError("meta version mismatch")
            with open(exe, "rb") as f:
                blob = f.read()
            if blob_digest(blob) != meta.get("sha256"):
                raise ValueError("blob checksum mismatch "
                                 "(truncated or corrupted entry)")
        except FileNotFoundError:
            return None
        except Exception as e:
            warn_once(
                "corrupt-entry",
                "compile cache entry %s unreadable (%s: %s); rebuilding "
                "and replacing it" % (key[:12], type(e).__name__, e))
            self.invalidate(key)
            return None
        self._touch(key)
        return blob, meta

    def _touch(self, key: str) -> None:
        for p in (self.blob_path(key), self._meta_path(key)):
            try:
                os.utime(p, None)
            except OSError:
                pass

    # -- write -------------------------------------------------------------
    def save(self, key: str, blob: bytes, meta: Dict[str, Any]) -> int:
        """Atomic publish; -> bytes written.  A failure (a read-only
        directory, a full disk) warns once and gives 0: caching is an
        optimization, never a reason to fail a build."""
        meta = dict(meta)
        meta["version"] = META_VERSION
        meta["sha256"] = blob_digest(blob)
        try:
            _publish(self.blob_path(key), blob)
            _publish(self._meta_path(key),
                     pickle.dumps(meta, protocol=pickle.HIGHEST_PROTOCOL))
        except Exception as e:
            warn_once(
                "store-failed",
                "compile cache cannot publish to %s (%s: %s); running "
                "uncached" % (self.directory, type(e).__name__, e))
            self.invalidate(key)
            return 0
        self._enforce_budget()
        return len(blob)

    def invalidate(self, key: str) -> None:
        for p in (self.blob_path(key), self._meta_path(key),
                  self._idx_path(key)):
            try:
                os.unlink(p)
            except OSError:
                pass

    # -- size bound --------------------------------------------------------
    def _entries(self) -> List[Tuple[float, str, int]]:
        """[(mtime, key, bytes)] of every entry, half entries too."""
        agg: Dict[str, List[float]] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            base, ext = os.path.splitext(name)
            if ext not in (".exe", ".meta", ".idx"):
                continue
            try:
                st = os.stat(os.path.join(self.directory, name))
            except OSError:
                continue
            ent = agg.setdefault(base, [0.0, 0.0])
            ent[0] = max(ent[0], st.st_mtime)
            ent[1] += st.st_size
        return sorted((mt, key, int(sz)) for key, (mt, sz) in agg.items())

    def disk_bytes(self) -> int:
        return sum(sz for _, _, sz in self._entries())

    def entry_count(self) -> int:
        return len(self._entries())

    def _enforce_budget(self) -> None:
        """Drop the oldest entries until under the bound.  Two processes
        evicting at once converge on the same survivors (deleting a
        deleted file does nothing)."""
        with self._lock:
            entries = self._entries()
            total = sum(sz for _, _, sz in entries)
            for _mt, key, sz in entries:
                if total <= self.size_bytes:
                    break
                self.invalidate(key)
                total -= sz
