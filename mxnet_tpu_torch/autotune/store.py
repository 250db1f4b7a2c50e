"""The autotune config store: one JSON file per tuning key, published
atomically (counterpart of ``mxnet_tpu/autotune/store.py``).

The record and its rules are the JAX package's, so a record written by
either package loads in the other::

    {"version": 1, "key": ..., "config": {...}, "cost_s": ...,
     "meta": {...}, "log": [[{config}, cost_s], ...],
     "model_version": ...}               # when a cost model ranked it

Layout: ``$MXNET_AUTOTUNE_DIR/<key>.json``.  Without the variable the
port keeps its own default, ``~/.cache/mxnet_tpu_torch/autotune``, so the
two packages' cost models do not train on each other's measurements
unless a user points both at one directory.  Corrupt, unreadable or
other-schema entries load as None (warn, delete).  A load touches the
entry's mtime; a save evicts the oldest entries past
``MXNET_AUTOTUNE_STORE_MAX`` (default 256; <= 0 unbounded).
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

from ..base import atomic_local_write, get_env

__all__ = ["store_dir", "config_path", "load_config", "save_config",
           "list_configs"]

_VERSION = 1


def store_dir() -> str:
    """The store's root: ``MXNET_AUTOTUNE_DIR``, defaulting to
    ``~/.cache/mxnet_tpu_torch/autotune`` (created on first save)."""
    d = get_env("MXNET_AUTOTUNE_DIR", "", str)
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache",
                         "mxnet_tpu_torch", "autotune")
    return os.path.expanduser(d)


def config_path(key: str) -> str:
    return os.path.join(store_dir(), "%s.json" % key)


def _drop(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def load_config(key: str,
                model_version: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """The stored record for ``key``, or None: absent, corrupt, another
    schema version, or (with ``model_version``) ranked by another
    cost-model version.  Dropped entries are deleted so the next save is
    clean.  A load that succeeds touches the entry's mtime (LRU)."""
    path = config_path(key)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        warnings.warn("autotune: dropping unreadable store entry %s (%s)"
                      % (path, e))
        _drop(path)
        return None
    if not isinstance(doc, dict) or doc.get("version") != _VERSION \
            or "config" not in doc:
        warnings.warn("autotune: dropping store entry %s with unknown "
                      "schema" % path)
        _drop(path)
        return None
    if model_version is not None and doc.get("model_version") != model_version:
        warnings.warn("autotune: dropping store entry %s ranked by "
                      "cost-model v%s (current v%d)"
                      % (path, doc.get("model_version"), model_version))
        _drop(path)
        return None
    try:
        os.utime(path)          # LRU recency: a hit is a use
    except OSError:
        pass
    return doc


def save_config(key: str, config: Dict[str, Any], cost_s: float,
                meta: Optional[Dict[str, Any]] = None,
                log: Optional[List[Tuple[Dict[str, Any], float]]] = None,
                model_version: Optional[int] = None) -> str:
    """Atomically publish the winning config and the measurement log it
    was selected from; returns the path.  Every save enforces the cap."""
    os.makedirs(store_dir(), exist_ok=True)
    path = config_path(key)
    doc = {"version": _VERSION, "key": key, "config": dict(config),
           "cost_s": float(cost_s), "meta": dict(meta or {}),
           "log": [[dict(c), float(s)] for (c, s) in (log or [])]}
    if model_version is not None:
        doc["model_version"] = int(model_version)
    with atomic_local_write(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    _enforce_cap(keep=path)
    return path


def _enforce_cap(keep: Optional[str] = None) -> None:
    """Drop oldest-mtime entries until at most ``MXNET_AUTOTUNE_STORE_MAX``
    remain; never the entry just written (``keep``)."""
    cap = get_env("MXNET_AUTOTUNE_STORE_MAX", 256, int)
    if cap <= 0:
        return
    root = store_dir()
    try:
        names = [n for n in os.listdir(root) if n.endswith(".json")]
    except OSError:
        return
    if len(names) <= cap:
        return
    aged = []
    for n in names:
        p = os.path.join(root, n)
        try:
            aged.append((os.stat(p).st_mtime, p))
        except OSError:
            continue
    aged.sort()
    excess = len(aged) - cap
    for _mt, p in aged:
        if excess <= 0:
            break
        if p == keep:
            continue
        _drop(p)
        excess -= 1


def list_configs() -> List[str]:
    """Keys present in the store."""
    try:
        names = os.listdir(store_dir())
    except OSError:
        return []
    return sorted(n[:-5] for n in names if n.endswith(".json"))
