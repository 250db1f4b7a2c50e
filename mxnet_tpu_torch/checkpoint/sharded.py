"""Tensor serialization for the checkpoint subsystem (counterpart of
``mxnet_tpu/checkpoint/sharded.py``, in its file format).

A train state is a tree of arrays (dicts / tuples / lists / None leaves).
``flatten_state`` walks it into ``(leaves, spec)``: ``spec`` is a JSON
structure whose leaf nodes carry path-derived ids (``params/fc1_weight``,
``opt/fc1_weight/1``), which double as the shard files' basenames.

Each leaf is written as ``.npy`` shard files plus an entry of
``index.json`` (shape, dtype tag, and each shard's file and index
range).  A leaf held whole is one shard.  Under several processes a
leaf may be a :class:`ShardedLeaf`, this rank's shard with its index in
the whole; only the rank that ``writes`` it writes the file
(``%s.p<rank>.s0.npy``), so replicated data is written once over the
world, and ``merge_indexes`` joins the processes' entries (reference
sharded.py:152-199).  ``read_leaf(index=)`` reads only the part of each
shard file (memory-mapped) that a wanted slice overlaps, so a restore
onto another mesh reads what each rank needs.  bfloat16 rides as uint16 bits with a
``"bfloat16"`` dtype tag (reference sharded.py:99-121): the port views
the tensor's bits as int16 through numpy and reads them back with
``.view(torch.bfloat16)``, so neither direction needs ``ml_dtypes``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..faults import point as _fault_point

__all__ = ["flatten_state", "unflatten_state", "write_leaf", "read_leaf",
           "merge_indexes", "ShardedLeaf"]


class ShardedLeaf:
    """This rank's part of a leaf of a sharded train state: ``local``
    (its shard: a tensor or array), the whole ``shape``, the shard's
    ``index`` (``[[start, stop], ...]`` per dim) and whether this rank
    ``writes`` it (one rank per distinct shard).  As a restore template
    (``CheckpointManager.restore(like=)``) it asks for the slice
    ``index`` on ``local``'s device and in its dtype."""

    __slots__ = ("local", "shape", "index", "writes")

    def __init__(self, local, shape, index, writes: bool = True):
        self.local = local
        self.shape = tuple(int(d) for d in shape)
        self.index = [[int(a), int(b)] for a, b in index]
        self.writes = bool(writes)

_SAFE = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-"


def _sanitize(part: str) -> str:
    return "".join(c if c in _SAFE else "_" for c in str(part))


def flatten_state(tree) -> Tuple[Dict[str, Any], Dict]:
    """-> (leaves: {leaf_id: array-like}, spec: JSON-able structure).
    Ids come from the tree path, made unique with a ``~k`` suffix only
    when sanitized names collide."""
    leaves: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return {"kind": "none"}
        if isinstance(node, dict):
            return {"kind": "dict",
                    "items": {str(k): walk(v, path + [str(k)])
                              for k, v in node.items()}}
        if isinstance(node, (tuple, list)):
            return {"kind": "tuple" if isinstance(node, tuple) else "list",
                    "items": [walk(v, path + [str(i)])
                              for i, v in enumerate(node)]}
        leaf_id = "/".join(_sanitize(p) for p in path) or "leaf"
        if leaf_id in leaves:
            k = 1
            while "%s~%d" % (leaf_id, k) in leaves:
                k += 1
            leaf_id = "%s~%d" % (leaf_id, k)
        leaves[leaf_id] = node
        return {"kind": "leaf", "id": leaf_id}

    return leaves, walk(tree, [])


def unflatten_state(spec: Dict, leaves: Dict[str, Any]):
    kind = spec["kind"]
    if kind == "none":
        return None
    if kind == "dict":
        return {k: unflatten_state(v, leaves)
                for k, v in spec["items"].items()}
    if kind in ("tuple", "list"):
        vals = [unflatten_state(v, leaves) for v in spec["items"]]
        return tuple(vals) if kind == "tuple" else vals
    if kind == "leaf":
        return leaves[spec["id"]]
    raise MXNetError("unknown checkpoint spec node %r" % (kind,))


def _host_array(x) -> Tuple[np.ndarray, str]:
    """(numpy array to write, dtype tag)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _np_write(path: str, arr: np.ndarray) -> int:
    """Write one fsynced .npy file; -> bytes written."""
    with open(path, "wb") as f:
        np.save(f, np.ascontiguousarray(arr))
        f.flush()
        os.fsync(f.fileno())
    # the storage seam: a `torn` fault truncates the file just written
    _fault_point("storage.write", path=path)
    return os.path.getsize(path)


def write_leaf(dirpath: str, leaf_id: str, arr,
               process_index: int = 0) -> Dict:
    """Write this process's shard of one leaf into ``dirpath`` (the
    JAX package's file naming, ``<id>.p<process>.s0.npy``); -> its index
    entry ``{"id", "shape", "dtype", "shards": [{"file", "index",
    "bytes"}]}``, with no shards when this rank does not write the
    leaf."""
    if isinstance(arr, ShardedLeaf):
        data, tag = _host_array(arr.local)
        entry = {"id": leaf_id, "shape": list(arr.shape), "dtype": tag,
                 "shards": []}
        index = arr.index
        if not arr.writes:
            return entry
    else:
        data, tag = _host_array(arr)
        entry = {"id": leaf_id, "shape": [int(d) for d in data.shape],
                 "dtype": tag, "shards": []}
        index = [[0, int(d)] for d in data.shape]
    fname = "%s.p%d.s0.npy" % (leaf_id.replace("/", "."), process_index)
    nbytes = _np_write(os.path.join(dirpath, fname), data)
    entry["shards"].append({"file": fname, "index": index, "bytes": nbytes})
    return entry


def merge_indexes(entries_per_process) -> Dict[str, Dict]:
    """Join per-process ``{leaf_id: entry}`` maps into one: same shape
    and dtype, the shard lists concatenated (deduped by index)."""
    merged: Dict[str, Dict] = {}
    for entries in entries_per_process:
        for leaf_id, entry in entries.items():
            m = merged.setdefault(leaf_id, {
                "id": leaf_id, "shape": entry["shape"],
                "dtype": entry["dtype"], "shards": []})
            have = {tuple(map(tuple, s["index"])) for s in m["shards"]}
            for sh in entry["shards"]:
                if tuple(map(tuple, sh["index"])) not in have:
                    m["shards"].append(sh)
    return merged


def _read_slice(dirpath: str, entry: Dict, index):
    """The slice ``index`` of a leaf, from the overlapping part of each
    shard file only (memory-mapped)."""
    dtype = entry["dtype"]
    want = [(int(a), int(b)) for a, b in index]
    shape = tuple(b - a for a, b in want)
    out = None
    covered = 0
    for s in entry["shards"]:
        have = [(int(a), int(b)) for a, b in s["index"]]
        lo = [max(w[0], h[0]) for w, h in zip(want, have)]
        hi = [min(w[1], h[1]) for w, h in zip(want, have)]
        if any(a > b for a, b in zip(lo, hi)):
            continue
        part = np.load(os.path.join(dirpath, s["file"]), mmap_mode="r")
        part = part.reshape([b - a for a, b in have])
        src = tuple(slice(a - h[0], b - h[0]) for a, b, h in
                    zip(lo, hi, have))
        dst = tuple(slice(a - w[0], b - w[0]) for a, b, w in
                    zip(lo, hi, want))
        if out is None:
            out = np.empty(shape, dtype=part.dtype)
        out[dst] = part[src]
        covered += int(np.prod([b - a for a, b in zip(lo, hi)]))
    if out is None or covered < int(np.prod(shape)):
        raise MXNetError(
            "checkpoint leaf %r is missing shards: %d of the %d elements "
            "of slice %s present (a partial sharded save?)"
            % (entry.get("id"), covered, int(np.prod(shape)), want))
    if dtype == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def read_leaf(dirpath: str, entry: Dict, target_dtype=None, index=None):
    """One leaf, assembled on the host from its shard files: a numpy
    array (a torch tensor for bfloat16), cast to ``target_dtype`` (a
    torch dtype) when given.  ``index`` (``[[start, stop], ...]``): only
    that slice, read from the shard files it overlaps."""
    out = _read_slice(dirpath, entry, index if index is not None
                      else [[0, int(d)] for d in entry["shape"]])
    if target_dtype is not None:
        t = out if isinstance(out, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(out))
        if t.dtype != target_dtype:
            t = t.to(target_dtype)
        return t
    return out
