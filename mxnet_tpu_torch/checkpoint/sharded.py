"""Tensor serialization for the checkpoint subsystem (counterpart of
``mxnet_tpu/checkpoint/sharded.py``, in its file format).

A train state is a tree of arrays (dicts / tuples / lists / None leaves).
``flatten_state`` walks it into ``(leaves, spec)``: ``spec`` is a JSON
structure whose leaf nodes carry path-derived ids (``params/fc1_weight``,
``opt/fc1_weight/1``), which double as the shard files' basenames.

Each leaf is written as ``.npy`` shard files plus an entry of
``index.json`` (shape, dtype tag, and each shard's file and index
range).  The port's tensors live on one device, so it writes one shard a
leaf; it reads the JAX package's multi-shard leaves by assembling them
on the host.  Several processes writing one step are ROADMAP.md queue 1
item 10b.  bfloat16 rides as uint16 bits with a
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

__all__ = ["flatten_state", "unflatten_state", "write_leaf", "read_leaf"]

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


def _np_read(path: str, dtype: str):
    """A shard's array: numpy, or a torch bfloat16 tensor."""
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return arr


def write_leaf(dirpath: str, leaf_id: str, arr) -> Dict:
    """Write one leaf into ``dirpath`` as one shard (process 0's, in the
    JAX package's file naming); -> its index entry ``{"id", "shape",
    "dtype", "shards": [{"file", "index", "bytes"}]}``."""
    data, tag = _host_array(arr)
    fname = "%s.p0.s0.npy" % leaf_id.replace("/", ".")
    nbytes = _np_write(os.path.join(dirpath, fname), data)
    return {"id": leaf_id, "shape": [int(d) for d in data.shape],
            "dtype": tag,
            "shards": [{"file": fname,
                        "index": [[0, int(d)] for d in data.shape],
                        "bytes": nbytes}]}


def read_leaf(dirpath: str, entry: Dict, target_dtype=None):
    """One leaf, assembled on the host from its shard files: a numpy
    array (a torch tensor for bfloat16), cast to ``target_dtype`` (a
    torch dtype) when given."""
    shape = tuple(entry["shape"])
    dtype = entry["dtype"]
    shards = entry["shards"]
    parts = [(s, _np_read(os.path.join(dirpath, s["file"]), dtype))
             for s in shards]
    if len(parts) == 1 and all(a == 0 and b == d for (a, b), d in
                               zip(parts[0][0]["index"], shape)):
        out = parts[0][1].reshape(shape)
    else:
        first = parts[0][1]
        out = torch.empty(shape, dtype=first.dtype) \
            if isinstance(first, torch.Tensor) \
            else np.empty(shape, dtype=first.dtype)
        covered = 0
        for s, part in parts:
            sl = tuple(slice(a, b) for a, b in s["index"])
            out[sl] = part.reshape(out[sl].shape)
            covered += part.size if isinstance(part, np.ndarray) \
                else part.numel()
        if covered < int(np.prod(shape)):
            raise MXNetError(
                "checkpoint leaf %r is missing shards: %d of %d elements "
                "present (a partial sharded save?)"
                % (entry.get("id"), covered, int(np.prod(shape))))
    if target_dtype is not None:
        t = out if isinstance(out, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(out))
        if t.dtype != target_dtype:
            t = t.to(target_dtype)
        return t
    return out
