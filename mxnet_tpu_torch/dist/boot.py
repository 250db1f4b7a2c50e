"""The one owner of the ``torch.distributed`` lifecycle (counterpart of
``mxnet_tpu/dist/boot.py``).

The port runs one rank per device.  Every process that joins a mesh
goes through :func:`initialize`: ``tools/launch.py`` workers through
:func:`ensure_from_env` at ``import mxnet_tpu_torch`` time
(``_distributed_boot`` delegates here), tests and scripts
programmatically.  A process that never called the launcher gets a
world-1 group (a ``HashStore``) on first use of a mesh
(:func:`ensure_group`), so ``make_mesh("dp=1")`` works anywhere.

**The backend rule** (:func:`choose_backend`), decided once and stated
in :func:`describe`, never the result of catching an error:

* NCCL when every rank of this host has a card of its own;
* gloo on the CPU (``MXNET_DIST_CPU_COLLECTIVES``, default ``gloo``);
* gloo when several ranks share one card: NCCL refuses two ranks on one
  device.  Gloo has no path for CUDA tensors on that machine, so
  ``parallel/collectives.py`` stages them through pinned host memory.

An NCCL group is made as ``cpu:gloo,cuda:nccl``, so host tensors
(barriers, counts, a CPU job on a machine with cards) go to gloo.

**The rank's card** (:func:`rank_card`): under an NCCL group of more
than one rank each rank owns one card, its local rank.  ``gpu(0)`` (the
default context) and ``gpu(local rank)`` both name it; any other card
raises, since NCCL refuses two ranks on one device.

This module stays import-light: nothing at module level imports
``torch.distributed``.
"""
from __future__ import annotations

import datetime
import logging
import os

from ..base import MXNetError, get_env

__all__ = ["initialize", "ensure_from_env", "ensure_group", "is_initialized",
           "cpu_collectives", "boot_timeout_ms", "choose_backend",
           "backend", "describe", "rank_card", "world_size", "rank",
           "shutdown"]

_state = {"initialized": False, "backend": None, "reason": None,
          "local_rank": 0}


def is_initialized() -> bool:
    """True once THIS module initialized (or confirmed) the group."""
    return _state["initialized"]


def cpu_collectives() -> str:
    """The CPU collectives implementation (``MXNET_DIST_CPU_COLLECTIVES``,
    default ``gloo``; ``none`` leaves a multi-rank CPU job without one,
    and :func:`initialize` then refuses it)."""
    return (get_env("MXNET_DIST_CPU_COLLECTIVES", "gloo") or "").strip()


def boot_timeout_ms() -> int:
    """Rendezvous and collective timeout (``MXNET_DIST_BOOT_TIMEOUT_MS``,
    default 60000): a late rank fails loudly instead of hanging."""
    return max(1000, get_env("MXNET_DIST_BOOT_TIMEOUT_MS", 60000, int))


def _loopback(address: str) -> bool:
    host = address.split("://")[-1].rsplit(":", 1)[0].strip("[]")
    return host in ("127.0.0.1", "localhost", "::1", "") \
        or address.startswith("file://")


def choose_backend(num_processes: int, local_processes: int):
    """-> (backend for CUDA tensors, reason): ``"nccl"`` or ``"gloo"``."""
    import torch
    if not torch.cuda.is_available():
        impl = cpu_collectives()
        if (not impl or impl == "none") and num_processes > 1:
            raise MXNetError(
                "MXNET_DIST_CPU_COLLECTIVES=%r leaves %d CPU ranks without "
                "collectives" % (impl, num_processes))
        return "gloo", "no card: gloo on the CPU"
    cards = torch.cuda.device_count()
    if local_processes <= cards:
        return "nccl", ("every rank has a card of its own (%d rank(s) on "
                        "this host, %d card(s))" % (local_processes, cards))
    return "gloo", ("%d ranks share %d card(s): NCCL refuses two ranks on "
                    "one card; CUDA tensors are staged through pinned "
                    "host memory" % (local_processes, cards))


def _timeout():
    return datetime.timedelta(milliseconds=boot_timeout_ms())


def _finish(bk: str, reason: str, local_rank: int) -> None:
    import torch
    _state.update(initialized=True, backend=bk, reason=reason,
                  local_rank=local_rank)
    if bk == "nccl":
        torch.cuda.set_device(local_rank)
    logging.getLogger(__name__).info("%s", describe())


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join (or confirm membership in) the process group.
    ``coordinator_address`` is ``host:port`` (tools/launch.py's
    ``MXNET_TPU_COORDINATOR``) or a full init method (``tcp://...``,
    ``file://...``).  Ranks on a loopback coordinator share this host;
    any other address means one rank per host (the ssh launcher)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != int(num_processes) or \
                dist.get_rank() != int(process_id):
            raise MXNetError(
                "process group already up as rank %d of %d, asked for "
                "rank %d of %d" % (dist.get_rank(), dist.get_world_size(),
                                   process_id, num_processes))
        if not _state["initialized"]:
            _finish(*_adopt_backend(), int(process_id))
        return
    num, rank = int(num_processes), int(process_id)
    local = num if _loopback(coordinator_address) else 1
    bk, reason = choose_backend(num, local)
    method = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    dist.init_process_group("cpu:gloo,cuda:nccl" if bk == "nccl" else "gloo",
                            init_method=method, world_size=num, rank=rank,
                            timeout=_timeout())
    _finish(bk, reason, rank if local > 1 else 0)


def _adopt_backend():
    """The backend of a group someone else made."""
    import torch.distributed as dist
    name = str(dist.get_backend())
    bk = "nccl" if "nccl" in name else "gloo"
    return bk, "group made outside the boot (backend %s)" % name


def ensure_from_env() -> bool:
    """Boot from the launcher envs (``MXNET_TPU_COORDINATOR`` /
    ``_NUM_WORKERS`` / ``_WORKER_ID``) when present; -> whether a group
    is up.  Called from ``mxnet_tpu_torch._distributed_boot``."""
    if _state["initialized"]:
        return True
    coord = get_env("MXNET_TPU_COORDINATOR")
    if coord is None:
        return False
    # lint: allow(raw-env) — rendezvous vars are a set: once the
    # coordinator is present, a missing peer var is a broken launcher
    # and must KeyError loudly, not default
    num = os.environ["MXNET_TPU_NUM_WORKERS"]
    # lint: allow(raw-env) — same rendezvous set as above
    rank = os.environ["MXNET_TPU_WORKER_ID"]
    initialize(coord, int(num), int(rank))
    return True


def ensure_group() -> None:
    """A process group exists after this: the launcher's, one made
    elsewhere, or a world-1 group over a ``HashStore``."""
    if _state["initialized"] or ensure_from_env():
        return
    import torch.distributed as dist
    if dist.is_initialized():
        _finish(*_adopt_backend(), 0)
        return
    bk, reason = choose_backend(1, 1)
    dist.init_process_group("cpu:gloo,cuda:nccl" if bk == "nccl" else "gloo",
                            store=dist.HashStore(), world_size=1, rank=0,
                            timeout=_timeout())
    _finish(bk, "world 1; " + reason, 0)


def backend() -> str:
    """The transport of CUDA tensors: ``"nccl"`` or ``"gloo"``."""
    ensure_group()
    return _state["backend"]


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def rank_card(device_id: int) -> int:
    """The card that ``gpu(device_id)`` means in this process: this
    rank's own under an NCCL group of more than one rank (``device_id``
    0 or the local rank), else ``device_id``."""
    if _state["backend"] != "nccl" or world_size() < 2:
        return device_id
    own = _state["local_rank"]
    if device_id not in (0, own):
        raise MXNetError(
            "gpu(%d) requested on rank %d, whose card is gpu(%d): under an "
            "NCCL group each rank computes on its own card (gpu(0) names "
            "it)" % (device_id, rank(), own))
    return own


def describe() -> str:
    """The backend line: rank, world, backend and why."""
    return "dist boot: rank %d of %d, backend %s (%s)" % (
        rank(), world_size(), _state["backend"], _state["reason"])


def shutdown() -> None:
    """Destroy the group this module made or adopted."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, backend=None, reason=None,
                  local_rank=0)
    from ..parallel import mesh as _mesh
    _mesh._GROUPS.clear()
