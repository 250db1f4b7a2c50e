"""mxnet_tpu_torch.dist: processes that train and serve together
(counterpart of ``mxnet_tpu/dist``).

``boot``
    The one owner of the ``torch.distributed`` lifecycle: workers
    launched by ``tools/launch.py`` or :class:`FleetSupervisor` join the
    group at ``import mxnet_tpu_torch`` time; any other process gets a
    world-1 group on first use of a mesh.

``FleetSupervisor`` (``fleet``)
    ``faults.Supervisor`` at fleet level: N rank processes under one
    coordinator; a lost rank takes the fleet down, and the fleet is
    formed again from the latest checkpoint commit
    (``on_loss="rejoin"``) or one rank smaller (``on_loss="shrink"``).
    The ``dist.host`` fault point (stage ``rank<i>``) in ``Module``'s
    fused update drives chaos runs.

``rpc``
    The cross-process serve seam: ``RpcReplica`` speaks the replica
    surface (``submit / pending_requests / outstanding / close``) over a
    socket to an engine in another process, so ``ServeRouter``'s health
    removal and draining restart hold across processes.

The sharding search (``shardsearch``, ``search_sharding``,
``resolve_auto``) waits for the compile cache (ROADMAP.md, queue 1 item
10c, after item 11); the fleet report (``report``,
``fleet_multichip_report*``) waits for the trace journals (item 12).
Their names raise.  The rest load lazily, as the reference's do.
"""
from __future__ import annotations

import importlib

from . import boot  # noqa: F401

__all__ = ["boot", "FleetSupervisor", "FleetStats", "RpcReplica", "fleet",
           "rpc", "free_port"]

_LAZY = {
    "FleetSupervisor": ("fleet", "FleetSupervisor"),
    "FleetStats": ("fleet", "FleetStats"),
    "free_port": ("fleet", "free_port"),
    "RpcReplica": ("rpc", "RpcReplica"),
    "fleet": ("fleet", None),
    "rpc": ("rpc", None),
}

_LATER = {
    "search_sharding": "queue 1 item 10c, after item 11's compile cache",
    "resolve_auto": "queue 1 item 10c, after item 11's compile cache",
    "shardsearch": "queue 1 item 10c, after item 11's compile cache",
    "fleet_multichip_report": "queue 1 item 12, with trace/",
    "fleet_multichip_report_str": "queue 1 item 12, with trace/",
    "report": "queue 1 item 12, with trace/",
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is not None:
        mod = importlib.import_module("." + entry[0], __name__)
        obj = mod if entry[1] is None else getattr(mod, entry[1])
        globals()[name] = obj
        return obj
    if name in _LATER:
        raise NotImplementedError(
            "mxnet_tpu_torch.dist.%s is not in the port yet (ROADMAP.md, "
            "%s)" % (name, _LATER[name]))
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
