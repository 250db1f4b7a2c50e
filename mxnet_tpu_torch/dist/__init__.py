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

``shardsearch``
    ``sharding="auto"``: enumerate per-parameter spec strategies over
    the mesh's model axes, score them with the shared cost model over
    one eager step's features, measure the shortlist, and persist the
    winner per (model, topology) fingerprint in the autotune store
    (``search_sharding``, ``resolve_auto``).

``report``
    ``fleet_multichip_report``: the per-host rollup of the ranks' trace
    journals (``MXNET_TRACE_JOURNAL``).

Everything but ``boot`` loads lazily, as the reference's do.
"""
from __future__ import annotations

import importlib

from . import boot  # noqa: F401

__all__ = ["boot", "FleetSupervisor", "FleetStats", "RpcReplica", "fleet",
           "rpc", "free_port", "shardsearch", "search_sharding",
           "resolve_auto", "report", "fleet_multichip_report",
           "fleet_multichip_report_str"]

_LAZY = {
    "FleetSupervisor": ("fleet", "FleetSupervisor"),
    "FleetStats": ("fleet", "FleetStats"),
    "free_port": ("fleet", "free_port"),
    "RpcReplica": ("rpc", "RpcReplica"),
    "fleet": ("fleet", None),
    "rpc": ("rpc", None),
    "shardsearch": ("shardsearch", None),
    "search_sharding": ("shardsearch", "search_sharding"),
    "resolve_auto": ("shardsearch", "resolve_auto"),
    "report": ("report", None),
    "fleet_multichip_report": ("report", "fleet_multichip_report"),
    "fleet_multichip_report_str": ("report", "fleet_multichip_report_str"),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is not None:
        mod = importlib.import_module("." + entry[0], __name__)
        obj = mod if entry[1] is None else getattr(mod, entry[1])
        globals()[name] = obj
        return obj
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
