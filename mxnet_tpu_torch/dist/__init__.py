"""mxnet_tpu_torch.dist: processes that train together (counterpart of
``mxnet_tpu/dist``).

``boot`` owns the ``torch.distributed`` lifecycle: workers launched by
``tools/launch.py`` join the group at ``import mxnet_tpu_torch`` time;
any other process gets a world-1 group on first use of a mesh.  The
fleet supervisor, the cross-host serve seam, the sharding search and
the fleet report are ROADMAP.md queue 1 item 10b: their names raise.
"""
from __future__ import annotations

from . import boot  # noqa: F401

__all__ = ["boot"]

_LATER = ("FleetSupervisor", "FleetStats", "RpcReplica",
          "fleet_multichip_report", "fleet_multichip_report_str",
          "search_sharding", "resolve_auto", "fleet", "rpc", "report",
          "shardsearch")


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            "mxnet_tpu_torch.dist.%s is not in the port yet (ROADMAP.md, "
            "queue 1 item 10b)" % name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))
