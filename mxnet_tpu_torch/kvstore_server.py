# lint: allow-file(raw-env) — DMLC protocol vars: reference
# kvstore_server semantics distinguish set-vs-unset and must KeyError
# loudly on a broken launcher rendezvous, not fold into typed defaults
"""Server-role entry for distributed training (counterpart of
``mxnet_tpu/kvstore_server.py``).

``dist_sync`` has no server role: aggregation is a collective over the
process group and jobs launch with ``-s 0``.  ``dist_async`` keeps the
reference's process model: a process launched with
``DMLC_ROLE=server|scheduler`` and the parameter-server envs
(``DMLC_PS_ROOT_URI``, set by ``tools/launch.py -s N``) runs the
parameter-server loop (``ps.py``) when it imports ``mxnet_tpu_torch`` and
exits, so ``tools/launch.py -n W -s N "python script.py"`` starts port
scripts unchanged (reference kvstore_server.py:58-68).
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """The server loop (reference kvstore_server.py:9)."""

    def __init__(self, kvstore):
        self.kvstore = kvstore
        self.handle = None
        self.init_logging = False

    def run(self):
        if not (os.environ.get("DMLC_PS_ROOT_URI")
                and os.environ.get("DMLC_NUM_WORKER")):
            logging.info("no parameter-server environment (DMLC_PS_ROOT_URI/"
                         "DMLC_NUM_WORKER); nothing to serve — returning")
            return
        from . import ps
        ps.run_server()


def _init_kvstore_server_module():
    role = os.environ.get("DMLC_ROLE", "worker")
    if role not in ("server", "scheduler"):
        return
    if os.environ.get("DMLC_PS_ROOT_URI"):
        from . import ps
        if role == "scheduler":
            ps.run_scheduler()
        else:
            ps.run_server()
        sys.exit(0)
    logging.warning(
        "DMLC_ROLE=%s without DMLC_PS_ROOT_URI: the synchronous kvstore "
        "uses collectives over the process group and needs no server "
        "processes (launch with -s 0; dist_async needs launch.py -s N). "
        "Exiting cleanly.", role)
    sys.exit(0)


_init_kvstore_server_module()
