"""Multi-process bootstrap (counterpart of
``mxnet_tpu/_distributed_boot.py``).

Joins the ``torch.distributed`` group when launched by
``tools/launch.py`` (the ``MXNET_TPU_COORDINATOR`` / ``_NUM_WORKERS`` /
``_WORKER_ID`` envs); ``mxnet_tpu_torch/__init__`` imports this.  The
work lives in ``dist.boot``, the one owner of the group's lifecycle.
"""
from __future__ import annotations

_done = False


def ensure() -> None:
    global _done
    if _done:
        return
    from .dist import boot
    boot.ensure_from_env()
    _done = True


ensure()
