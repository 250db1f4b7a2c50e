"""Device context: (device_type, device_id) mapped to a ``torch.device``.

The counterpart of ``mxnet_tpu/context.py``.  ``gpu(i)`` is
``torch.device("cuda", i)`` and is the default context: entry points run
on the card unless the caller asks for ``cpu()``.  Asking for a card that
is not there raises; nothing quietly runs on the CPU instead.  Under an
NCCL group of several ranks ``gpu(0)`` is this rank's own card
(``dist.boot.rank_card``).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "used_cuda_devices"]

# the CUDA device ids a Context has resolved to: the devices
# ``engine.wait_for_all`` synchronizes
_USED_CUDA = set()


class Context:
    """Device context (device_type, device_id); a with-statement scope
    that sets the default context of the creation functions."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r (have %s)"
                                 % (device_type, sorted(Context.devstr2type)))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    def torch_device(self) -> torch.device:
        """The ``torch.device`` of this context.  ``gpu(i)`` raises when
        the process sees no CUDA device ``i``; under an NCCL group of
        several ranks it is this rank's card (``dist.boot.rank_card``)."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but no CUDA device is available; pass "
                "dev_type='cpu' (or use mx.cpu()) to run on the host" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%s requested but only %d CUDA device(s) exist"
                             % (self, torch.cuda.device_count()))
        from .dist.boot import rank_card
        idx = rank_card(self.device_id)
        _USED_CUDA.add(idx)
        return torch.device("cuda", idx)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    """The context of the innermost with-scope, else ``gpu(0)``."""
    cur = getattr(Context._default_ctx, "value", None)
    return cur if cur is not None else gpu(0)


def used_cuda_devices():
    """The CUDA device ids the port has placed work on, sorted."""
    return sorted(_USED_CUDA)


def context_of(device: torch.device) -> Context:
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)
