"""Torch plugin parity: call torch functions and modules on NDArrays.

The counterpart of ``mxnet_tpu/plugins/torch_bridge.py`` (reference
plugin/torch: TorchModule/TorchCriterion wrapping Lua Torch, and the
``python/mxnet/torch.py`` sugar), exported as ``mx.th``.  In the port an
NDArray already holds a ``torch.Tensor``, so :func:`to_torch` returns it,
on its own device and with its storage, with no host copy; modules run
forward and backward where their parameters and inputs live, the card
included.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ndarray import NDArray

__all__ = ["to_torch", "from_torch", "torch_function", "TorchModule",
           "TorchCriterion"]


def to_torch(arr: NDArray) -> torch.Tensor:
    """NDArray -> the ``torch.Tensor`` it holds (same storage)."""
    return arr._get()


def from_torch(tensor: torch.Tensor, ctx=None) -> NDArray:
    """torch.Tensor -> a new NDArray holding a copy, on ``ctx`` (default:
    the tensor's own device)."""
    t = tensor.detach()
    dev = ctx.torch_device() if ctx is not None else t.device
    return NDArray(t.to(device=dev, copy=True), ctx=ctx)


def torch_function(fn: Callable):
    """Wrap a torch function so it maps NDArray -> NDArray (reference
    python/mxnet/torch.py generated wrappers)."""
    def wrapped(*args, **kwargs):
        conv = [to_torch(a) if isinstance(a, NDArray) else a for a in args]
        out = fn(*conv, **kwargs)
        if isinstance(out, (list, tuple)):
            return [from_torch(o) for o in out]
        return from_torch(out)
    wrapped.__name__ = getattr(fn, "__name__", "torch_fn")
    return wrapped


class TorchModule:
    """Run a ``torch.nn.Module`` as a forward/backward block on NDArrays
    (reference plugin/torch torch_module-inl.h)."""

    def __init__(self, module):
        self.module = module

    def forward(self, *inputs: NDArray):
        tins = [to_torch(x).detach().requires_grad_(True) for x in inputs]
        self._tins = tins
        self._tout = self.module(*tins)
        return from_torch(self._tout)

    def backward(self, out_grad: NDArray):
        self._tout.backward(to_torch(out_grad))
        return [from_torch(t.grad) for t in self._tins]

    def parameters(self):
        return [from_torch(p) for p in self.module.parameters()]


class TorchCriterion(TorchModule):
    """Torch loss wrapper (reference TorchCriterion)."""

    def forward(self, data: NDArray, label: NDArray):
        tin = to_torch(data).detach().requires_grad_(True)
        self._tins = [tin]
        self._tout = self.module(tin, to_torch(label)).reshape(1)
        return from_torch(self._tout)
