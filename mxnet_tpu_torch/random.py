"""Random sampling (counterpart of ``mxnet_tpu/random.py``).

One ``torch.Generator`` per device: the card's is PyTorch's default CUDA
generator of that device (the one a CUDA graph capture registers, so a
captured Dropout draws new numbers on every replay), the host's a
generator of this module.  ``seed()`` reseeds every one of them and
numpy's global stream, as the reference's ``seed()`` resets its key chain
and numpy's.  The streams are Philox (card) and Mersenne Twister (host),
not the reference's threefry: one seed gives one stream here, but not the
JAX package's numbers.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .context import Context, current_context
from .ndarray import NDArray

__all__ = ["seed", "uniform", "normal", "randint", "generator"]

_HOST: Dict[str, torch.Generator] = {}


def generator(device) -> torch.Generator:
    """The generator of ``device`` (a ``torch.device``, a device string or
    a :class:`Context`).  The host's is seeded from numpy's global stream
    on first use, as the reference's default key is."""
    if isinstance(device, Context):
        device = device.torch_device()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()      # the default generators exist from here
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    if "cpu" not in _HOST:
        gen = torch.Generator()
        # lint: allow(unseeded-fork-rng) — entropy bootstrap: the host
        # generator deliberately derives from the np stream that
        # mx.random.seed seeds (the documented seeding contract)
        gen.manual_seed(int(np.random.randint(0, 2**31 - 1)))
        _HOST["cpu"] = gen
    return _HOST["cpu"]


def seed(seed_state: int) -> None:
    """Seed every device's generator and numpy's global stream."""
    s = int(seed_state)
    gen = torch.Generator()
    gen.manual_seed(s)
    _HOST["cpu"] = gen
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(s)      # applied at CUDA's lazy init
    np.random.seed(s % (2**32))


def _target(shape, ctx: Optional[Context], out: Optional[NDArray]):
    if out is not None:
        return tuple(out.shape), out._get().device
    if shape is None:
        shape = (1,)
    if isinstance(shape, int):
        shape = (shape,)
    ctx = ctx if ctx is not None else current_context()
    return tuple(shape), ctx.torch_device()


def _deliver(val: torch.Tensor, out: Optional[NDArray]) -> NDArray:
    if out is not None:
        out._get().copy_(val)
        return out
    return NDArray(val)


def uniform(low=0.0, high=1.0, shape=None, ctx=None, out=None) -> NDArray:
    """Sample U[low, high) in float32 on ``ctx`` (or into ``out``)."""
    shape, device = _target(shape, ctx, out)
    val = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        low, high, generator=generator(device))
    return _deliver(val, out)


def normal(loc=0.0, scale=1.0, shape=None, ctx=None, out=None) -> NDArray:
    """Sample N(loc, scale^2) in float32 as ``loc + scale * N(0, 1)``."""
    shape, device = _target(shape, ctx, out)
    val = loc + scale * torch.randn(shape, dtype=torch.float32,
                                    device=device,
                                    generator=generator(device))
    return _deliver(val, out)


def randint(low, high, shape=None, ctx=None) -> NDArray:
    """Sample integers in [low, high) as int32."""
    shape, device = _target(shape, ctx, None)
    val = torch.randint(int(low), int(high), shape, device=device,
                        generator=generator(device))
    return NDArray(val.to(torch.int32))
