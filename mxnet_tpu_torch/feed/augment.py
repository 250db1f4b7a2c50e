"""On-device image augmentation: the crop/mirror/normalize tail of the
input pipeline, run inside the fused train step (counterpart of
``mxnet_tpu/feed/augment.py``).

The device-augment path ships compact ``uint8`` HWC batches (4x fewer
host-to-device bytes than normalized float32 CHW) and the fused train
step prepends this module's prologue: per-sample random crop, random
horizontal flip, HWC->CHW, cast, mean subtract, scale -- a handful of
tensor ops on the whole batch inside the step's CUDA graph (a gather
through precomputed index tensors; no host read, no loop over the batch)
instead of B python loop bodies on the host.

Randomness: the draws ``(dy, dx, flip)`` come from one function,
:func:`draw`, out of a ``torch.Generator`` -- in the fused step the
device's generator (``mx.random.generator``), whose state the step's
snapshot and the checkpoints save, so speculation and a mid-epoch resume
replay the exact crops and flips, and K replays of a superstep draw as K
steps do.  The reference draws from its per-step threefry key
(``fold_in(step_key, AUG_FOLD)``), which cannot be reproduced here; the
pixel math takes its draws as arguments, so both packages' twins agree
bitwise on the same draws.

* :func:`augment_batch` -- torch, capturable;
* :func:`augment_batch_host` -- numpy, the same op order on the host.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AugmentSpec", "augment_batch", "augment_batch_host", "draw",
           "AUG_FOLD"]

# the reference's fold_in tag for its augmentation draws; kept so specs
# and reports name the same stream in both packages
AUG_FOLD = 0x41554731


class AugmentSpec:
    """What the prologue does to a ``(B, Hp, Wp, C)`` uint8 batch.

    ``data_shape`` is the CHW shape the network consumes; ``pre_shape``
    is the HWC shape the feed ships (decode resizes/center-crops each
    image to this fixed envelope so ring slots and graph shapes stay
    static; the margin over ``data_shape`` is the random-crop room).
    ``mean_rgb``/``scale`` match the host path's normalize step.
    """

    def __init__(self, data_shape: Sequence[int],
                 pre_shape: Optional[Sequence[int]] = None,
                 rand_crop: bool = False, rand_mirror: bool = False,
                 mean_rgb=None, scale: float = 1.0):
        self.data_shape: Tuple[int, ...] = tuple(int(d) for d in data_shape)
        if len(self.data_shape) != 3:
            raise ValueError("data_shape must be CHW, got %r"
                             % (self.data_shape,))
        c, h, w = self.data_shape
        if pre_shape is None:
            pre_shape = (h, w, c)
        self.pre_shape: Tuple[int, ...] = tuple(int(d) for d in pre_shape)
        hp, wp, cp = self.pre_shape
        if cp != c or hp < h or wp < w:
            raise ValueError(
                "pre_shape %r must cover data_shape %r (same channels, "
                "height/width >= crop size)" % (self.pre_shape,
                                                self.data_shape))
        self.rand_crop = bool(rand_crop)
        self.rand_mirror = bool(rand_mirror)
        self.mean = (None if mean_rgb is None
                     else np.asarray(mean_rgb, np.float32).reshape(-1))
        if self.mean is not None and self.mean.size != c:
            raise ValueError("mean_rgb needs %d entries, got %d"
                             % (c, self.mean.size))
        self.scale = float(scale)
        self._mean_on = {}

    def signature(self) -> tuple:
        """Hashable identity for graph keys: everything the prologue
        closes over."""
        return (self.data_shape, self.pre_shape, self.rand_crop,
                self.rand_mirror,
                None if self.mean is None else tuple(self.mean.tolist()),
                self.scale)

    def mean_on(self, device) -> torch.Tensor:
        """The mean as a (1, C, 1, 1) float32 tensor on ``device``, made
        once (a capture may not copy it from the host)."""
        key = str(device)
        t = self._mean_on.get(key)
        if t is None:
            t = torch.from_numpy(self.mean.reshape(1, -1, 1, 1).copy()) \
                .to(device)
            self._mean_on[key] = t
        return t

    def __repr__(self):
        return "AugmentSpec%r" % (self.signature(),)


def draw(batch: int, spec: AugmentSpec, train: bool,
         generator: Optional[torch.Generator] = None, device=None):
    """The ONE draw discipline: ``(dy, dx, flip)`` per sample, int64,
    int64 and bool tensors on ``device`` (default: the generator's).
    Train mode draws a crop offset with ``rand_crop`` (when the envelope
    leaves room) and a coin per sample with ``rand_mirror``, in that
    order; eval mode center-crops and never flips, drawing nothing."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    c, h, w = spec.data_shape
    hp, wp, _ = spec.pre_shape
    if train and spec.rand_crop and (hp > h or wp > w):
        dy = torch.randint(0, hp - h + 1, (batch,), generator=generator,
                           device=device)
        dx = torch.randint(0, wp - w + 1, (batch,), generator=generator,
                           device=device)
    else:
        dy = torch.full((batch,), (hp - h) // 2, dtype=torch.int64,
                        device=device)
        dx = torch.full((batch,), (wp - w) // 2, dtype=torch.int64,
                        device=device)
    if train and spec.rand_mirror:
        flip = torch.rand((batch,), generator=generator, device=device) < 0.5
    else:
        flip = torch.zeros((batch,), dtype=torch.bool, device=device)
    return dy, dx, flip


def _draws(rng, batch, spec, train, device):
    """``rng``: a generator to draw from, or a ``(dy, dx, flip)`` triple
    (tensors or arrays)."""
    if rng is None or isinstance(rng, torch.Generator):
        return draw(batch, spec, train, rng, device)
    return tuple(torch.as_tensor(t, device=device).to(dt)
                 for t, dt in zip(rng, (torch.int64, torch.int64,
                                        torch.bool)))


def augment_batch(x: torch.Tensor, rng, spec: AugmentSpec, train: bool,
                  out_draws: Optional[list] = None) -> torch.Tensor:
    """Prologue: ``(B, Hp, Wp, C) uint8 -> (B, C, H, W) float32``.

    Per-sample crop and horizontal flip as one gather through index
    tensors, then HWC->CHW, the cast, ``- mean`` and ``* f32(scale)``:
    the op order of the host path's ``crop_mirror_normalize``, so the
    pixels match :func:`augment_batch_host` bitwise.  ``rng`` is a
    generator (drawn from with :func:`draw`) or given draws; the draws
    used are appended to ``out_draws`` when it is a list."""
    c, h, w = spec.data_shape
    b, hp, wp, _ = x.shape
    dev = x.device
    dy, dx, flip = _draws(rng, b, spec, train, dev)
    if out_draws is not None:
        out_draws.append((dy, dx, flip))
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    rows = dy[:, None] + ar_h                              # (B, h)
    cols = torch.where(flip[:, None], dx[:, None] + (w - 1 - ar_w),
                       dx[:, None] + ar_w)                 # (B, w)
    base = torch.arange(b, device=dev)[:, None, None] * hp
    lin = ((base + rows[:, :, None]) * wp + cols[:, None, :]).reshape(-1)
    out = x.reshape(b * hp * wp, c).index_select(0, lin)
    out = out.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous() \
        .to(torch.float32)
    if spec.mean is not None:
        out = out - spec.mean_on(dev)
    if spec.scale != 1.0:
        out = out * float(np.float32(spec.scale))
    return out


def augment_batch_host(x, rng, spec: AugmentSpec, train: bool):
    """Numpy twin of :func:`augment_batch`: same draws, same op order,
    host execution.  The parity oracle for tests."""
    x = np.asarray(x)
    c, h, w = spec.data_shape
    b = x.shape[0]
    dy, dx, flip = (t.cpu().numpy() for t in _draws(rng, b, spec, train,
                                                    None if isinstance(
                                                        rng, torch.Generator)
                                                    else "cpu"))
    out = np.empty((b, h, w, c), x.dtype)
    for i in range(b):
        out[i] = x[i, dy[i]:dy[i] + h, dx[i]:dx[i] + w, :]
        if flip[i]:
            out[i] = out[i][:, ::-1, :]
    out = out.transpose(0, 3, 1, 2).astype(np.float32)
    if spec.mean is not None:
        out = out - spec.mean.reshape(1, c, 1, 1).astype(np.float32)
    if spec.scale != 1.0:
        out = out * np.float32(spec.scale)
    return out
