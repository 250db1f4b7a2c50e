"""OpenCV plugin parity: image decode, resize and border functions.

The counterpart of ``mxnet_tpu/plugins/opencv.py`` (reference
plugin/opencv: cv::imread/imresize registered as NDArray functions).
Decoding uses PIL where it is installed and raises without it.
:func:`imresize` gives what the JAX package's ``jax.image.resize`` gives:
nearest sampling at ``floor((i + 0.5) * in / out)``, or the triangle
(linear) kernel, widened when downscaling (antialiasing) with its
weights renormalized at the edges, applied as one weight matrix per
axis (``jax.image.scale_and_translate``'s construction).
"""
from __future__ import annotations

import io as _io

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray, array as nd_array

__all__ = ["imread", "imdecode", "imresize", "copyMakeBorder"]


def _pil():
    try:
        from PIL import Image
        return Image
    except ImportError as e:
        raise MXNetError("image decode requires PIL (not in this build)") from e


def _decoded(img, flag: int) -> NDArray:
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return nd_array(arr, dtype=np.uint8)


def imread(path: str, flag: int = 1) -> NDArray:
    """Read an image file -> NDArray (H, W, C) uint8 (reference cv.imread)."""
    return _decoded(_pil().open(path), flag)


def imdecode(buf: bytes, flag: int = 1) -> NDArray:
    return _decoded(_pil().open(_io.BytesIO(buf)), flag)


def _weight_mat(m: int, n: int, device) -> torch.Tensor:
    """(m, n) weights of the triangle kernel resampling m samples to n
    (``jax.image.compute_weight_mat`` with antialiasing, in float32)."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n / m), dtype=f32)
    kernel_scale = torch.maximum(inv_scale, torch.tensor(1.0, dtype=f32))
    sample_f = (torch.arange(n, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp(1 - x.abs(), min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    off = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
    return torch.floor(off).to(torch.int64).to(device)


def imresize(src: NDArray, w: int, h: int, interpolation: int = 1) -> NDArray:
    """Resize an (H, W, C) image (reference cv.resize): nearest for
    ``interpolation`` 0, else linear with antialiasing."""
    arr = src._get()
    H, W = arr.shape[0], arr.shape[1]
    x = arr.to(torch.float32)
    if interpolation == 0:
        if H != h:
            x = x.index_select(0, _nearest_index(H, h, x.device))
        if W != w:
            x = x.index_select(1, _nearest_index(W, w, x.device))
    else:
        if H != h:
            x = torch.einsum("hwc,hH->Hwc", x, _weight_mat(H, h, x.device))
        if W != w:
            x = torch.einsum("hwc,wW->hWc", x, _weight_mat(W, w, x.device))
    return NDArray(x.to(arr.dtype))


def copyMakeBorder(src: NDArray, top, bot, left, right,
                   fill_value=0) -> NDArray:
    arr = src._get()
    out = arr.new_full((arr.shape[0] + top + bot, arr.shape[1] + left + right)
                       + tuple(arr.shape[2:]), fill_value)
    out[top:top + arr.shape[0], left:left + arr.shape[1]] = arr
    return NDArray(out)
