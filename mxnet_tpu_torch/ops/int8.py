"""The int8 products of quantized serving: int8 x int8 summed exactly in
int32, on the card and on the CPU.

The JAX package computes these products outside any Pallas kernel, as
``lax.dot_general`` / ``lax.conv_general_dilated`` with
``preferred_element_type=jnp.int32`` (``mxnet_tpu/ops/quantized.py``,
``mxnet_tpu/ops/fused.py``).  Its codes are exact integers, so the port's
must be equal, not close.  A float32 or TF32 product is not exact: one
product is at most 127² = 16,129, and at K = 4,608 (VGG-16's conv4/conv5)
a sum can reach 7.4e7, past 2^24.  PyTorch has no int8 ``conv2d`` on
CUDA.  So:

* **card route** (CUDA tensors): ``torch._int_mm`` (int8 x int8 -> int32
  on the int8 tensor cores, exact).  A convolution is an im2col copy
  (NHWC patches, K ordered (kh, kw, c), taken as a strided view of the
  padded int8 input and copied once) followed by ``_int_mm``.
  ``_int_mm`` takes M > 16 rows and K, N multiples of 8: the route pads
  with zero rows and columns, which adds nothing to any sum.  A shape it
  still cannot take raises; nothing falls back;
* **plain version** (CPU tensors, and the card route's check in
  ``chip_smoke.py``): the same sums in float64, then rounded to int32.
  Every partial sum is an integer below 2^53, so float64 sums them
  exactly in any order.

The route is chosen by the tensors' device only.  :data:`ROUTE_CALLS`
counts the card route's library calls (``_int_mm`` and the im2col copy),
so a run can show that its int8 layers went this way.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from ..base import MXNetError, make_lock

__all__ = ["int8_matmul", "int8_matmul_reference", "int8_conv2d",
           "int8_conv2d_reference", "ROUTE_CALLS", "reset_route_calls"]

# card-route library calls since the last reset_route_calls()
ROUTE_CALLS: Dict[str, int] = {"int_mm": 0, "im2col": 0}
_calls_lock = make_lock("int8.route_calls")

# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def reset_route_calls() -> None:
    with _calls_lock:
        for name in ROUTE_CALLS:
            ROUTE_CALLS[name] = 0


def _count(name: str) -> None:
    with _calls_lock:
        ROUTE_CALLS[name] += 1


def _on_cpu(*tensors) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise MXNetError("int8 product: inputs must all be on the CPU or "
                         "all on one CUDA device, got %s"
                         % [str(t.device) for t in tensors])
    return False


def _check_int8(what: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int8:
            raise MXNetError("%s: int8 inputs required, got %s"
                             % (what, t.dtype))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# matrix product

def int8_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int8_matmul`: ``x · wᵀ`` in float64, exact
    for int8 inputs at any K below 2^53 / 127², rounded to int32."""
    return torch.round(torch.matmul(x.double(), w.double().t())).to(
        torch.int32)


def _int_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The card route's product: ``torch._int_mm`` on x and w padded with
    zeros to its shapes (the padding adds nothing to any sum)."""
    m, k = x.shape
    n = w.shape[0]
    mp, kp, np_ = max(m, _MIN_ROWS), _round_up(k, _ALIGN), \
        _round_up(n, _ALIGN)
    x = x.contiguous()
    if (mp, kp) != (m, k):
        x = F.pad(x, (0, kp - k, 0, mp - m))
    w = w.contiguous()
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    # w.t() is the column-major (K, N) operand cuBLASLt's int8 GEMM takes
    out = torch._int_mm(x, w.t())
    _count("int_mm")
    return out if (mp, np_) == (m, n) else out[:m, :n]


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x · wᵀ`` summed exactly in int32 for x (M, K) and w (N, K) int8.

    CUDA tensors take ``torch._int_mm`` (padded to its shapes with zeros);
    CPU tensors take :func:`int8_matmul_reference`."""
    _check_int8("int8_matmul", x, w)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise MXNetError("int8_matmul: need x (M, K) and w (N, K), got %s "
                         "and %s" % (tuple(x.shape), tuple(w.shape)))
    if _on_cpu(x, w):
        return int8_matmul_reference(x, w)
    if x.shape[0] == 0 or w.shape[0] == 0:
        return torch.zeros((x.shape[0], w.shape[0]), dtype=torch.int32,
                           device=x.device)
    return _int_mm(x, w)


# ---------------------------------------------------------------------------
# convolution

def int8_conv2d_reference(x: torch.Tensor, w: torch.Tensor,
                          stride: Sequence[int], pad: Sequence[int],
                          dilate: Sequence[int], groups: int = 1
                          ) -> torch.Tensor:
    """Plain version of :func:`int8_conv2d`: ``F.unfold`` and a matrix
    product in float64 (exact for int8 inputs; no convolution algorithm
    of a library, whose transforms could round), rounded to int32."""
    n = x.shape[0]
    o, cg, kh, kw = w.shape
    oh = (x.shape[2] + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (x.shape[3] + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    cols = F.unfold(x.double(), (kh, kw), dilation=tuple(dilate),
                    padding=tuple(pad), stride=tuple(stride))
    cols = cols.reshape(n, groups, cg * kh * kw, oh * ow)
    out = torch.matmul(w.double().reshape(groups, o // groups, -1), cols)
    return torch.round(out).to(torch.int32).reshape(n, o, oh, ow)


def _im2col(x: torch.Tensor, kernel, stride, dilate, oh, ow) -> torch.Tensor:
    """(N, C, H, W) int8, already padded -> (N*OH*OW, KH*KW*C) patches,
    K ordered (kh, kw, c): one copy out of a strided NHWC view."""
    n, c = x.shape[0], x.shape[1]
    x = x.contiguous(memory_format=torch.channels_last)
    s_n, s_c, s_h, s_w = x.stride()
    kh, kw = kernel
    view = x.as_strided(
        (n, oh, ow, kh, kw, c),
        (s_n, s_h * stride[0], s_w * stride[1], s_h * dilate[0],
         s_w * dilate[1], s_c))
    _count("im2col")
    return view.reshape(n * oh * ow, kh * kw * c)


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                pad: Sequence[int], dilate: Sequence[int],
                groups: int = 1) -> torch.Tensor:
    """NCHW x OIHW int8 convolution summed exactly in int32 (NCHW out).

    CUDA tensors take im2col + ``torch._int_mm`` per group (the result
    is laid out channels-last in memory); CPU tensors take
    :func:`int8_conv2d_reference`."""
    _check_int8("int8_conv2d", x, w)
    if x.dim() != 4 or w.dim() != 4 or groups < 1 \
            or x.shape[1] != w.shape[1] * groups \
            or w.shape[0] % groups != 0:
        raise MXNetError("int8_conv2d: need x (N, C, H, W) and w (O, C/%d, "
                         "KH, KW), got %s and %s"
                         % (groups, tuple(x.shape), tuple(w.shape)))
    if _on_cpu(x, w):
        return int8_conv2d_reference(x, w, stride, pad, dilate, groups)
    return _conv_route(x, w, stride, pad, dilate, groups)


def _conv_route(x, w, stride, pad, dilate, groups) -> torch.Tensor:
    """The card route of :func:`int8_conv2d`: im2col and ``_int_mm`` per
    group, the result laid out channels-last in memory."""
    n, c, h, wd = x.shape
    o, cg, kh, kw = w.shape
    oh = (h + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (wd + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    if oh < 1 or ow < 1:
        raise MXNetError("int8_conv2d: empty output for input %s and "
                         "kernel %s" % (tuple(x.shape), (kh, kw)))
    if pad[0] or pad[1]:
        x = F.pad(x, (pad[1], pad[1], pad[0], pad[0]))
    og = o // groups
    outs = []
    for g in range(groups):
        xg = x[:, g * cg:(g + 1) * cg]
        wg = w[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, -1)
        outs.append(_int_mm(_im2col(xg, (kh, kw), stride, dilate, oh, ow),
                            wg))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(n, oh, ow, o).permute(0, 3, 1, 2)
