"""Carry parameters from the JAX package into the port.

Both packages keep convolution weights as OIHW and fully connected
weights as (N, K), so a parameter crosses over as a typed copy: same
name, shape, dtype and values, now a tensor on the chosen device.  The
paged-serving LM blob (``serve.paged.model``) is a flat dict of float32
arrays in both packages, with the same names and layouts.  A MoE block's
stacked expert tensors ((E, D, H) and (E, H, O), with (E, H) and (E, O)
biases) cross as any other parameter.  An ``EmbeddingTable``'s state
(``{"rows", "slots", "t"}``) and a ``device_embed`` store's
(``{key: that}``) cross with :func:`convert_embed_state`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .context import Context
from .ndarray import NDArray, array

__all__ = ["convert_params", "convert_lm_params", "convert_embed_state"]


def convert_params(params: Mapping[str, np.ndarray],
                   ctx: Optional[Context] = None
                   ) -> Tuple[Dict[str, NDArray], Dict[str, NDArray]]:
    """The JAX package's parameters (numpy arrays, or anything
    ``np.asarray`` takes, such as its NDArrays' ``asnumpy()``), keyed with
    or without the checkpoint's ``arg:``/``aux:`` prefixes, as
    ``(arg_params, aux_params)`` of port NDArrays on ``ctx`` (default:
    the current context).  Unprefixed names are arguments."""
    arg_params: Dict[str, NDArray] = {}
    aux_params: Dict[str, NDArray] = {}
    for key, value in params.items():
        value = np.asarray(value)
        target, name = arg_params, key
        if key.startswith("aux:"):
            target, name = aux_params, key[4:]
        elif key.startswith("arg:"):
            name = key[4:]
        target[name] = array(value, ctx=ctx, dtype=value.dtype)
    return arg_params, aux_params


def convert_lm_params(params: Mapping[str, np.ndarray], device
                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's LM blob (``init_lm_params``: numpy arrays, or
    anything ``np.asarray`` takes, or tensors) as float32 tensors on
    ``device`` (a ``torch.device``, a device string or a
    :class:`Context`), under the same names.  The tensors are copies:
    the caller's arrays stay its own."""
    if isinstance(device, Context):
        device = device.torch_device()
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v)).to(
                                   device=device, dtype=torch.float32,
                                   copy=True)
            for k, v in params.items()}


def convert_embed_state(tree, ctx: Optional[Context] = None):
    """The JAX package's ``EmbeddingTable.state()`` or
    ``KVStoreDeviceEmbed.save_state()`` tree (arrays, anything
    ``np.asarray`` takes, nested in dicts, tuples and lists, with None
    leaves) as the same tree of tensors on ``ctx`` (default: the current
    context), which ``EmbeddingTable.restore`` and
    ``KVStoreDeviceEmbed.load_state`` take.  The port's own state goes the
    other way as is: its leaves are tensors ``np.asarray`` reads once on
    the host (``.cpu()``)."""
    from .context import current_context
    device = (ctx if ctx is not None else current_context()).torch_device()

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        a = np.asarray(x)
        return torch.as_tensor(a.copy()).to(device)
    return conv(tree)
