"""Data-parallel training step over a mesh's ``dp`` axis (counterpart of
``mxnet_tpu/parallel/data_parallel.py``).

The JAX package jits forward, backward, the gradient all-reduce and a
fused SGD update into one sharded program over the global batch.  The
port runs one rank per device: each rank keeps a replica of the
params, takes its slice of the global batch (``shard_batch``), runs the
graph walk (``executor._GraphProgram``) forward and autograd backward
on it, sums the gradients over ``dp`` and applies the same fused SGD
(``g * rescale + wd * p``, then momentum), with ``rescale`` = 1 / the
GLOBAL batch.  Ops that reduce over the batch axis see the global batch
(``OpContext.dp``: BatchNorm's statistics, the loss layers'
normalizations), and the outputs come back all-gathered, so the
results are the single-process results.

``compute_dtype`` (e.g. ``torch.bfloat16``) runs the forward and
backward in that type over float32 master params and momentum; labels
and embedding ids stay uncast.  ``remat=True`` recomputes the whole
loss in the backward (``executor.checkpointed``: its draws replayed).
``MXNET_SHARD_WEIGHT_UPDATE=1`` reduce-scatters the gradients of params
whose leading dim the dp size divides, updates this rank's rows and
their momentum only, and all-gathers the rows back.

``param_specs`` (``{name: PartitionSpec}`` over the mesh's axes, tensor
parallelism): each rank holds its shard of such a parameter and of its
momentum, the graph walk runs over layouts (``executor._GraphProgram.
eval(shards=)``), and a shard's gradient is summed over ``dp`` (a
parameter cut over ``dp`` itself gets its sum from its gather's
backward).  ``params_numpy`` gathers the whole values.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..base import MXNetError, get_env
from ..context import gpu
from ..executor import _GraphProgram, checkpointed
from ..ops.registry import OpContext
from .. import random as _random
from . import collectives as C
from .mesh import (gather_tensor, normalize_spec, shard_tensor, spec_axes,
                   spec_pairs, validate_spec)

__all__ = ["DPTrainStep", "cast_compute"]


def cast_compute(args: Dict[str, torch.Tensor], compute_dtype,
                 skip) -> Dict[str, torch.Tensor]:
    """Float tensors to ``compute_dtype`` except the names in ``skip``
    (labels and id-valued inputs)."""
    if compute_dtype is None:
        return args
    return {k: v.to(compute_dtype)
            if k not in skip and v.is_floating_point() else v
            for k, v in args.items()}


def _dtype(d):
    if d is None or isinstance(d, torch.dtype):
        return d
    name = np.dtype(d).name if not isinstance(d, str) else d
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[name]


def gather_outputs(outs, axis, local_batch):
    """Outputs with the local batch as leading dim, all-gathered over
    the axis (the global batch's outputs); others as they are."""
    return [C.all_gather(o, axis) if o.dim() and o.shape[0] == local_batch
            else o for o in outs]


class DPTrainStep:
    """One data-parallel train step of a loss-headed symbol over the
    ``dp`` axis of ``mesh`` (reference ``DPTrainStep``).  ``ctx``: this
    rank's device, default its card."""

    def __init__(self, symbol, mesh, data_names=("data",),
                 label_names=("softmax_label",), learning_rate=0.01,
                 momentum=0.9, weight_decay=1e-4, rescale_grad=None,
                 param_specs=None, dtype=np.float32, compute_dtype=None,
                 remat=False, ctx=None):
        if "dp" not in mesh.axis_names:
            raise MXNetError("mesh %s has no 'dp' axis" % (dict(mesh.shape),))
        self.symbol = symbol
        self.mesh = mesh
        self.ctx = ctx if ctx is not None else gpu(0)
        self.device = self.ctx.torch_device()
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        self.lr = learning_rate
        self.momentum = momentum
        self.wd = weight_decay
        self.rescale = rescale_grad
        self.param_specs = {}
        for n, sp in (param_specs or {}).items():
            sp = normalize_spec(sp)
            validate_spec(n, sp, mesh)
            if any(e is not None for e in sp):
                self.param_specs[n] = sp
        # name -> its (dim, axis) cuts, set by init
        self._cuts = {}
        self.compute_dtype = _dtype(compute_dtype)
        from ..symbol import id_valued_inputs
        self._no_cast = set(self.label_names) | id_valued_inputs(symbol)
        self._remat = remat
        self._prog = _GraphProgram(symbol)
        inputs = set(self.data_names) | set(self.label_names)
        self.param_names = [n for n in symbol.list_arguments()
                            if n not in inputs]
        self.aux_names = symbol.list_auxiliary_states()
        self.axis = mesh.axis("dp")
        self.shard_update = get_env("MXNET_SHARD_WEIGHT_UPDATE", False, bool)
        self._rows = {}

    # -- state ----------------------------------------------------------------
    def init(self, arg_params, aux_params):
        """The state on this rank's device: params (autograd leaves),
        aux, and momentum (this rank's rows under the sharded update)."""
        self._cuts = {}

        def put(v, k):
            t = torch.as_tensor(np.asarray(v)).to(self.device, copy=True)
            spec = self.param_specs.get(k)
            if spec is None:
                return t
            validate_spec(k, spec, self.mesh, shape=tuple(t.shape))
            self._cuts[k] = spec_pairs(spec, t.dim())
            return shard_tensor(t, self._cuts[k], self.mesh)
        params = {k: put(v, k).requires_grad_(True)
                  for k, v in arg_params.items() if k in self.param_names}
        aux = {k: put(v, k) for k, v in aux_params.items()}
        self._rows = {}
        for k, p in params.items():
            spec = tuple(self.param_specs.get(k) or ())
            if "dp" in spec_axes(spec):
                self._rows[k] = "summed"
            elif spec and spec[0] is not None:
                self._rows[k] = None
            else:
                self._rows[k] = C.shard_rows(self.axis, tuple(p.shape),
                                             self.shard_update)
        mom = None
        if self.momentum:
            mom = {}
            for k, p in params.items():
                r = self._rows[k]
                mom[k] = torch.zeros_like(p.detach() if not isinstance(r, tuple)
                                          else p.detach()[r[0]:r[1]])
        return {"params": params, "aux": aux, "mom": mom}

    def shard_batch(self, data) -> Dict[str, torch.Tensor]:
        """This rank's slice of the GLOBAL batch (rows ``index * B/dp``
        onwards), on its device."""
        out = {}
        for k, v in data.items():
            t = torch.as_tensor(np.asarray(v))
            n = t.shape[0]
            if n % self.axis.size:
                raise MXNetError(
                    "global batch %d of %r is not divisible by dp=%d"
                    % (n, k, self.axis.size))
            b = n // self.axis.size
            out[k] = t[self.axis.index * b:(self.axis.index + 1) * b].to(
                self.device, copy=True)
        return out

    # -- the step -------------------------------------------------------------
    def __call__(self, state, batch, rng=None):
        """One step in place on ``state``; -> (state, the global batch's
        outputs).  ``rng`` is accepted for the reference's signature; the
        ops draw from the device's generator."""
        params, aux, mom = state["params"], state["aux"], state["mom"]
        names = list(params)
        local = batch[self.data_names[0]].shape[0]
        rescale = self.rescale if self.rescale is not None \
            else 1.0 / (local * self.axis.size)
        opctx = OpContext(is_train=True,
                          generator=_random.generator(self.device),
                          dp=self.axis,
                          mesh=self.mesh if self._cuts else None)
        cdt = self.compute_dtype

        def loss(*leaves):
            args = dict(zip(names, leaves))
            args.update(batch)
            args = cast_compute(args, cdt, self._no_cast)
            outs, new_aux = self._prog.eval(args, aux, opctx,
                                            shards=self._cuts)
            return tuple(outs), new_aux

        leaves = [params[n] for n in names]
        with torch.enable_grad():
            if self._remat:
                outs, new_aux = checkpointed(loss, opctx, *leaves)
            else:
                outs, new_aux = loss(*leaves)
            heads = [o for o in outs if o.requires_grad]
            grads = torch.autograd.grad(
                heads, leaves, grad_outputs=[torch.ones_like(o)
                                             for o in heads],
                allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(leaves, grads)]
        lr, m, wd = self.lr, self.momentum, self.wd

        def update(i, p, g):
            g = g * rescale + wd * p
            if mom is not None:
                v = mom[names[i]]
                v.mul_(m).sub_(lr * g)
                p.add_(v)
            else:
                p.sub_(lr * g)
        with torch.no_grad():
            C.dp_update(self.axis, [p.detach() for p in leaves], grads,
                        [self._rows[n] for n in names], update)
            for k, v in new_aux.items():
                aux[k].copy_(v)
            outs = gather_outputs([o.detach().float() if cdt else o.detach()
                                   for o in outs], self.axis, local)
        return state, outs

    def params_numpy(self, state) -> Dict[str, np.ndarray]:
        """The params of ``state`` as host arrays, shards gathered whole
        (a collective under param_specs: every rank calls it)."""
        return {k: gather_tensor(v.detach(), self._cuts.get(k) or [],
                                 self.mesh).cpu().numpy()
                for k, v in state["params"].items()}
