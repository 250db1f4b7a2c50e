"""Executor: binds a Symbol to arrays on one device and runs it.

The counterpart of ``mxnet_tpu/executor.py``, eval only.  Where the JAX
package traces the graph into one XLA program, this executor walks the
same node order (``_GraphProgram.eval``) eagerly, one op forward per
node, each op launching its PyTorch calls or hand-written kernels on the
current stream.  An intermediate tensor is dropped once its last
consumer has run.  Gradients and training-mode forward come with the
training slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .context import Context
from .ndarray import NDArray, zeros as nd_zeros
from .ops.registry import OpContext
from .symbol import Symbol, _topo

__all__ = ["Executor", "simple_bind"]

_TRAINING = "(ROADMAP.md, queue 1 item 2: training)"


class _GraphProgram:
    """The graph as a node list in topological order, with the number
    of consumers of each node output."""

    def __init__(self, symbol: Symbol):
        self.symbol = symbol
        self.topo = _topo(symbol._heads)
        self.uses: Dict[tuple, int] = {}
        for node in self.topo:
            for (i, x) in node.inputs:
                key = (id(i), x)
                self.uses[key] = self.uses.get(key, 0) + 1
        for (n, i) in symbol._heads:
            self.uses[(id(n), i)] = self.uses.get((id(n), i), 0) + 1

    def eval(self, args: Dict[str, torch.Tensor],
             aux: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        vals: Dict[tuple, torch.Tensor] = {}
        left = dict(self.uses)
        opctx = OpContext(is_train=False)
        for node in self.topo:
            if node.is_variable:
                if node.name not in args:
                    raise MXNetError("executor missing argument %r"
                                     % node.name)
                vals[(id(node), 0)] = args[node.name]
                continue
            ins = [vals[(id(i), x)] for (i, x) in node.inputs]
            aux_in = [aux["%s_%s" % (node.name, a)]
                      for a in node.op.list_auxiliary_states(node.params)]
            outs = node.op.forward(node.params, ins, aux_in, opctx)
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            for (i, x) in node.inputs:
                key = (id(i), x)
                left[key] -= 1
                if left[key] == 0:
                    del vals[key]
        return [vals[(id(n), i)] for (n, i) in self.symbol._heads]


class Executor:
    """Bound executor over NDArray arguments on one context."""

    def __init__(self, symbol: Symbol, ctx: Context,
                 arg_dict: Dict[str, NDArray], aux_dict: Dict[str, NDArray]):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_dict = arg_dict
        self.aux_dict = aux_dict
        self._prog = _GraphProgram(symbol)
        self._outputs_nd: Optional[List[NDArray]] = None

    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs_nd is None:
            raise MXNetError("call forward() first")
        return self._outputs_nd

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; keyword arguments are written into the bound
        arguments first."""
        if is_train:
            raise NotImplementedError("forward(is_train=True) is not in the "
                                      "port yet " + _TRAINING)
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %r" % k)
            self.arg_dict[k][:] = v
        args = {k: v._get() for k, v in self.arg_dict.items()}
        aux = {k: v._get() for k, v in self.aux_dict.items()}
        with torch.inference_mode():
            outs = self._prog.eval(args, aux)
        self._outputs_nd = [NDArray(o) for o in outs]
        return self._outputs_nd

    def reshape(self, **new_shapes) -> "Executor":
        """A new executor for new input shapes; arrays whose shape is
        unchanged (the parameters) are shared, not copied."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**new_shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes for reshape")
        new_args = {}
        for name, sh in zip(self._symbol.list_arguments(), arg_shapes):
            old = self.arg_dict[name]
            new_args[name] = old if old.shape == tuple(sh) else \
                nd_zeros(sh, ctx=self._ctx, dtype=old._get().dtype)
        new_aux = {}
        for name, sh in zip(self._symbol.list_auxiliary_states(), aux_shapes):
            old = self.aux_dict[name]
            new_aux[name] = old if old.shape == tuple(sh) else \
                nd_zeros(sh, ctx=self._ctx, dtype=old._get().dtype)
        return Executor(self._symbol, self._ctx, new_args, new_aux)

    def copy_params_from(self, arg_params: Dict[str, NDArray],
                         aux_params: Optional[Dict[str, NDArray]] = None,
                         allow_extra_params: bool = False):
        """Write parameter values into the bound arrays, in place."""
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in executor arguments"
                                 % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = arr
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in executor aux states"
                                 % name)


def simple_bind(symbol: Symbol, ctx: Context, grad_req="write",
                type_dict=None, shared_exec: Optional[Executor] = None,
                **kwargs) -> Executor:
    """Infer shapes, allocate the arrays on ``ctx`` and bind.  Arrays of
    ``shared_exec`` with the same name and shape are shared (one set of
    parameter buffers for every input shape)."""
    reqs = grad_req.values() if isinstance(grad_req, dict) else \
        [grad_req] if isinstance(grad_req, str) else grad_req
    if any(r != "null" for r in reqs):
        raise NotImplementedError("gradients are not in the port yet; bind "
                                  "with grad_req='null' " + _TRAINING)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
    if arg_shapes is None:
        raise MXNetError("simple_bind cannot infer all shapes from %s"
                         % kwargs)
    type_dict = type_dict or {}

    def _alloc(name, shape, pool, dtype):
        if shared_exec is not None and name in pool and \
                pool[name].shape == tuple(shape):
            return pool[name]
        return nd_zeros(shape, ctx=ctx, dtype=dtype)

    arg_dict = {name: _alloc(name, sh, shared_exec.arg_dict if shared_exec
                             else {}, type_dict.get(name, np.float32))
                for name, sh in zip(symbol.list_arguments(), arg_shapes)}
    aux_dict = {name: _alloc(name, sh, shared_exec.aux_dict if shared_exec
                             else {}, np.float32)
                for name, sh in zip(symbol.list_auxiliary_states(),
                                    aux_shapes)}
    return Executor(symbol, ctx, arg_dict, aux_dict)
