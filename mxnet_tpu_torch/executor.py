"""Executor: binds a Symbol to arrays on one device and runs it forward
and backward.

The counterpart of ``mxnet_tpu/executor.py``.  Where the JAX package
traces the graph into one XLA program and takes ``jax.vjp`` of it, this
executor walks the same node order (``_GraphProgram.eval``) eagerly, one
op forward per node, each op launching its PyTorch calls or hand-written
kernels on the current stream; backward is ``torch.autograd.grad`` over
the arguments whose ``grad_req`` is not ``"null"``, through the graph the
train forward recorded.  An eval forward drops each intermediate tensor
once its last consumer has run.  A monitor callback
(``set_monitor_callback``) sees every node's outputs as they are made,
under the reference's names (``<node>_output``, or ``<node>_<output>``
for a node with several).

``group2ctx`` (``bind``/``simple_bind``) places model-parallel graphs:
the arrays of a variable whose ``ctx_group`` attribute names a group
land on that group's context, and each op runs on its group's device,
its inputs moved there first (reference executor.py:144-167,
graph_executor.cc AssignContext).  Distinct ``cpu(i)`` contexts share
the host, and every group on ``gpu(0)`` shares the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .context import Context
from .engine import _ENGINE
from .ndarray import NDArray, zeros as nd_zeros
from .ops.registry import OpContext
from . import random as _random
from .symbol import Symbol, _Node, _topo

__all__ = ["Executor", "bind", "simple_bind"]


def _node_aux_names(node: _Node) -> List[str]:
    return ["%s_%s" % (node.name, a)
            for a in node.op.list_auxiliary_states(node.params)]


def _head_grad_unused(node: _Node, memo: dict) -> bool:
    """True when an omitted head gradient for this output cannot reach any
    argument: every backward path from the head hits an op whose backward
    ignores the incoming gradient (the loss layers), as in the reference
    (``mxnet_tpu/executor.py`` ``_head_grad_unused``)."""
    key = id(node)
    if key in memo:
        return memo[key]
    if node.is_variable:
        result = False
    elif node.op.head_grad_optional:
        result = True
    else:
        memo[key] = True
        result = all(_head_grad_unused(inp, memo)
                     for (inp, _) in node.inputs)
    memo[key] = result
    return result


class _GraphProgram:
    """The graph as a node list in topological order, with the number
    of consumers of each node output."""

    def __init__(self, symbol: Symbol, node_device=None):
        self.symbol = symbol
        # {id(node): torch.device} of the nodes group2ctx placed
        self.node_device = node_device or {}
        self.topo = _topo(symbol._heads)
        self.uses: Dict[tuple, int] = {}
        for node in self.topo:
            for (i, x) in node.inputs:
                key = (id(i), x)
                self.uses[key] = self.uses.get(key, 0) + 1
        for (n, i) in symbol._heads:
            self.uses[(id(n), i)] = self.uses.get((id(n), i), 0) + 1
        self.monitor = None

    def eval(self, args: Dict[str, torch.Tensor],
             aux: Dict[str, torch.Tensor], opctx: Optional[OpContext] = None):
        """Run every node; -> (outputs, new_aux) where ``new_aux`` holds
        the states a train forward updated (BatchNorm's moving
        statistics), by name."""
        opctx = opctx if opctx is not None else OpContext(is_train=False)
        vals: Dict[tuple, torch.Tensor] = {}
        new_aux: Dict[str, torch.Tensor] = {}
        left = dict(self.uses)
        for node in self.topo:
            if node.is_variable:
                if node.name not in args:
                    raise MXNetError("executor missing argument %r"
                                     % node.name)
                vals[(id(node), 0)] = args[node.name]
                continue
            ins = [vals[(id(i), x)] for (i, x) in node.inputs]
            aux_names = _node_aux_names(node)
            aux_in = [aux[a] for a in aux_names]
            dev = self.node_device.get(id(node))
            if dev is not None:
                ins = [t if t.device == dev else t.to(dev) for t in ins]
                aux_in = [t if t.device == dev else t.to(dev)
                          for t in aux_in]
            outs = node.op.forward(node.params, ins, aux_in, opctx)
            if isinstance(outs, tuple):
                outs, aux_out = outs
                new_aux.update(zip(aux_names, aux_out))
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
            if _ENGINE._naive:
                _ENGINE.track(outs)
            if self.monitor is not None:
                out_names = node.op.list_outputs(node.params)
                for i, o in enumerate(outs):
                    self.monitor("%s_%s" % (node.name, out_names[i])
                                 if len(outs) > 1
                                 else "%s_output" % node.name, o.detach())
            for (i, x) in node.inputs:
                key = (id(i), x)
                left[key] -= 1
                if left[key] == 0:
                    del vals[key]
        return [vals[(id(n), i)] for (n, i) in self.symbol._heads], new_aux


class Executor:
    """Bound executor over NDArray arguments on one context (reference
    python/mxnet/executor.py)."""

    def __init__(self, symbol: Symbol, ctx: Context,
                 arg_dict: Dict[str, NDArray],
                 grad_dict: Dict[str, Optional[NDArray]],
                 grad_req: Dict[str, str],
                 aux_dict: Dict[str, NDArray],
                 group2ctx: Optional[Dict[str, Context]] = None):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_dict = arg_dict
        self.grad_dict = grad_dict
        self.aux_dict = aux_dict
        self._grad_req = grad_req
        self._group2ctx = dict(group2ctx or {})
        node_device = {}
        for node in _topo(symbol._heads):
            grp = node.attrs.get("ctx_group")
            if grp and grp in self._group2ctx:
                node_device[id(node)] = self._group2ctx[grp].torch_device()
        self._prog = _GraphProgram(symbol, node_device)
        self._outputs_nd: Optional[List[NDArray]] = None
        # (leaf tensors of the graded arguments, recorded outputs) of the
        # last train forward, consumed by backward()
        self._recorded = None
        self.arg_arrays = [arg_dict[n] for n in symbol.list_arguments()]
        self.grad_arrays = [grad_dict.get(n)
                            for n in symbol.list_arguments()]
        self.aux_arrays = [aux_dict[n]
                           for n in symbol.list_auxiliary_states()]
        self._grad_names = [n for n in symbol.list_arguments()
                            if grad_req.get(n, "null") != "null"
                            and grad_dict.get(n) is not None]

    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs_nd is None:
            raise MXNetError("call forward() first")
        return self._outputs_nd

    @property
    def output_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def _opctx(self, is_train: bool) -> OpContext:
        return OpContext(is_train=is_train,
                         generator=_random.generator(self._ctx))

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        """Run the graph; keyword arguments are written into the bound
        arguments first.  A train forward records the graph for
        backward() and commits the updated aux states."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %r" % k)
            self.arg_dict[k][:] = v
        args = {k: v._get() for k, v in self.arg_dict.items()}
        aux = {k: v._get() for k, v in self.aux_dict.items()}
        self._recorded = None
        if not is_train:
            with torch.inference_mode():
                outs, _ = self._prog.eval(args, aux, self._opctx(False))
            self._outputs_nd = [NDArray(o) for o in outs]
            return self._outputs_nd
        leaves = {n: args[n].detach().requires_grad_(True)
                  for n in self._grad_names}
        args.update(leaves)
        with torch.enable_grad():
            outs, new_aux = self._prog.eval(args, aux, self._opctx(True))
        with torch.no_grad():
            for k, v in new_aux.items():
                self.aux_dict[k]._get().copy_(v)
        if leaves:
            self._recorded = (leaves, outs)
        self._outputs_nd = [NDArray(o.detach()) for o in outs]
        return self._outputs_nd

    def backward(self, out_grads=None) -> None:
        """Fill the gradient arrays, honouring grad_req write/add/null
        (reference executor.py:91).  Without ``out_grads`` every head
        gradient is ones (the loss layers ignore theirs); a shorter list
        may omit only heads whose gradient cannot reach an argument."""
        if self._outputs_nd is None:
            raise MXNetError("backward() requires a prior "
                             "forward(is_train=True)")
        if self._recorded is None:
            if self._grad_names:
                raise MXNetError("backward() requires a prior "
                                 "forward(is_train=True)")
            return
        leaves, outs = self._recorded
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            heads = [(g._get() if isinstance(g, NDArray)
                      else torch.as_tensor(np.asarray(g)))
                     .to(device=o.device, dtype=o.dtype)
                     for g, o in zip(out_grads, outs)]
            if len(out_grads) > len(outs):
                raise MXNetError("backward() got %d out_grads for %d "
                                 "outputs" % (len(out_grads), len(outs)))
            for k in range(len(heads), len(outs)):
                node = self._symbol._heads[k][0]
                if not _head_grad_unused(node, {}):
                    raise MXNetError(
                        "backward() got %d out_grads but output %d (%s) "
                        "requires a head gradient" % (len(heads), k,
                                                      node.name))
                heads.append(torch.zeros_like(outs[k]))
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad(
            [o for o, _ in pairs], [leaves[n] for n in names],
            grad_outputs=[h for _, h in pairs], allow_unused=True) \
            if pairs else [None] * len(names)
        with torch.no_grad():
            for name, g in zip(names, grads):
                tgt = self.grad_dict[name]._get()
                if self._grad_req.get(name) == "add":
                    if g is not None:
                        tgt.add_(g)
                elif g is None:
                    tgt.zero_()
                else:
                    tgt.copy_(g)
        self._recorded = None

    def set_monitor_callback(self, callback):
        """Call ``callback(name, NDArray)`` on every node output of each
        later forward (reference symbolic.h:386-390)."""
        self._prog.monitor = lambda name, t: callback(name, NDArray(t))

    def reshape(self, **new_shapes) -> "Executor":
        """A new executor for new input shapes; arrays whose shape is
        unchanged (the parameters and their gradients) are shared, not
        copied."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**new_shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes for reshape")

        def share(old, sh):
            return old if old.shape == tuple(sh) else \
                nd_zeros(sh, ctx=self._ctx, dtype=old.dtype)
        names = self._symbol.list_arguments()
        new_args = {n: share(self.arg_dict[n], sh)
                    for n, sh in zip(names, arg_shapes)}
        new_grads = {n: share(self.grad_dict[n], sh)
                     for n, sh in zip(names, arg_shapes)
                     if self.grad_dict.get(n) is not None}
        new_aux = {n: share(self.aux_dict[n], sh) for n, sh in
                   zip(self._symbol.list_auxiliary_states(), aux_shapes)}
        return Executor(self._symbol, self._ctx, new_args, new_grads,
                        self._grad_req, new_aux, group2ctx=self._group2ctx)

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

    def debug_str(self) -> str:
        """The execution plan: every node in order with its context, and
        the bytes the bound arguments and aux states hold (reference
        graph_executor.cc:955-988)."""
        lines = ["Symbol Outputs:",
                 "\t" + ", ".join(self._symbol.list_outputs())]
        for node in self._prog.topo:
            if node.is_variable:
                lines.append("Variable:%s ctx=%s" % (node.name, self._ctx))
            else:
                lines.append("Op:%s Name=%s ctx=%s"
                             % (node.op.name, node.name, self._ctx))
                for (i, x) in node.inputs:
                    lines.append("\targ[%d]=%s" % (x, i.name))
        total = sum(arr.size * arr.dtype.itemsize for arr in
                    list(self.arg_dict.values())
                    + list(self.aux_dict.values()))
        lines.append("Total %.1f MB allocated (args+aux)" % (total / 2**20))
        return "\n".join(lines)


def _grad_req_dict(grad_req, arg_names) -> Dict[str, str]:
    if isinstance(grad_req, str):
        req = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        req = dict(zip(arg_names, grad_req))
    else:
        req = {n: grad_req.get(n, "null") for n in arg_names}
    bad = sorted({r for r in req.values()} - {"null", "write", "add"})
    if bad:
        raise MXNetError("grad_req must be 'null', 'write' or 'add'; got %s"
                         % bad)
    return req


def bind(symbol: Symbol, ctx: Context, args, args_grad=None,
         grad_req="write", aux_states=None, group2ctx=None,
         shared_exec=None) -> Executor:
    """Bind given arrays (reference symbol.py bind): ``args``/``args_grad``
    /``aux_states`` as lists in ``list_arguments()`` order or dicts; an
    argument without a gradient array gets grad_req ``"null"``.
    ``group2ctx`` maps ``ctx_group`` names to the contexts their ops run
    on; ``shared_exec`` is accepted for the reference's signature (the
    given arrays are bound as they are)."""
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    if isinstance(args, (list, tuple)):
        if len(args) != len(arg_names):
            raise MXNetError("bind needs %d args, got %d"
                             % (len(arg_names), len(args)))
        arg_dict = dict(zip(arg_names, args))
    else:
        arg_dict = dict(args)
        missing = [n for n in arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("bind missing arguments %s" % missing)
    if args_grad is None:
        grad_dict = {}
    elif isinstance(args_grad, (list, tuple)):
        grad_dict = dict(zip(arg_names, args_grad))
    else:
        grad_dict = dict(args_grad)
    req = _grad_req_dict(grad_req, arg_names)
    for n in arg_names:
        if grad_dict.get(n) is None:
            req[n] = "null"
    if aux_states is None:
        aux_dict = {}
        if aux_names:
            _, _, aux_shapes = symbol.infer_shape(
                **{n: a.shape for n, a in arg_dict.items()})
            aux_dict = {n: nd_zeros(sh, ctx=ctx)
                        for n, sh in zip(aux_names, aux_shapes)}
    elif isinstance(aux_states, (list, tuple)):
        aux_dict = dict(zip(aux_names, aux_states))
    else:
        aux_dict = dict(aux_states)
    return Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict,
                    group2ctx=group2ctx)


def simple_bind(symbol: Symbol, ctx: Context, grad_req="write",
                type_dict=None, shared_exec: Optional[Executor] = None,
                group2ctx=None, **kwargs) -> Executor:
    """Infer shapes, allocate the arrays (and the gradient arrays of every
    argument whose grad_req is not ``"null"``) on ``ctx`` (on its group's
    context for a variable with a ``ctx_group`` in ``group2ctx``) and
    bind.  Arrays of ``shared_exec`` with the same name and shape are
    shared (one set of parameter buffers for every input shape)."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
    if arg_shapes is None:
        raise MXNetError("simple_bind cannot infer all shapes from %s"
                         % kwargs)
    type_dict = type_dict or {}
    arg_names = symbol.list_arguments()
    req = _grad_req_dict(grad_req, arg_names)

    attrs = symbol.attr_dict() if group2ctx else {}

    def _alloc(name, shape, pool, dtype):
        if shared_exec is not None and pool.get(name) is not None and \
                pool[name].shape == tuple(shape):
            return pool[name]
        grp = attrs.get(name, {}).get("ctx_group")
        return nd_zeros(shape, ctx=group2ctx.get(grp, ctx) if grp else ctx,
                        dtype=dtype)

    arg_dict = {name: _alloc(name, sh, shared_exec.arg_dict if shared_exec
                             else {}, type_dict.get(name, np.float32))
                for name, sh in zip(arg_names, arg_shapes)}
    grad_dict = {name: _alloc(name, sh, shared_exec.grad_dict if shared_exec
                              else {}, type_dict.get(name, np.float32))
                 for name, sh in zip(arg_names, arg_shapes)
                 if req[name] != "null"}
    aux_dict = {name: _alloc(name, sh, shared_exec.aux_dict if shared_exec
                             else {}, np.float32)
                for name, sh in zip(symbol.list_auxiliary_states(),
                                    aux_shapes)}
    return Executor(symbol, ctx, arg_dict, grad_dict, req, aux_dict,
                    group2ctx=group2ctx)
