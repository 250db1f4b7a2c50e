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

``set_mesh`` places an inference executor on a mesh (reference
executor.py:200-245): each argument or aux state with a spec is held as
this rank's shard, the forward walks the graph over layouts, and inputs
given a ``dp`` spec on dim 0 run this rank's rows, their outputs
gathered back.  Every rank of the mesh runs the same forwards.

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
             aux: Dict[str, torch.Tensor], opctx: Optional[OpContext] = None,
             shards: Optional[Dict[str, list]] = None,
             rows: Optional[Dict[str, int]] = None):
        """Run every node; -> (outputs, new_aux) where ``new_aux`` holds
        the states a train forward updated (BatchNorm's moving
        statistics), by name.

        ``shards`` (with ``opctx.mesh``): ``{name: (dim, axis) cuts}`` of
        the arguments and aux states held as this rank's shard
        (``parallel.mesh.spec_pairs``).  The walk then carries a layout
        per value and calls each op's ``forward_layout``; the outputs
        come back replicated.  A parameter cut once over an axis other
        than ``dp`` enters as a shard; one cut over ``dp`` or more than
        once is gathered where it enters (``collectives.gather_param``
        over ``dp``); an aux state is gathered before its op and its new
        value sliced back.

        ``rows`` (with ``opctx.dp``): ``{input name: batch dim}`` of the
        inputs that hold this rank's rows of a batch cut over ``dp``.  The
        walk carries ``Layout.shard(dim, "dp")`` for them and for every
        value an op makes of them with the batch rows at a dim of the same
        size (``OpDef.row_dim`` follows a moved dim), and hands the ops
        their inputs' row layouts (``opctx.in_rows``): an op that draws
        draws the global batch's numbers and keeps its rows.  No
        collective is made for them."""
        opctx = opctx if opctx is not None else OpContext(is_train=False)
        sharded = bool(shards) and opctx.mesh is not None
        vals: Dict[tuple, torch.Tensor] = {}
        lays: Dict[tuple, object] = {}
        rlays: Dict[tuple, object] = {}
        if opctx.dp is None:
            rows = None
        new_aux: Dict[str, torch.Tensor] = {}
        left = dict(self.uses)
        for node in self.topo:
            if node.is_variable:
                if node.name not in args:
                    raise MXNetError("executor missing argument %r"
                                     % node.name)
                t = args[node.name]
                if sharded and shards.get(node.name):
                    t, lay = _enter_sharded(node.name, t, shards[node.name],
                                            opctx)
                    lays[(id(node), 0)] = lay
                if rows and node.name in rows:
                    from .parallel.mesh import Layout
                    rlays[(id(node), 0)] = Layout.shard(rows[node.name],
                                                        "dp")
                vals[(id(node), 0)] = t
                continue
            ins = [vals[(id(i), x)] for (i, x) in node.inputs]
            aux_names = _node_aux_names(node)
            aux_in = [aux[a] for a in aux_names]
            dev = self.node_device.get(id(node))
            if dev is not None:
                ins = [t if t.device == dev else t.to(dev) for t in ins]
                aux_in = [t if t.device == dev else t.to(dev)
                          for t in aux_in]
            out_lays = None
            in_rows = [rlays.get((id(i), x)) for (i, x) in node.inputs] \
                if rows else []
            opctx.in_rows = in_rows
            if sharded:
                from .parallel.mesh import gather_tensor
                cut = [shards.get(a) for a in aux_names]
                aux_in = [gather_tensor(t.detach(), c, opctx.mesh) if c
                          else t for t, c in zip(aux_in, cut)]
                outs, out_lays = node.op.forward_layout(
                    node.params, ins,
                    [lays.get((id(i), x)) for (i, x) in node.inputs],
                    aux_in, opctx)
            else:
                outs = node.op.forward(node.params, ins, aux_in, opctx)
            if isinstance(outs, tuple):
                outs, aux_out = outs
                if sharded:
                    from .parallel.mesh import shard_tensor
                    aux_out = [shard_tensor(t, shards.get(a), opctx.mesh)
                               if shards.get(a) else t
                               for a, t in zip(aux_names, aux_out)]
                new_aux.update(zip(aux_names, aux_out))
            opctx.in_rows = ()
            for i, o in enumerate(outs):
                vals[(id(node), i)] = o
                if out_lays is not None and out_lays[i] is not None:
                    lays[(id(node), i)] = out_lays[i]
            if any(in_rows):
                for i, lay in enumerate(_rows_out(node, ins, in_rows, outs)):
                    if lay is not None:
                        rlays[(id(node), i)] = lay
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
                    lays.pop(key, None)
                    rlays.pop(key, None)
        heads = [vals[(id(n), i)] for (n, i) in self.symbol._heads]
        if sharded:
            from .ops.registry import to_replicated
            heads = [to_replicated(t, lays.get((id(n), i)), opctx, "output")
                     for t, (n, i) in zip(heads, self.symbol._heads)]
        return heads, new_aux


def _rows_out(node: _Node, ins, in_rows, outs) -> list:
    """The row layouts of a node's outputs: the first input holding a
    batch's rows names the dim; an output whose ``row_dim`` of it has the
    same size holds the rows there."""
    from .parallel.mesh import Layout
    i = next(k for k, lay in enumerate(in_rows) if lay is not None)
    d, n = in_rows[i].dim, ins[i].shape[in_rows[i].dim]
    out = []
    for o in outs:
        od = node.op.row_dim(node.params, d, o.dim()) \
            if isinstance(o, torch.Tensor) else None
        out.append(Layout.shard(od, "dp")
                   if od is not None and od < o.dim() and o.shape[od] == n
                   else None)
    return out


def _enter_sharded(name: str, t: torch.Tensor, pairs, opctx: OpContext):
    """A sharded argument as the walk takes it: -> (tensor, layout)."""
    from .parallel import collectives as C
    from .parallel.mesh import Layout
    if len(pairs) == 1 and pairs[0][1] != "dp":
        return t, Layout.shard(*pairs[0])
    for d, a in reversed(list(pairs)):
        ax = opctx.axis(a)
        C.note_redistribution("param:" + name, "all_gather")
        t = C.gather_param(t, ax, d) if a == "dp" \
            else C.all_gather(t, ax, d)
    return t, None


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
        # set_mesh: the mesh, {name: cuts} of the sharded arrays, and the
        # dp axis of the batch inputs cut over it
        self._mesh = None
        self._cuts: Dict[str, list] = {}
        self._batch_dp = None
        self._batch_inputs: List[str] = []

    # -- mesh placement -------------------------------------------------------
    def set_mesh(self, mesh, param_specs=None, input_specs=None) -> None:
        """Place the bound arrays on ``mesh`` (a ``parallel.Mesh``, an axes
        list or ``"tp=2"``): each argument or aux state in
        ``param_specs`` is cut to this rank's shard, in place of the whole
        (an array another executor already cut, a shared parameter, stays
        as it is); an input whose ``input_specs`` entry cuts dim 0 over
        ``dp`` feeds this rank's rows.  Inference-only."""
        from .parallel.mesh import (Mesh, make_mesh, normalize_spec,
                                    shard_tensor, spec_pairs, validate_spec)
        if self._grad_names:
            raise MXNetError(
                "Executor.set_mesh is inference-only (grad_req='null'); "
                "multichip training goes through Module.fit(mesh=...)")
        if mesh is not None and not isinstance(mesh, Mesh):
            mesh = make_mesh(mesh)
        specs = {n: normalize_spec(sp) for n, sp in
                 (param_specs or {}).items()}
        inputs = {n: normalize_spec(sp) for n, sp in
                  (input_specs or {}).items()}
        known = set(self.arg_dict) | set(self.aux_dict)
        unknown = sorted((set(specs) | set(inputs)) - known)
        if unknown:
            raise MXNetError(
                "set_mesh specs name no bound array: %s (have: %s)"
                % (unknown, sorted(known)))
        self._mesh = mesh
        self._cuts = {}
        self._batch_dp = None
        self._batch_inputs = []
        for n, sp in inputs.items():
            validate_spec(n, sp, mesh, shape=self.arg_dict[n].shape)
            if tuple(sp)[:1] == ("dp",) and int(mesh.shape["dp"]) > 1:
                self._batch_dp = mesh.axis("dp")
                self._batch_inputs.append(n)
        arrays = dict(self.arg_dict)
        arrays.update(self.aux_dict)
        for n, sp in specs.items():
            nd = arrays[n]
            cuts = spec_pairs(sp, nd.ndim)
            if not cuts:
                continue
            self._cuts[n] = cuts
            if nd._shard is not None and nd._shard[0] == mesh \
                    and nd._shard[1] == cuts:
                continue
            validate_spec(n, sp, mesh, shape=nd.shape)
            whole = tuple(nd.shape)
            nd._data = shard_tensor(nd._get(), cuts, mesh)
            nd._shard = (mesh, cuts, whole)

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
                         generator=_random.generator(self._ctx),
                         dp=self._batch_dp,
                         mesh=self._mesh if self._cuts else None)

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
                outs = self._mesh_forward(args, aux) \
                    if self._mesh is not None else \
                    self._prog.eval(args, aux, self._opctx(False))[0]
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

    def _mesh_forward(self, args, aux):
        """An inference forward under ``set_mesh``: the batch inputs cut
        over ``dp`` run this rank's rows, and outputs of that many rows
        come back gathered."""
        ax = self._batch_dp
        local = None
        if ax is not None:
            local = args[self._batch_inputs[0]].shape[0] // ax.size
            for n in self._batch_inputs:
                args[n] = args[n].narrow(0, ax.index * local, local)
        outs, _ = self._prog.eval(args, aux, self._opctx(False),
                                  shards=self._cuts)
        if local is not None:
            from .parallel.data_parallel import gather_outputs
            outs = gather_outputs(outs, ax, local)
        return outs

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
        """Write parameter values into the bound arrays, in place (a
        sharded array takes this rank's shard of the whole value)."""
        for name, arr in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = _local_value(self.arg_dict[name],
                                                      arr)
            elif not allow_extra_params:
                raise MXNetError("Found name %r not in executor arguments"
                                 % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = _local_value(self.aux_dict[name],
                                                      arr)
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


def _local_value(nd: NDArray, value):
    """``value`` for the array ``nd``: this rank's shard of it when ``nd``
    is a shard (``set_mesh``) and ``value`` the whole."""
    if nd._shard is None:
        return value
    mesh, cuts, whole = nd._shard
    t = value._get() if isinstance(value, NDArray) \
        else torch.as_tensor(np.asarray(value))
    if tuple(t.shape) != tuple(whole):
        return value
    from .parallel.mesh import shard_tensor
    return shard_tensor(t, cuts, mesh)


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
        got = pool.get(name) if shared_exec is not None else None
        # a shared array a mesh placement cut is shared by its whole shape
        if got is not None and tuple(shape) in (
                got.shape, got._shard and tuple(got._shard[2])):
            return got
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
