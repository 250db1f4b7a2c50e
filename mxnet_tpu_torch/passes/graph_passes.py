"""Structural passes: constant folding, CSE, dead-node elimination and
the uint8 wire prologue (counterpart of
``mxnet_tpu/passes/graph_passes.py``).

All of them are built on one primitive — ``rebuild(sym, transform)`` — a
single topo walk that clones the reachable graph while a hook substitutes
per-node rewrites.  Every clone copies ``node.attrs`` verbatim, which is
what makes the pipeline's attr-preservation check (``__sharding__`` must
survive) hold by construction.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..base import _AttrDict
from ..ops import get_op
from ..symbol import Symbol, _Node, _topo
from .pipeline import Pass, PassError, _as_np

__all__ = ["rebuild", "tensor_name", "FoldConstantsPass", "CSEPass",
           "DeadNodeEliminationPass", "U8WirePass"]


def tensor_name(node: _Node, idx: int) -> str:
    """The name of one node output: the formula ``Symbol.list_outputs``
    uses, so calibration tables (keyed by
    ``get_internals().list_outputs()``) and the quantize pass agree."""
    if node.is_variable:
        return node.name
    names = node.op.list_outputs(node.params)
    return "%s_%s" % (node.name, names[idx])


def rebuild(sym: Symbol,
            transform: Callable[[_Node, List[Tuple[_Node, int]]],
                                Optional[List[Tuple[_Node, int]]]]) -> Symbol:
    """Clone the reachable graph.  ``transform(old_node, new_inputs)``
    returns a replacement ``[(node, out_idx), ...]`` (one entry per old
    output) or None for a plain clone.  The input graph is untouched."""
    out_map: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
    for node in _topo(sym._heads):
        new_inputs = [out_map[(id(i), x)] for (i, x) in node.inputs]
        res = transform(node, new_inputs)
        if res is None:
            new = _Node(node.op, node.name, _AttrDict(node.params),
                        dict(node.attrs), new_inputs, node.is_aux)
            res = [(new, i) for i in range(node.num_outputs())]
        for i, t in enumerate(res):
            out_map[(id(node), i)] = t
    heads = [out_map[(id(n), i)] for (n, i) in sym._heads]
    return Symbol(heads, graph_attrs=sym._graph_attrs)


def _make_node(op_name: str, name: str, params: Dict[str, Any],
               inputs, attrs=None) -> _Node:
    op = get_op(op_name)
    return _Node(op, name, op.parse_params(params), dict(attrs or {}),
                 list(inputs))


# -- constant folding --------------------------------------------------------

# scalar peepholes: (outer, inner) -> combined scalar, same outer op
_SCALAR_CHAINS = {
    ("_mul_scalar", "_mul_scalar"): lambda a, b: a * b,
    ("_div_scalar", "_div_scalar"): lambda a, b: a * b,   # /a/b == /(a*b)
    ("_plus_scalar", "_plus_scalar"): lambda a, b: a + b,
    ("_minus_scalar", "_minus_scalar"): lambda a, b: a + b,
}
# identities: op applied with this scalar is a no-op
_SCALAR_IDENTITY = {"_mul_scalar": 1.0, "_div_scalar": 1.0,
                    "_plus_scalar": 0.0, "_minus_scalar": 0.0}


class FoldConstantsPass(Pass):
    """Constant folding, two legs:

    * **scalar chains** — back-to-back scalar arithmetic collapses
      (``x*a*b`` -> ``x*(a*b)``) and identity scalars (``*1``, ``+0``)
      disappear.  Normalization prologues (mean/scale) reliably produce
      these.
    * **param subgraphs** — with ``params`` available (the deployment
      path always has them), any node whose inputs are ALL parameter
      variables is evaluated host-side ONCE and replaced by a new baked
      parameter (``<node>_folded``).  The reference analogue of Relay's
      FoldConstant: the serve program never recomputes weight-only math
      per request.  RNG ops and aux-carrying ops (BatchNorm) are never
      folded; variables that receive gradients do not exist here (the
      pipeline is inference-side).

    ``transform_params`` re-folds from fresh weights on hot reload.
    """

    name = "fold_constants"

    def __init__(self, fold_params: bool = True, fold_scalars: bool = True):
        super().__init__()
        self.fold_params = fold_params
        self.fold_scalars = fold_scalars
        # [(folded var name, [input var names], node clone)] — replayed
        # against fresh params on reload
        self._folds: List[Tuple[str, List[str], _Node]] = []

    def config(self) -> str:
        return "fold_params=%s;fold_scalars=%s" % (self.fold_params,
                                                   self.fold_scalars)

    def _eval_node(self, node: _Node, params: Dict) -> np.ndarray:
        import torch
        from ..ops.registry import OpContext
        ins = [torch.from_numpy(np.array(_as_np(params[i.name])))
               for (i, _) in node.inputs]
        with torch.inference_mode():
            outs = node.op.forward(node.params, ins, [],
                                   OpContext(is_train=False))
        return outs[0].numpy()

    def apply(self, sym, params):
        folded = scalars = 0
        self._folds = []
        new_params = dict(params) if params is not None else None
        param_names = set(new_params or ())
        consumers: Dict[int, int] = {}
        for n in _topo(sym._heads):
            for (i, _x) in n.inputs:
                consumers[id(i)] = consumers.get(id(i), 0) + 1
        head_ids = {id(n) for (n, _i) in sym._heads}
        folded_names: List[str] = []

        def transform(node, new_inputs):
            nonlocal folded, scalars
            if node.is_variable:
                return None
            opn = node.op.name
            # scalar identity: drop the node entirely
            if self.fold_scalars and opn in _SCALAR_IDENTITY and \
                    float(node.params.get("scalar")) == _SCALAR_IDENTITY[opn]:
                scalars += 1
                return [new_inputs[0]]
            # scalar chain: this node's (already rewritten) input is the
            # same-family scalar op — merge into one
            if self.fold_scalars and new_inputs and not node.is_variable:
                src, src_idx = new_inputs[0]
                key = (opn, None if src.is_variable else src.op.name)
                comb = _SCALAR_CHAINS.get((opn, key[1]))
                if comb is not None and src_idx == 0:
                    a = float(node.params.get("scalar"))
                    b = float(src.params.get("scalar"))
                    scalars += 1
                    merged = _make_node(opn, node.name,
                                        {"scalar": comb(b, a)},
                                        src.inputs, node.attrs)
                    return [(merged, 0)]
            # param-subgraph folding
            if (self.fold_params and new_params is not None
                    and node.inputs
                    and not node.op.needs_rng
                    and not node.op.list_auxiliary_states(node.params)
                    and id(node) not in head_ids
                    and all(i.is_variable and i.name in param_names
                            for (i, _x) in node.inputs)
                    and node.num_outputs() == 1):
                clone = _Node(node.op, node.name, _AttrDict(node.params),
                              dict(node.attrs),
                              [(i, x) for (i, x) in node.inputs])
                try:
                    value = self._eval_node(clone, new_params)
                except Exception:
                    return None       # not host-evaluable: leave in graph
                vname = "%s_folded" % node.name
                new_params[vname] = value
                self._folds.append(
                    (vname, [i.name for (i, _x) in node.inputs], clone))
                folded += 1
                folded_names.append(node.name)
                var = _Node(None, vname, attrs=dict(node.attrs))
                return [(var, 0)]
            return None

        out = rebuild(sym, transform)
        self.summary = {"rewrites": folded + scalars,
                        "params_folded": folded, "scalar_folds": scalars,
                        "folded_nodes": folded_names}
        return out, new_params

    def transform_params(self, params):
        out = dict(params)
        for vname, in_names, node in self._folds:
            if all(n in out for n in in_names):
                out[vname] = self._eval_node(node, out)
        return out


# -- common-subexpression elimination ---------------------------------------

class CSEPass(Pass):
    """Hash-cons the graph bottom-up: two nodes with the same op, params,
    attrs and (already-canonicalized) inputs are one node.  Variables
    unify by name.  The quantize pass leans on this indirectly: duplicate
    ``_contrib_quantize`` nodes for one tensor+scale merge here when the
    pipeline runs CSE after quantization (the default serving pipeline
    dedupes them at insertion anyway)."""

    name = "cse"

    def apply(self, sym, params):
        seen: Dict[Tuple, _Node] = {}
        merged = 0
        merged_names: List[str] = []

        def transform(node, new_inputs):
            nonlocal merged
            if node.is_variable:
                key = ("var", node.name, node.is_aux,
                       tuple(sorted(node.attrs.items())))
            else:
                key = (node.op.name,
                       tuple(sorted((k, repr(v))
                                    for k, v in node.params.items())),
                       tuple(sorted(node.attrs.items())),
                       tuple((id(n), i) for (n, i) in new_inputs))
            rep = seen.get(key)
            if rep is not None:
                merged += 1
                merged_names.append(node.name)
                return [(rep, i) for i in range(node.num_outputs())]
            if node.is_variable:
                new = _Node(None, node.name, attrs=dict(node.attrs),
                            is_aux=node.is_aux)
            else:
                new = _Node(node.op, node.name, _AttrDict(node.params),
                            dict(node.attrs), new_inputs, node.is_aux)
            seen[key] = new
            return [(new, i) for i in range(node.num_outputs())]

        out = rebuild(sym, transform)
        self.summary = {"rewrites": merged, "merged_nodes": merged_names}
        return out, params


# -- dead-node elimination ---------------------------------------------------

# ops that are the identity at inference time: bypassing them changes
# nothing the serve program computes (Dropout's eval path IS the
# identity; BlockGrad only matters to autodiff)
_INFERENCE_IDENTITY = ("Dropout", "BlockGrad")


class DeadNodeEliminationPass(Pass):
    """Remove nodes that contribute nothing to the heads.

    Unreachable nodes never survive a ``rebuild`` walk by construction;
    the measurable work here is bypassing single-input single-output ops
    that are the identity for the compiled program: inference-mode
    ``Dropout`` / ``BlockGrad`` (``for_inference=True`` — the serving
    pipeline's default) — after which anything they alone kept alive is
    unreachable and falls off.  Multi-output nodes and heads are never
    touched."""

    name = "dce"

    def __init__(self, for_inference: bool = True):
        super().__init__()
        self.for_inference = for_inference

    def config(self) -> str:
        return "for_inference=%s" % self.for_inference

    def apply(self, sym, params):
        removed = 0
        removed_names: List[str] = []
        head_ids = {id(n) for (n, _i) in sym._heads}

        def transform(node, new_inputs):
            nonlocal removed
            if (self.for_inference and not node.is_variable
                    and node.op.name in _INFERENCE_IDENTITY
                    and node.num_outputs() == 1
                    and len(node.inputs) == 1
                    and id(node) not in head_ids):
                removed += 1
                removed_names.append(node.name)
                return [new_inputs[0]]
            return None

        out = rebuild(sym, transform)
        self.summary = {"rewrites": removed, "removed_nodes": removed_names}
        return out, params


# -- uint8 wire prologue -----------------------------------------------------

class U8WirePass(Pass):
    """Move the cast/normalize prologue into the graph so the wire stays
    uint8.

    The data variable is retyped to uint8 (the ``__dtype__`` attr, and
    ``type_overrides`` in the summary, which the Predictor binds) and,
    for images, laid out HWC; the graph itself casts to float32,
    subtracts ``mean``, multiplies by ``scale`` and, with ``hwc=True``,
    transposes to NCHW before the first real op.  A request ships
    H*W*C bytes instead of four times that.  ``hwc=False`` keeps the
    layout (MLP inputs)."""

    name = "u8_wire"

    def __init__(self, data_name: str = "data", mean: float = 0.0,
                 scale: float = 1.0, hwc: bool = True):
        super().__init__()
        self.data_name = data_name
        self.mean = float(mean)
        self.scale = float(scale)
        self.hwc = hwc

    def config(self) -> str:
        return "data=%s;mean=%r;scale=%r;hwc=%s" % (
            self.data_name, self.mean, self.scale, self.hwc)

    def apply(self, sym, params):
        if self.data_name not in sym.list_arguments():
            raise PassError("u8_wire: input %r is not an argument of the "
                            "graph (has %s)"
                            % (self.data_name, sym.list_arguments()))
        built: Dict[str, Tuple[_Node, int]] = {}

        def prologue(var: _Node) -> Tuple[_Node, int]:
            # one prologue per data variable name
            if var.name in built:
                return built[var.name]
            attrs = dict(var.attrs)
            attrs["__dtype__"] = "uint8"
            u8var = _Node(None, var.name, attrs=attrs)
            cur: Tuple[_Node, int] = (
                _make_node("Cast", "%s_u8cast" % var.name,
                           {"dtype": "float32"}, [(u8var, 0)]), 0)
            if self.mean != 0.0:
                cur = (_make_node("_minus_scalar", "%s_u8mean" % var.name,
                                  {"scalar": self.mean}, [cur]), 0)
            if self.scale != 1.0:
                cur = (_make_node("_mul_scalar", "%s_u8scale" % var.name,
                                  {"scalar": self.scale}, [cur]), 0)
            if self.hwc:
                cur = (_make_node("transpose", "%s_u8nchw" % var.name,
                                  {"axes": (0, 3, 1, 2)}, [cur]), 0)
            built[var.name] = cur
            return cur

        def transform(node, new_inputs):
            if node.is_variable:
                return None
            rewired = [prologue(i) if i.is_variable
                       and i.name == self.data_name else i_new
                       for (i, _x), i_new in zip(node.inputs, new_inputs)]
            if rewired == new_inputs:
                return None
            new = _Node(node.op, node.name, _AttrDict(node.params),
                        dict(node.attrs), rewired, node.is_aux)
            return [(new, i) for i in range(node.num_outputs())]

        out = rebuild(sym, transform)
        self.summary = {"rewrites": len(built),
                        "type_overrides": {self.data_name: "uint8"},
                        "prologue_inputs": sorted(built)}
        return out, params
