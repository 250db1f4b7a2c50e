"""Operator fusion passes: epilogue fusion and elementwise-chain fusion
(counterpart of ``mxnet_tpu/passes/fuse.py``).

**FuseEpiloguePass** rewrites ``FullyConnected``/``Convolution`` followed
by ``Activation`` into one ``_fused_*`` op (``ops/fused.py``) carrying the
producer's params plus ``act_type``; a downstream ``_contrib_quantize``
would be absorbed as ``out_scale``.  A producer is fused only when the
epilogue is its sole consumer and it is not itself a graph output; the
fused node takes the epilogue node's name, so ``list_outputs()`` is
unchanged.  The int8 producers (``_quantized_*``) fuse the same way into
``_fused_quantized_*``.

**ElementwiseFusePass** collapses maximal chains of single-input
elementwise ops into one ``_fused_elemwise`` node carrying the serialized
step list; the chain keeps the last node's name.

Both passes declare ``order_after = ("quantize",)`` as in the JAX
package, so pipelines and their fingerprints are the same.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..ops.fused import ACT_FNS, ELEMWISE_STEP_OPS, format_steps
from ..symbol import Symbol, _Node, _topo
from .graph_passes import _make_node, rebuild
from .pipeline import Pass, PassError

__all__ = ["FuseEpiloguePass", "ElementwiseFusePass", "fusion_passes"]

# producer op -> fused op, per family
_FUSABLE = {
    "FullyConnected": {
        "FullyConnected": "_fused_FullyConnected",
        "_quantized_FullyConnected": "_fused_quantized_FullyConnected",
    },
    "Convolution": {
        "Convolution": "_fused_Convolution",
        "_quantized_Convolution": "_fused_quantized_Convolution",
    },
}


def _consumer_counts(sym: Symbol) -> Dict[int, int]:
    counts: Dict[int, int] = {}
    for n in _topo(sym._heads):
        for (i, _x) in n.inputs:
            counts[id(i)] = counts.get(id(i), 0) + 1
    return counts


class FuseEpiloguePass(Pass):
    """Fuse matmul/conv + Activation (+ ``_contrib_quantize``) epilogues
    into single ``_fused_*`` ops — see the module docstring.

    Parameters
    ----------
    families : sequence of "FullyConnected" / "Convolution"
        Which producer families to fuse (both their f32 and int8 forms).
    quantize_epilogue : bool
        Also absorb a downstream ``_contrib_quantize`` into the fused
        op (``out_scale``), emitting int8 straight from the epilogue.
    """

    name = "fuse_epilogue"
    # quantize rewrites only UNFUSED FullyConnected/Convolution nodes:
    # fusing first would silently defeat int8 epilogue fusion
    order_after = ("quantize",)

    def __init__(self, families: Sequence[str] = ("FullyConnected",
                                                  "Convolution"),
                 quantize_epilogue: bool = True):
        super().__init__()
        unknown = sorted(set(families) - set(_FUSABLE))
        if unknown:
            raise PassError("fuse_epilogue: unknown families %s (have %s)"
                            % (unknown, sorted(_FUSABLE)))
        self.families = tuple(families)
        self.quantize_epilogue = bool(quantize_epilogue)
        self._eligible = {}
        for fam in self.families:
            self._eligible.update(_FUSABLE[fam])

    def config(self) -> str:
        return "families=%s;quantize_epilogue=%s" % (
            ",".join(self.families), self.quantize_epilogue)

    def apply(self, sym, params):
        consumers = _consumer_counts(sym)
        head_ids = {id(n) for (n, _i) in sym._heads}
        fused_ids = set()        # ids of fused nodes built THIS run
        act_fused: List[str] = []
        q_absorbed: List[str] = []

        def transform(node, new_inputs):
            if node.is_variable:
                return None
            opn = node.op.name
            # Activation over an eligible single-consumer producer
            if opn == "Activation" and node.inputs:
                src, src_idx = node.inputs[0]
                if (not src.is_variable and src_idx == 0
                        and src.op.name in self._eligible
                        and consumers.get(id(src)) == 1
                        and id(src) not in head_ids
                        and node.params.get("act_type") in ACT_FNS):
                    prod = new_inputs[0][0]
                    p = dict(src.op.serialize_params(src.params))
                    p["act_type"] = node.params["act_type"]
                    attrs = dict(src.attrs)
                    attrs.update(node.attrs)
                    fused = _make_node(self._eligible[src.op.name],
                                       node.name, p, list(prod.inputs),
                                       attrs)
                    fused_ids.add(id(fused))
                    act_fused.append(node.name)
                    return [(fused, 0)]
            # _contrib_quantize over a just-fused single-consumer node:
            # absorb as the int8 out_scale epilogue
            if (self.quantize_epilogue and opn == "_contrib_quantize"
                    and node.inputs):
                src, _src_idx = node.inputs[0]
                prod, pidx = new_inputs[0]
                if (id(prod) in fused_ids and pidx == 0
                        and consumers.get(id(src)) == 1
                        and id(src) not in head_ids
                        and prod.params.get("out_scale") is None):
                    p = dict(prod.op.serialize_params(prod.params))
                    p["out_scale"] = node.params["scale"]
                    attrs = dict(prod.attrs)
                    attrs.update(node.attrs)
                    fused = _make_node(prod.op.name, node.name, p,
                                       list(prod.inputs), attrs)
                    fused_ids.add(id(fused))
                    q_absorbed.append(node.name)
                    return [(fused, 0)]
            return None

        out = rebuild(sym, transform)
        self.summary = {"rewrites": len(act_fused) + len(q_absorbed),
                        "act_fused": act_fused,
                        "quantize_absorbed": q_absorbed}
        return out, params


class ElementwiseFusePass(Pass):
    """Collapse maximal chains of eligible single-input elementwise ops
    into one ``_fused_elemwise`` node (see the module docstring).
    ``min_len`` (default 2) is the shortest chain worth a rewrite."""

    name = "elemwise_fuse"
    # after quantize (chains around q/dq must not swallow the Activation
    # nodes epilogue fusion targets) and after fuse_epilogue itself
    order_after = ("quantize", "fuse_epilogue")

    def __init__(self, min_len: int = 2):
        super().__init__()
        self.min_len = max(2, int(min_len))

    def config(self) -> str:
        return "min_len=%d" % self.min_len

    @staticmethod
    def _step_of(node: _Node) -> Optional[Tuple[str, Optional[float]]]:
        if node.is_variable or len(node.inputs) != 1 \
                or node.num_outputs() != 1 or node.op.needs_rng:
            return None
        opn = node.op.name
        if opn == "Activation":
            act = node.params.get("act_type")
            return (act, None) if act in ELEMWISE_STEP_OPS else None
        if opn in ELEMWISE_STEP_OPS:
            if ELEMWISE_STEP_OPS[opn][0]:
                return (opn, float(node.params.get("scalar")))
            return (opn, None)
        # unary ops register under both "abs" and "_abs"
        alt = opn[1:] if opn.startswith("_") else None
        if alt in ELEMWISE_STEP_OPS and not ELEMWISE_STEP_OPS[alt][0]:
            return (alt, None)
        return None

    def apply(self, sym, params):
        consumers = _consumer_counts(sym)
        head_ids = {id(n) for (n, _i) in sym._heads}
        # grow chains along sole-consumer links; a popped prefix can no
        # longer end a chain, so only maximal chains survive
        chains: Dict[int, List[_Node]] = {}
        for node in _topo(sym._heads):
            if self._step_of(node) is None:
                continue
            prev = node.inputs[0][0]
            if (id(prev) in chains and consumers.get(id(prev)) == 1
                    and id(prev) not in head_ids):
                chains[id(node)] = chains.pop(id(prev)) + [node]
            else:
                chains[id(node)] = [node]
        final = {nid: c for nid, c in chains.items()
                 if len(c) >= self.min_len}
        fused_names: List[str] = []
        steps_fused = 0

        def transform(node, new_inputs):
            nonlocal steps_fused
            chain = final.get(id(node))
            if chain is None:
                return None
            steps = format_steps([self._step_of(n) for n in chain])
            # the chain's input: walk the already-cloned interior back
            # to the first chain node's (cloned) input
            cur = new_inputs[0]
            for _ in range(len(chain) - 1):
                cur = cur[0].inputs[0]
            attrs: Dict[str, str] = {}
            for n in chain:
                attrs.update(n.attrs)
            fused = _make_node("_fused_elemwise", node.name,
                               {"steps": steps}, [cur], attrs)
            fused_names.append(node.name)
            steps_fused += len(chain)
            return [(fused, 0)]

        out = rebuild(sym, transform)
        self.summary = {"rewrites": len(fused_names),
                        "chains_fused": fused_names,
                        "steps_fused": steps_fused}
        return out, params


def fusion_passes(fuse) -> List[Pass]:
    """Resolve a pipeline builder's ``fuse`` argument into the fusion
    pass list: falsy -> none; True -> both passes with defaults; a dict
    -> FuseEpiloguePass kwargs plus ``elemwise`` (bool/int min_len) for
    the chain fuser."""
    if not fuse:
        return []
    kw = dict(fuse) if isinstance(fuse, dict) else {}
    elem = kw.pop("elemwise", True)
    out: List[Pass] = [FuseEpiloguePass(**kw)]
    if elem:
        out.append(ElementwiseFusePass(
            min_len=elem if isinstance(elem, int) and elem is not True
            else 2))
    return out
