"""Pass verification: serialization round trips and attr preservation
(counterpart of ``mxnet_tpu/passes/verify.py``).

Two invariants every pass must uphold:

1. **Round trip** — the rewritten graph must survive
   ``Symbol.tojson`` -> ``load_json`` -> ``tojson`` byte-for-byte.  A
   pass that builds nodes the serializer cannot represent (params an op
   does not declare, inputs out of topo order, graph attrs lost) would
   otherwise ship a graph whose checkpointed form differs from its
   served form — the kind of skew that surfaces weeks later as a
   restore-time shape error.

2. **Attr preservation** — a node that survives a pass (same name on
   both sides) keeps every attr it had.  Attrs carry cross-layer
   contracts: ``__sharding__`` (sharding specs), ``ctx_group``,
   ``force_mirroring``, ``lr_mult``.  A pass that rebuilds a node and
   forgets to copy ``node.attrs`` silently un-shards a tensor-parallel
   serve — this check makes that a loud PassError instead.

Nodes a pass deliberately removes (folded, CSE'd, DCE'd) or inserts
(q/dq, casts) are exempt — only NAME-SURVIVING nodes are compared.
"""
from __future__ import annotations

from typing import List

from ..symbol import Symbol, _topo, load_json
from .pipeline import PassError

__all__ = ["verify_roundtrip", "check_attrs_preserved", "diff_attrs"]


def verify_roundtrip(sym: Symbol, label: str = "") -> Symbol:
    """tojson -> load_json -> tojson must be byte-identical.  Returns the
    reloaded symbol (callers may keep using it).  Raises PassError with
    the first differing line on mismatch."""
    j1 = sym.tojson()
    try:
        reloaded = load_json(j1)
    except Exception as e:
        raise PassError(
            "round-trip parse failed %s: %s: %s — the graph serializes "
            "to json its own loader rejects"
            % (label, type(e).__name__, e)) from e
    j2 = reloaded.tojson()
    if j1 != j2:
        l1, l2 = j1.splitlines(), j2.splitlines()
        diff = next((i for i, (a, b) in enumerate(zip(l1, l2)) if a != b),
                    min(len(l1), len(l2)))
        a = l1[diff] if diff < len(l1) else "<eof>"
        b = l2[diff] if diff < len(l2) else "<eof>"
        raise PassError(
            "round-trip mismatch %s at json line %d: %r != %r (graph "
            "drops state its serialization cannot carry)"
            % (label, diff + 1, a.strip(), b.strip()))
    return reloaded


def diff_attrs(before: Symbol, after: Symbol) -> List[str]:
    """Attr regressions for nodes present (by name) in BOTH graphs:
    ``["node.key: 'old' -> missing", ...]``.  New attrs and new/removed
    nodes are not regressions.  Also checks graph-level attrs (minus the
    pipeline's own ``__passes__`` stamp)."""
    problems = []
    after_nodes = {n.name: n for n in _topo(after._heads)}
    for node in _topo(before._heads):
        other = after_nodes.get(node.name)
        if other is None:
            continue
        for k, v in node.attrs.items():
            if k not in other.attrs:
                problems.append("%s.%s: %r -> missing" % (node.name, k, v))
            elif other.attrs[k] != v:
                problems.append("%s.%s: %r -> %r"
                                % (node.name, k, v, other.attrs[k]))
    for k, v in before._graph_attrs.items():
        if k == "__passes__":
            continue
        if after._graph_attrs.get(k) != v:
            problems.append("<graph>.%s: %r -> %r"
                            % (k, v, after._graph_attrs.get(k)))
    return problems


def check_attrs_preserved(before: Symbol, after: Symbol,
                          pass_name: str = "?") -> None:
    """Fail loud when a pass drops or rewrites attrs on surviving nodes
    (e.g. ``__sharding__`` must outlive every pass)."""
    problems = diff_attrs(before, after)
    if problems:
        raise PassError(
            "pass %r dropped/changed node attrs (attrs carry cross-layer "
            "contracts like __sharding__ and must survive every pass): %s"
            % (pass_name, "; ".join(problems[:8])
               + (" ... +%d more" % (len(problems) - 8)
                  if len(problems) > 8 else "")))
