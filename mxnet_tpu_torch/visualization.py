"""Network visualization: the counterpart of ``mxnet_tpu/visualization.py``
(reference python/mxnet/visualization.py).  ``print_summary`` prints the
JAX package's table, character for character, for the same symbol and
shapes; ``plot_network`` builds the same ``graphviz`` source, and raises
the same message where ``graphviz`` is not installed."""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from .base import MXNetError
from .symbol import Symbol

__all__ = ["plot_network", "print_summary"]


def print_summary(symbol: Symbol, shape: Optional[Dict] = None):
    """Print layer summary table with output shapes and parameter counts
    (reference visualization.py print_summary)."""
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    out_shape_by_name = {}
    arg_shape_by_name = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape(**shape)
        for name, s in zip(internals.list_outputs(), out_shapes):
            out_shape_by_name[name] = tuple(s)
        arg_shapes, _, _ = symbol.infer_shape(**shape)
        for name, s in zip(symbol.list_arguments(), arg_shapes):
            arg_shape_by_name[name] = tuple(s)
    print("%-28s %-18s %-20s %-10s" % ("Layer (type)", "Op", "Output Shape",
                                       "Params"))
    print("=" * 80)
    total = 0
    data_names = set(shape.keys()) if shape else {"data"}
    for node in nodes:
        if node["op"] == "null":
            continue
        # parameters = this op's null inputs that aren't data/labels
        n_params = 0
        for (j, _) in node["inputs"]:
            src = nodes[j]
            if src["op"] == "null" and src["name"] not in data_names:
                s = arg_shape_by_name.get(src["name"])
                if s:
                    n_params += int(np.prod(s))
        total += n_params
        out_s = (out_shape_by_name.get(node["name"] + "_output")
                 or out_shape_by_name.get(node["name"] + "_out") or "")
        print("%-28s %-18s %-20s %-10d" % (node["name"], node["op"],
                                           str(out_s), n_params))
    print("=" * 80)
    print("Total params: %d" % total)


def plot_network(symbol: Symbol, title="plot", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz plot (reference visualization.py plot_network)."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires graphviz; "
                         "use print_summary for a text view")
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    dot = Digraph(name=title)
    for i, node in enumerate(nodes):
        name = node["name"]
        if node["op"] == "null":
            if hide_weights and (name.endswith("weight") or name.endswith("bias")
                                 or name.endswith("gamma") or name.endswith("beta")):
                continue
            dot.node(name=name, label=name, shape="oval")
        else:
            dot.node(name=name, label="%s\n%s" % (name, node["op"]), shape="box")
    for node in nodes:
        if node["op"] == "null":
            continue
        for (j, _) in node["inputs"]:
            src = nodes[j]["name"]
            dot.edge(tail_name=src, head_name=node["name"])
    return dot
