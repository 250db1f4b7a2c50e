"""SparseEmbedPass: deduped embedding lookups on the serving graph
(counterpart of ``mxnet_tpu/passes/embed.py``).

Rewrites every ``Embedding`` node into ``_sparse_embedding``: a request
batch's ids are deduped and each distinct row gathered once, and ids out
of range (a padded id list's sentinel) read zero vectors where
``Embedding`` would not.  In-range ids give the same output.  Off by
default; ``MXNET_EMBED_DEDUP=1`` or ``ServeEngine(embed_dedup=True)``
turns it on.
"""
from __future__ import annotations

from typing import Optional

from ..base import get_env
from .graph_passes import _make_node, rebuild
from .pipeline import Pass

__all__ = ["SparseEmbedPass", "default_embed_dedup"]


def default_embed_dedup() -> bool:
    """The ``MXNET_EMBED_DEDUP`` default for serving pipelines."""
    return get_env("MXNET_EMBED_DEDUP", False, bool)


class SparseEmbedPass(Pass):
    """Embedding -> _sparse_embedding on every node.  ``unique_cap``
    bounds each lookup's unique buffer (0: the id batch size, always
    safe; ``MXNET_EMBED_UNIQUE_CAP`` when None)."""

    name = "sparse_embed"
    order_after = ("quantize",)

    def __init__(self, unique_cap: Optional[int] = None):
        super().__init__()
        if unique_cap is None:
            unique_cap = get_env("MXNET_EMBED_UNIQUE_CAP", 0, int)
        self.unique_cap = int(unique_cap or 0)

    def config(self) -> str:
        return "unique_cap=%d" % self.unique_cap

    def apply(self, sym, params):
        rewritten = []

        def transform(node, new_inputs):
            if node.is_variable or \
                    getattr(node.op, "name", "") != "Embedding":
                return None
            new = _make_node(
                "_sparse_embedding", node.name,
                {"input_dim": node.params.input_dim,
                 "output_dim": node.params.output_dim,
                 "unique_cap": self.unique_cap},
                new_inputs, attrs=node.attrs)
            rewritten.append(node.name)
            return [(new, 0)]

        out = rebuild(sym, transform)
        self.summary = {"rewritten": len(rewritten), "nodes": rewritten}
        return (out if rewritten else sym), params
