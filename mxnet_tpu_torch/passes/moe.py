"""MoEServeParityPass (counterpart of ``mxnet_tpu/passes/moe.py``).

In the JAX package this pass pins every ``_moe_dispatch`` node of a
serving graph to ``capacity_factor=0`` (no token dropping).  The port has
no ``_moe_dispatch`` op yet, so no graph it can load carries one and the
pass is the identity; it stands in the serving pipeline so that the pass
list, and with it the ``__passes__`` fingerprint, equals the JAX
package's.  The rewrite comes with the MoE slice.
"""
from __future__ import annotations

from .pipeline import Pass

__all__ = ["MoEServeParityPass"]


class MoEServeParityPass(Pass):
    name = "moe_serve_parity"
    order_after = ("quantize",)

    def apply(self, sym, params):
        self.summary = {"rewritten": 0, "nodes": []}
        return sym, params
