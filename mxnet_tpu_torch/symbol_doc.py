"""Symbol docstring helpers (counterpart of ``mxnet_tpu/symbol_doc.py``):
the supplementary-documentation hook of the generated symbol
constructors and the output-shape helper of the doc examples."""
from __future__ import annotations

__all__ = ["SymbolDoc", "get_output_shape"]


class SymbolDoc(object):
    """Base for per-op documentation supplements (reference SymbolDoc).
    Subclass with the op name + 'Doc' and a docstring."""

    @staticmethod
    def get_output_shape(sym, **input_shapes):
        """Infer and return {output_name: shape}."""
        _, s_outputs, _ = sym.infer_shape(**input_shapes)
        return dict(zip(sym.list_outputs(), s_outputs))


def get_output_shape(sym, **input_shapes):
    return SymbolDoc.get_output_shape(sym, **input_shapes)

