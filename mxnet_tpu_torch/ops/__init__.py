"""Operator library: registry plus the ops the port carries so far.

Importing this package registers every op; the symbol layer generates
its constructors (``sym.FullyConnected`` ...) from the registry.
"""
from .registry import (OpDef, OpContext, Param, register_op,
                       register_simple_op, get_op, list_ops)
from . import tensor  # noqa: F401  (elementwise ... Reshape, Embedding)
from . import nn      # noqa: F401  (the layers, the output and loss ops)
from . import rnn     # noqa: F401  (RNN)
from . import quantized  # noqa: F401  (the int8 serving ops)
from . import fused   # noqa: F401  (the epilogue-fused serving ops)
from . import special  # noqa: F401  (ROIPooling, SpatialTransformer, Correlation)
from . import moe     # noqa: F401  (the three _moe_* ops)

__all__ = ["OpDef", "OpContext", "Param", "register_op", "register_simple_op",
           "get_op", "list_ops"]
