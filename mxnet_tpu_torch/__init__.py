"""mxnet_tpu_torch: the PyTorch and CUDA port of ``mxnet_tpu``.

The same user surface as the JAX package, on one NVIDIA H100:
``import mxnet_tpu_torch as mx``, then ``mx.nd``, ``mx.sym``,
``mx.predictor``, ``mx.serve``, ``mx.autotune``, and for training
``mx.mod``, ``mx.optimizer``, ``mx.init``, ``mx.metric``, ``mx.io``,
``mx.lr_scheduler``, ``mx.callback``, ``mx.random`` and ``mx.Monitor``.
Plain tensor code is PyTorch; the package's TPU kernels are hand-written Hopper kernels
(``ops/cuda_kernels.py``, sources in ``csrc/``).  Entry points run on
``gpu(0)`` unless the caller asks for ``cpu()``.

The port goes slice by slice (ROADMAP.md).  This package imports
``torch`` and never ``jax`` or ``mxnet_tpu``.
"""
from . import base
from .base import MXNetError
from .context import Context, cpu, cpu_pinned, current_context, gpu
from . import ndarray
from . import ndarray as nd
from . import ops
from .ops import nd_bridge as _nd_bridge
_nd_bridge.register_all()   # every aux-free op as mx.nd.<op>
from . import symbol
from . import symbol as sym
from .attribute import AttrScope
from .name import NameManager
from . import executor
from . import model
from . import predictor
from .predictor import Predictor, create_predictor
from . import passes
from . import serve
from . import models
from . import convert
from . import parallel
from . import autotune
from . import random
from . import random as rnd
from . import initializer
from . import initializer as init
from . import optimizer
from . import optimizer as opt
from . import lr_scheduler
from . import metric
from . import io
from . import callback
from . import module
from . import module as mod
from . import monitor
from .monitor import Monitor

__all__ = ["MXNetError", "Context", "cpu", "cpu_pinned", "gpu",
           "current_context", "nd", "ndarray", "sym", "symbol", "ops",
           "AttrScope", "NameManager", "executor", "model", "predictor",
           "Predictor", "create_predictor", "passes", "serve", "models",
           "convert", "parallel", "autotune", "random", "rnd",
           "initializer", "init", "optimizer", "opt", "lr_scheduler",
           "metric", "io", "callback", "module", "mod", "monitor",
           "Monitor"]
