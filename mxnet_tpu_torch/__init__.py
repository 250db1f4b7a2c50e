"""mxnet_tpu_torch: the PyTorch and CUDA port of ``mxnet_tpu``.

The same user surface as the JAX package, on one NVIDIA H100:
``import mxnet_tpu_torch as mx``, then ``mx.nd``, ``mx.sym``,
``mx.predictor``, ``mx.serve``, ``mx.autotune``, and for training
``mx.mod``, ``mx.optimizer``, ``mx.init``, ``mx.metric``, ``mx.io``,
``mx.lr_scheduler``, ``mx.callback``, ``mx.random``, ``mx.Monitor``,
``mx.kv`` (``mx.create_kvstore``), ``mx.model.FeedForward`` and
``mx.checkpoint``; the input pipeline (``mx.recordio``, ``mx.feed``
and the record iterators of ``mx.io``); routed Mixture-of-Experts
(``mx.moe``) and the sparse embedding engine (``mx.embed``);
``mx.engine``, ``mx.faults``, ``mx.trace`` (the span timeline) and
``mx.profiler`` (the device timeline and every subsystem's report);
the online loop (``mx.online``); Python custom ops (``mx.operator``),
users' CUDA kernels (``mx.rtc``), the plugins (``mx.plugins``, with
``WarpCTC`` and the torch bridge ``mx.th``) and ``mx.viz``.
Plain tensor code is PyTorch; the package's TPU kernels are hand-written Hopper kernels
(``ops/cuda_kernels.py``, sources in ``csrc/``).  Entry points run on
``gpu(0)`` unless the caller asks for ``cpu()``.

The port goes slice by slice (ROADMAP.md).  This package imports
``torch`` and never ``jax`` or ``mxnet_tpu``.
"""
from . import base
from . import _distributed_boot  # joins the launcher's process group
from .base import MXNetError
from .context import Context, cpu, cpu_pinned, current_context, gpu
from . import engine
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import ops
from .ops import nd_bridge as _nd_bridge
_nd_bridge.register_all()   # every aux-free op as mx.nd.<op>
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from .attribute import AttrScope
from .name import NameManager, Prefix
from . import executor
from .executor import Executor
from . import kvstore
from . import kvstore as kv
from .kvstore import create as create_kvstore
from . import executor_manager
from . import model
from .model import FeedForward
from . import predictor
from .predictor import Predictor, create_predictor
from . import passes
from . import serve
from . import models
from . import convert
from . import parallel
from . import autotune
from . import compile_cache
from . import random
from . import random as rnd
from . import initializer
from . import initializer as init
from . import optimizer
from . import optimizer as opt
from .optimizer import Optimizer
from . import lr_scheduler
from . import metric
from . import io
from . import recordio
from . import feed
from . import callback
from . import module
from . import module as mod
from . import monitor
from .monitor import Monitor
from . import trace
from . import profiler
from . import faults
from . import checkpoint
from . import online
from . import moe
from . import embed
from . import dist
from . import libinfo
from . import misc
from . import symbol_doc
from . import visualization
from . import visualization as viz
from . import operator
from .operator import CustomOp, CustomOpProp, NumpyOp, NDArrayOp
from . import rtc
from . import plugins
from .plugins import torch_bridge as th
from . import native_io

__version__ = libinfo.__version__

# a scheduler or server role (tools/launch.py -s N) runs the
# parameter-server loop here and exits (reference __init__ imports
# kvstore_server last for the same reason)
from . import kvstore_server  # noqa: E402,F401

__all__ = ["MXNetError", "Context", "cpu", "cpu_pinned", "gpu",
           "current_context", "engine", "nd", "ndarray", "NDArray", "sym",
           "symbol", "Symbol", "ops", "AttrScope", "NameManager", "Prefix",
           "executor", "Executor", "Optimizer", "profiler", "faults",
           "libinfo", "misc", "symbol_doc", "model", "predictor",
           "Predictor", "create_predictor", "passes", "serve", "models",
           "convert", "parallel", "autotune", "compile_cache", "random",
           "rnd",
           "initializer", "init", "optimizer", "opt", "lr_scheduler",
           "metric", "io", "callback", "module", "mod", "monitor",
           "Monitor", "kvstore", "kv", "create_kvstore", "executor_manager",
           "FeedForward", "checkpoint", "moe", "embed", "recordio", "feed",
           "dist", "visualization", "viz", "operator", "CustomOp",
           "CustomOpProp", "NumpyOp", "NDArrayOp", "rtc", "plugins", "th"]
