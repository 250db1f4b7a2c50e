"""Module API (counterpart of ``mxnet_tpu/module/``): ``BaseModule`` with
the fit loop, ``Module`` over one symbol on one device, the fused train
step it runs as one captured CUDA graph per batch shape,
``BucketingModule``, one Module per sequence length over shared
parameters, ``SequentialModule``, a chain of modules, and
``PythonModule``/``PythonLossModule``, modules written in Python."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from .fused import FusedTrainStep

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule", "FusedTrainStep"]
