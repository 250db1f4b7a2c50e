"""Module API (counterpart of ``mxnet_tpu/module/``): ``BaseModule`` with
the fit loop, ``Module`` over one symbol on one device, and the fused
train step it runs as one captured CUDA graph per batch shape."""
from .base_module import BaseModule
from .module import Module
from .fused import FusedTrainStep

__all__ = ["BaseModule", "Module", "FusedTrainStep"]
