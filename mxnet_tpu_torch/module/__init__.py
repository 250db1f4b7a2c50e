"""Module API (counterpart of ``mxnet_tpu/module/``): ``BaseModule`` with
the fit loop, ``Module`` over one symbol on one device, the fused train
step it runs as one captured CUDA graph per batch shape, and
``BucketingModule``, one Module per sequence length over shared
parameters."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .fused import FusedTrainStep

__all__ = ["BaseModule", "Module", "BucketingModule", "FusedTrainStep"]
