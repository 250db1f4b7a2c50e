"""Misc helpers (counterpart of ``mxnet_tpu/misc.py``): the reference's
import path for the learning-rate schedulers, which live in
``lr_scheduler``."""
from .lr_scheduler import FactorScheduler, LRScheduler, MultiFactorScheduler

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]
