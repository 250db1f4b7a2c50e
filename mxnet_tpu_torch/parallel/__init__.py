"""Parallelism (counterpart of ``mxnet_tpu/parallel``).  So far only the
plain attention of ``ring.py``; the rest comes with scale-out (ROADMAP.md,
queue 1 item 10)."""
from .ring import attention_reference

__all__ = ["attention_reference"]
