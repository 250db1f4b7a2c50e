"""Plugin-parity modules (reference plugin/{warpctc,torch,opencv,sframe}).

The counterpart of ``mxnet_tpu/plugins``.  Importing registers the
WarpCTC op; the torch bridge (``mx.th``), the image functions and the
SFrame iterator come with it."""
from . import warpctc  # noqa: F401 (registers the WarpCTC op)
from . import torch_bridge
from . import opencv
from . import sframe

__all__ = ["warpctc", "torch_bridge", "opencv", "sframe"]
