"""mxnet_tpu_torch.serve: dynamic-batching inference serving on the card
(counterpart of ``mxnet_tpu.serve``).

    eng = ServeEngine.from_checkpoint(
        "model", epoch=3, input_shapes={"data": (1, 3, 224, 224),
                                        "softmax_label": (1,)},
        fuse=True)
    futures = [eng.submit(x) for x in items]      # from many threads
    rows = [f.result(timeout=10.0) for f in futures]
    eng.close()

Decode, multiplexing, routing and paged LLM serving come with later
slices.
"""
from .batcher import MicroBatcher
from .engine import ServeEngine, default_buckets
from .errors import (ServeClosedError, ServeDeadlineError, ServeError,
                     ServeOverloadError, ServeRequestError)
from .stats import ServeStats

__all__ = ["ServeEngine", "MicroBatcher", "ServeStats", "default_buckets",
           "ServeError", "ServeOverloadError", "ServeDeadlineError",
           "ServeRequestError", "ServeClosedError"]
