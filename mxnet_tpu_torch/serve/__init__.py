"""mxnet_tpu_torch.serve: dynamic-batching inference serving on the card
(counterpart of ``mxnet_tpu.serve``).

    eng = ServeEngine.from_checkpoint(
        "model", epoch=3, input_shapes={"data": (1, 3, 224, 224),
                                        "softmax_label": (1,)},
        fuse=True)
    futures = [eng.submit(x) for x in items]      # from many threads
    rows = [f.result(timeout=10.0) for f in futures]
    eng.close()

Paged LLM serving (continuous batching over a paged KV cache, chunked
prefill, speculative decode):

    cfg = LMConfig(vocab=50257, dim=768, heads=12, layers=12,
                   max_context=1024)
    eng = PagedDecodeEngine(init_lm_params(cfg, seed=0), cfg,
                            num_slots=16, max_new_tokens=64)
    tokens = eng.submit(prompt_ids).result(timeout=60)
    eng.close()

Stateful decode (an RNN step with per-slot state on the card),
several models on one card, and replicas behind a router:

    dec = DecodeEngine(step_sym, params, state_shapes={"h": (200,)})
    mux = ModelMultiplexer(budget_bytes=8 << 30)
    mux.add_model("lm", lambda: PagedDecodeEngine(params, cfg))
    router = ServeRouter(lambda i: PagedDecodeEngine(params, cfg),
                         replicas=2)
    router.rolling_restart()
"""
from .batcher import MicroBatcher
from .decode import DecodeEngine
from .engine import ServeEngine, default_buckets
from .errors import (ServeClosedError, ServeDeadlineError, ServeError,
                     ServeOverloadError, ServeRequestError,
                     ServeUnavailableError)
from .mux import ModelMultiplexer, MuxStats
from .paged import KVBlockPool, LMConfig, PagedDecodeEngine, init_lm_params
from .router import RouterStats, ServeRouter
from .stats import DecodeStats, PagedStats, ServeStats

__all__ = ["ServeEngine", "MicroBatcher", "ServeStats", "default_buckets",
           "ServeError", "ServeOverloadError", "ServeDeadlineError",
           "ServeRequestError", "ServeClosedError", "ServeUnavailableError",
           "DecodeEngine", "DecodeStats", "ModelMultiplexer", "MuxStats",
           "ServeRouter", "RouterStats", "PagedDecodeEngine",
           "KVBlockPool", "LMConfig", "init_lm_params", "PagedStats"]
