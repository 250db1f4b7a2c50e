"""mxnet_tpu_torch.serve.paged — LLM serving on the continuous-batching
substrate: paged KV-cache attention, chunked prefill, speculative decode
(counterpart of ``mxnet_tpu.serve.paged``).

* :mod:`.pool` — :class:`.KVBlockPool`: K/V on the device in fixed-size
  blocks addressed through per-slot page tables; admission reserves
  worst-case blocks so nothing drops mid-stream;
* :mod:`.model` — a small transformer LM (:class:`.LMConfig`,
  :func:`.init_lm_params`, :func:`.lm_forward`) parameterised over the
  attention, shared by target and draft;
* :mod:`.engine` — :class:`.PagedDecodeEngine` and :func:`.paged_step`:
  one (S, C) step serves pure decode (C = 1), chunk-width prefill and
  speculative verify;
* :mod:`.spec` — :class:`.SpecDecoder`: greedy draft/verify speculative
  decode, token-identical to pure target decode.

The attention kernel itself (``paged_attention`` + its plain version)
lives in :mod:`mxnet_tpu_torch.ops.cuda_kernels`.
"""
from .engine import PagedDecodeEngine, paged_forward, paged_step
from .model import LMConfig, causal_attend, init_lm_params, lm_forward, \
    param_bytes
from .pool import KVBlockPool
from .spec import SpecDecoder

__all__ = [
    "KVBlockPool",
    "LMConfig",
    "PagedDecodeEngine",
    "SpecDecoder",
    "causal_attend",
    "init_lm_params",
    "lm_forward",
    "paged_forward",
    "paged_step",
    "param_bytes",
]
