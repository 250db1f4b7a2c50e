"""``mxnet_tpu_torch.compile_cache`` -- the kernels' builds in a
persistent store, warm-up off the hot loop, and build accounting
(counterpart of ``mxnet_tpu/compile_cache``).

1. **Persistent store** (``cached.py``, ``store.py``, ``fingerprint.py``):
   with ``MXNET_COMPILE_CACHE=<dir>`` the hand-written kernels' libraries
   (``ops/cuda_kernels.py``) are published there after their ``nvcc``
   build and loaded from there by later processes, keyed on each
   library's digest and the environment (torch, CUDA, the device, nvcc,
   the compile line).  Atomic publish, digests checked before a load, an
   LRU size bound (``MXNET_COMPILE_CACHE_SIZE_MB``, default 2048), and a
   warn-once rebuild of any malformed entry.

2. **Warm-up** (``warmup.py``): ``parallel_warm`` runs a program grid's
   host work through a bounded thread pool, with CUDA graph captures
   serialized per device; ``BucketingModule.precompile``,
   ``Predictor.precompile`` and ``Module.prepare`` ride it.
   ``ServeEngine`` warms by running each bucket once through its batch
   path (``CachedFunction.first_run`` counts that run as the build).

3. **Accounting** (``stats.py``): per program, build seconds, hits,
   misses, bypasses with their reason, bytes on disk and the
   steady-state rebuild counter, via
   ``mx.profiler.compile_report()/_str()``.  CUDA graphs and executor
   programs stay in their process (``IN_PROCESS_REASON``).
"""
from .cached import (IN_PROCESS_REASON, CachedFunction, CompileCache,
                     cached_program, configure, get_cache, reset)
from .stats import CompileStats, get_stats
from .warmup import (WarmupError, capture, capture_lock,
                     default_warmup_threads, parallel_warm)

__all__ = ["CachedFunction", "CompileCache", "CompileStats", "WarmupError",
           "IN_PROCESS_REASON", "cached_program", "capture", "capture_lock",
           "configure", "default_warmup_threads", "get_cache", "get_stats",
           "parallel_warm", "reset"]
