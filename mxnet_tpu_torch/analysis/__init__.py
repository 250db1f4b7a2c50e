"""mxnet_tpu_torch.analysis: project-specific static and runtime bug
detectors (the counterpart of ``mxnet_tpu/analysis``).

* **Static lint** (``linter.py``): AST rules distilled from the JAX
  package's bug archaeology, rewritten where a rule named a JAX API —
  raw kernel builds and loads outside ``ops/cuda_kernels.py``, CUDA
  graph captures outside the compile cache, raw env reads, wall-clock
  timing arithmetic, fork-hostile global RNG draws, raw future
  settlement.  Run with ``python -m mxnet_tpu_torch.analysis`` (inline
  suppressions with reasons, a baseline, ``--diff``).
* **Lock-order recorder** (``lockcheck.py``): ``base.make_lock(name)``
  builds the per-process acquired-while-holding graph and reports
  cycles, potential deadlocks, on any schedule that exercises both
  orders (``MXNET_LOCK_CHECK=1``).
* **Leak guard** (``leakguard.py`` + ``pytest_plugin.py``): fails any
  test module leaving stray threads or child processes behind.
"""
from . import linter
from .leakguard import check as check_leaks
from .leakguard import snapshot as leak_snapshot
from .linter import Finding, lint_paths, lint_source
from .lockcheck import (cycles, lock_order_report, make_condition,
                        make_lock, make_rlock)

__all__ = ["linter", "Finding", "lint_paths", "lint_source",
           "make_lock", "make_rlock", "make_condition", "cycles",
           "lock_order_report", "leak_snapshot", "check_leaks"]
