"""Tier-1 enforcement plugin: per-module thread/process leak guard and
lock-order cycle check.

The counterpart of ``mxnet_tpu/analysis/pytest_plugin.py``; it reads the
port's recorder.  Load it with ``-p mxnet_tpu_torch.analysis.pytest_plugin``,
or import its fixture into a test module
(``from mxnet_tpu_torch.analysis.pytest_plugin import
_mxnet_analysis_guard``): a module-level fixture of that name takes the
place of a conftest's guard for that module.  Per test MODULE it

* snapshots live threads + child processes before the first test and
  fails the module if new ones survive teardown past a grace window
  (``MXNET_LEAK_CHECK=0`` disables), and
* fails the module if the lock-order recorder (``MXNET_LOCK_CHECK=1``,
  see ``analysis/lockcheck.py``) observed a NEW acquisition-order cycle
  while the module ran.

Module granularity is deliberate: fixtures and engines are commonly
module-scoped, so per-test checks would flag still-live module
fixtures; per-session checks would blame the wrong file.
"""
from __future__ import annotations

import pytest


@pytest.fixture(autouse=True, scope="module")
def _mxnet_analysis_guard(request):
    from mxnet_tpu_torch.analysis import leakguard, lockcheck
    leak_on = leakguard.enabled()
    before = leakguard.snapshot() if leak_on else None
    cycles_before = len(lockcheck.cycles())
    yield
    problems = []
    new_cycles = lockcheck.cycles()[cycles_before:]
    for c in new_cycles:
        problems.append("lock-order cycle %s (second order seen at:\n%s)"
                        % (" -> ".join(c["cycle"]), c["stack"]))
    if leak_on:
        problems.extend(leakguard.check(before))
    if problems:
        pytest.fail("analysis guard: %s leaked resources/invariants:\n  %s"
                    % (request.module.__name__,
                       "\n  ".join(problems)), pytrace=False)
