"""mxnet_tpu_torch.faults: deterministic fault injection and the retry
primitive (counterpart of ``mxnet_tpu.faults``).

* **retry** (retry.py) — :class:`Backoff` (jittered exponential,
  seeded jitter, interruptible sleep), :class:`RestartWindow` and
  :func:`retry_call`;
* **plane** (plane.py) — named fault points driven by a seeded schedule
  (``MXNET_FAULTS="seed=7,rate=0.02,kinds=delay|error"``) that fires at
  the same calls as the JAX package's for the same spec.

* **supervisor** (supervisor.py) — :class:`Supervisor` runs training
  under a watchdog: a crash, preemption or hang becomes a bounded,
  backed-off restart from the latest committed checkpoint.

``mx.profiler.faults_report()`` holds the plane's row and one row per
supervisor (``dist.FleetSupervisor`` included).
"""
from __future__ import annotations

from .plane import (KINDS, FaultPlan, FaultStats, InjectedFault, Rule,
                    active, attempt, clear, enabled, install, parse_spec,
                    point, refresh_attempt, reload_from_env, stats)
from .retry import Backoff, RestartWindow, retry_call
from .supervisor import Supervisor, SupervisorStats

__all__ = ["point", "install", "clear", "active", "enabled", "attempt",
           "parse_spec", "reload_from_env", "refresh_attempt", "stats",
           "KINDS", "FaultPlan", "FaultStats", "InjectedFault", "Rule",
           "Backoff", "RestartWindow", "retry_call", "Supervisor",
           "SupervisorStats"]
