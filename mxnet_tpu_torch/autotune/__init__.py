"""``mxnet_tpu_torch.autotune`` -- measurement-driven search over the
port's knobs (counterpart of ``mxnet_tpu/autotune``).

What is ported: the config store (the JAX package's record and path
rules), the measure-or-load :class:`Autotuner`, the shared cost model,
the rank-then-measure :class:`JointTuner`, and the kernel search over the
flash-attention kernel's compiled tiles (:mod:`.kernelsearch`)::

    mx.autotune.kernelsearch.search_flash(4, 1024, 12, 64, causal=True)
    MXNET_KERNEL_SEARCH=1   # flash_attention then loads the winner

What waits (ROADMAP.md, queue 1 item 11): ``tune_superstep`` and
``tune_fit_joint`` over the superstep's K (``fit(superstep=)``),
``tune_serve_pipeline`` and ``tune_serve_joint`` over the serving
options (the options themselves are in ``passes``), the fc and paged
kernel searches for tile parameters in those kernels, and the
profiler's autotune report (item 12).
"""
from __future__ import annotations

from typing import List

from ..base import get_env
from .measure import (CANDIDATE_SPAN, backend_descriptor, measure_candidate,
                      timed_span, tuning_key, wall_timer)
from .store import (config_path, list_configs, load_config, save_config,
                    store_dir)
from .tuner import Autotuner, AutotuneStats, select_best

__all__ = ["Autotuner", "AutotuneStats", "select_best", "tuning_key",
           "backend_descriptor", "measure_candidate", "timed_span",
           "wall_timer", "store_dir", "config_path", "load_config",
           "save_config", "list_configs", "enabled", "mode", "JointTuner",
           "default_shortlist", "recent_stats", "CANDIDATE_SPAN",
           "costmodel", "kernelsearch"]

# a tuning run is an event: keep the last N records for reports (the
# profiler's registry takes them once the profiler is ported)
_MAX_KEPT = 64
_kept_stats: List[AutotuneStats] = []


def _register_stats(stats: AutotuneStats) -> None:
    _kept_stats.append(stats)
    del _kept_stats[:-_MAX_KEPT]


def recent_stats() -> List[AutotuneStats]:
    """The records of the last tuning runs of this process, oldest
    first."""
    return list(_kept_stats)


def enabled(flag=None) -> bool:
    """Resolve an ``autotune=`` argument: an explicit True/False wins;
    None falls back to the ``MXNET_AUTOTUNE`` env knob (default off)."""
    if flag is not None:
        return bool(flag)
    return get_env("MXNET_AUTOTUNE", False, bool)


def mode(flag=None):
    """Resolve an ``autotune=`` argument to a tuning mode: ``"joint"``,
    ``"measure"`` (what ``True`` means), or None (off).
    ``MXNET_AUTOTUNE=joint`` selects joint, any other truthy value
    measure."""
    if flag is None:
        env = get_env("MXNET_AUTOTUNE", "", str)
        if env in ("", "0", "false", "False"):
            return None
        return "joint" if env == "joint" else "measure"
    if isinstance(flag, str):
        if not flag:
            return None
        return flag if flag == "joint" else "measure"
    return "measure" if flag else None


from .joint import JointTuner, default_shortlist  # noqa: E402
from . import costmodel, kernelsearch  # noqa: E402,F401
