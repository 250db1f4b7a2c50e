"""Profiler registries (counterpart of ``mxnet_tpu/profiler.py``): the
serving, superstep and checkpoint ones.

Every serving component registers its stats object here on
construction, weakly (a dropped engine disappears from the report with
no unregister call), so one :func:`serve_report` shows one row per live
component, each tagged by ``kind`` and carrying its own capacity shape:
``engine`` (ServeEngine: latency, queue, batch occupancy, pad waste,
bucket hits), ``decode`` (DecodeEngine: slot occupancy, steps, tokens),
``paged`` (PagedDecodeEngine: the decode row plus pool, spec decode and
inter-token latency), ``mux`` (ModelMultiplexer) and ``router``
(ServeRouter, with a rollup of its replicas).

Every ``Module`` that runs ``fit(superstep=K)`` registers a
:class:`SuperstepStats` (:func:`superstep_report`), every
``CheckpointManager`` its ``CheckpointStats``
(:func:`checkpoint_report`), every embedding consumer (a fused step with
sparse tables, an ``EmbeddingTable``) its ``EmbedStats``
(:func:`embed_report`) and every MoE consumer (a fused step routing
through ``_moe_dispatch``, a ``DecodeEngine`` sampling its hits state)
its ``MoeStats`` (:func:`moe_report`).  Every feed pipeline
(``feed.Pipeline``, ``feed.DevicePrefetchIter``) registers its
``PipelineStats`` (:func:`feed_report`), with the per-worker counters
that ``feed.ParallelReader``'s processes publish through shared memory.

The fault plane's ``FaultStats`` (kind ``plane``), every
``faults.Supervisor``'s ``SupervisorStats`` (kind ``supervisor``) and
every ``dist.FleetSupervisor``'s ``FleetStats`` (kind ``fleet``) share
one registry (:func:`faults_report`): what broke and how it recovered.

The trace timeline, ``scope`` and the other report families wait for
ROADMAP.md queue 1 item 12.
"""
from __future__ import annotations

import threading
import weakref

__all__ = ["register_serve_stats", "serve_report", "serve_report_str",
           "SuperstepStats", "register_superstep_stats", "superstep_report",
           "superstep_report_str", "register_checkpoint_stats",
           "checkpoint_report", "checkpoint_report_str",
           "register_embed_stats", "embed_report", "embed_report_str",
           "register_moe_stats", "moe_report", "moe_report_str",
           "register_feed_stats", "feed_report", "feed_report_str",
           "register_faults_stats", "faults_report", "faults_report_str"]

# register() runs on constructing threads while readers iterate: every
# reader snapshot-copies under this lock first
_registry_lock = threading.Lock()


class _Registry:
    """name -> live stats objects, weakly held, creation-ordered."""

    def __init__(self, label: str, empty_str: str):
        self.label = label
        self.empty_str = empty_str
        self._items = weakref.WeakValueDictionary()
        self._seq = 0

    def register(self, obj) -> None:
        with _registry_lock:
            self._seq += 1
            # zero-padded seq: lexicographic order == creation order
            self._items["%s#%06d" % (obj.name, self._seq)] = obj

    def snapshot(self):
        """Strong-referenced (key, obj) list, safe to iterate while
        other threads register or drop."""
        with _registry_lock:
            return sorted(self._items.items())

    def __len__(self) -> int:
        with _registry_lock:
            return len(self._items)

    def report(self) -> dict:
        return {key: obj.report() for key, obj in self.snapshot()}

    def report_str(self) -> str:
        parts = [obj.report_str() for _, obj in self.snapshot()]
        return "\n\n".join(parts) if parts else self.empty_str


_serve_registry = _Registry("serve", "(no live serve engines)")


def register_serve_stats(serve_stats) -> None:
    """Called by ServeEngine / DecodeEngine / PagedDecodeEngine /
    ModelMultiplexer / ServeRouter on construction (any object with
    name/report/report_str rides along)."""
    _serve_registry.register(serve_stats)


def serve_report() -> dict:
    """{component key: counters} for every live serving component."""
    return _serve_registry.report()


def serve_report_str() -> str:
    """Human-readable per-component serving table."""
    return _serve_registry.report_str()


# -- feed pipelines (mxnet_tpu_torch.feed) -------------------------------------
# Every stage of every live pipeline: items/s, busy time, producer and
# consumer stall time, queue depth; a multi-process reader stage merges
# its workers' counters (items/s, busy time, restarts, liveness) into
# each snapshot, so the report covers the whole reader process tree.
_feed_registry = _Registry("feed", "(no live feed pipelines)")


def register_feed_stats(pipeline_stats) -> None:
    """Called by feed.Pipeline / feed.DevicePrefetchIter on construction."""
    _feed_registry.register(pipeline_stats)


def feed_report() -> dict:
    """{pipeline key: {stage name: counters}} for every live pipeline."""
    return _feed_registry.report()


def feed_report_str() -> str:
    """Human-readable per-stage table for every live feed pipeline."""
    out = _feed_registry.report_str()
    if len(_superstep_registry):
        out += ("\n\n(superstep dispatch/wait/stage split: see "
                "mx.profiler.superstep_report_str())")
    return out


# -- superstep (Module.superstep_train) ---------------------------------------
# The host side of every superstep split three ways:
#   h2d_stage_s      stacking the megabatch and issuing its copy
#   step_dispatch_s  enqueueing the K replays (and the metric's)
#   device_wait_s    the one drain of the metric's accumulators, which
#                    waits out the device work still queued
_superstep_registry = _Registry("superstep", "(no live superstep loops)")


class SuperstepStats:
    """Counters of the K-steps-per-drain training loop: cumulative
    totals, and ``window()`` deltas for a measurement window."""

    def __init__(self, name: str = "superstep"):
        self.name = name
        self.supersteps = 0
        self.steps = 0
        self.h2d_stage_s = 0.0
        self.step_dispatch_s = 0.0
        self.device_wait_s = 0.0
        self._window_base = self._totals()

    def _totals(self) -> dict:
        return {"supersteps": self.supersteps, "steps": self.steps,
                "h2d_stage_s": self.h2d_stage_s,
                "step_dispatch_s": self.step_dispatch_s,
                "device_wait_s": self.device_wait_s}

    def add(self, steps: int, h2d_s: float, dispatch_s: float,
            wait_s: float) -> None:
        self.supersteps += 1
        self.steps += int(steps)
        self.h2d_stage_s += h2d_s
        self.step_dispatch_s += dispatch_s
        self.device_wait_s += wait_s

    def window(self) -> dict:
        """Counters accumulated since the previous window() call."""
        now = self._totals()
        delta = {k: now[k] - self._window_base[k] for k in now}
        self._window_base = now
        return delta

    def report(self) -> dict:
        out = self._totals()
        if self.steps:
            out["host_s_per_step"] = (
                self.h2d_stage_s + self.step_dispatch_s
                + self.device_wait_s) / self.steps
        return out

    def report_str(self) -> str:
        r = self.report()
        lines = ["%s: %d supersteps / %d steps" % (self.name,
                                                   r["supersteps"],
                                                   r["steps"])]
        for key in ("h2d_stage_s", "step_dispatch_s", "device_wait_s"):
            lines.append("  %-16s %10.4f" % (key, r[key]))
        if "host_s_per_step" in r:
            lines.append("  %-16s %10.6f" % ("host_s/step",
                                             r["host_s_per_step"]))
        return "\n".join(lines)


def register_superstep_stats(superstep_stats) -> None:
    """Called by Module.superstep_train on its first superstep."""
    _superstep_registry.register(superstep_stats)


def superstep_report() -> dict:
    """{key: counters} for every live superstep-training module."""
    return _superstep_registry.report()


def superstep_report_str() -> str:
    return _superstep_registry.report_str()


# -- checkpoint (mxnet_tpu_torch.checkpoint) ----------------------------------
_ckpt_registry = _Registry("checkpoint", "(no live checkpoint managers)")


def register_checkpoint_stats(ckpt_stats) -> None:
    """Called by checkpoint.CheckpointManager on construction."""
    _ckpt_registry.register(ckpt_stats)


def checkpoint_report() -> dict:
    """{manager key: counters} for every live CheckpointManager: save
    and restore wall time, bytes, and the train thread's stall."""
    return _ckpt_registry.report()


def checkpoint_report_str() -> str:
    return _ckpt_registry.report_str()


# -- embedding (mxnet_tpu_torch.embed) ----------------------------------------
_embed_registry = _Registry("embed", "(no live embedding tables)")


def register_embed_stats(embed_stats) -> None:
    """Called by embed.EmbeddingTable / FusedTrainStep on construction."""
    _embed_registry.register(embed_stats)


def embed_report() -> dict:
    """{consumer key: per-table counters} for every live embedding
    consumer: lookups, ids, unique ids, the dedup ratio, updates."""
    return _embed_registry.report()


def embed_report_str() -> str:
    return _embed_registry.report_str()


# -- MoE (mxnet_tpu_torch.moe) ------------------------------------------------
_moe_registry = _Registry("moe", "(no live MoE blocks)")


def register_moe_stats(moe_stats) -> None:
    """Called by FusedTrainStep / DecodeEngine on construction."""
    _moe_registry.register(moe_stats)


def moe_report() -> dict:
    """{consumer key: per-block routing counters} for every live MoE
    consumer: expert hits, routed, dropped, imbalance."""
    return _moe_registry.report()


def moe_report_str() -> str:
    return _moe_registry.report_str()


# -- fault injection and recovery (mxnet_tpu_torch.faults, dist.fleet) -------
_faults_registry = _Registry("faults", "(no fault plane or supervisor)")


def register_faults_stats(faults_stats) -> None:
    """Called by ``faults.install`` (the plane's stats) and by
    ``faults.Supervisor`` / ``dist.FleetSupervisor`` on construction."""
    _faults_registry.register(faults_stats)


def faults_report() -> dict:
    """Per-component fault counters: the plane row (injections by kind
    and point, the attempt) and one row per supervisor or fleet
    (attempts, restarts, recovery_s, backoff waits)."""
    return _faults_registry.report()


def faults_report_str() -> str:
    """The fault-injection and recovery table as text."""
    return _faults_registry.report_str()
