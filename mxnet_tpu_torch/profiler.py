"""Profiler: the device timeline, the span timeline, scoped annotations
and the subsystems' report registries (counterpart of
``mxnet_tpu/profiler.py``, with the same names).

The card's own timeline is PyTorch's profiler (Kineto over CUPTI), where
the reference started ``jax.profiler``'s xprof trace::

    mx.profiler.profiler_set_config(filename="/tmp/trace")
    mx.profiler.profiler_set_state("run")
    ... training steps, serving ...
    mx.profiler.profiler_set_state("stop")   # Chrome trace in /tmp/trace

    with mx.profiler.scope("data-loading"):  # named regions in both
        batch = next(it)

``"stop"`` writes the device trace as Chrome JSON into the configured
directory: every kernel the card ran, the port's hand kernels
(``fc_epilogue``, ``paged_attention``, ...) by name, on CUDA lanes.
:func:`dump_trace` writes the span timeline of ``mxnet_tpu_torch.trace``
(host spans of every hot path, the forked readers' lanes merged).

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
:class:`SuperstepStats` (:func:`superstep_report`), every fused step over
a mesh of more than one rank a :class:`MultichipStats`
(:func:`multichip_report`), every ``CheckpointManager`` its
``CheckpointStats`` (:func:`checkpoint_report`), every embedding
consumer (a fused step with sparse tables, an ``EmbeddingTable``) its
``EmbedStats`` (:func:`embed_report`), every MoE consumer (a fused step
routing through ``_moe_dispatch``, a ``DecodeEngine`` sampling its hits
state) its ``MoeStats`` (:func:`moe_report`) and every pass pipeline its
``PassStats`` (:func:`passes_report`).  Every feed pipeline
(``feed.Pipeline``, ``feed.DevicePrefetchIter``) registers its
``PipelineStats`` (:func:`feed_report`), with the per-worker counters
that ``feed.ParallelReader``'s processes publish through shared memory.

The fault plane's ``FaultStats`` (kind ``plane``), every
``faults.Supervisor``'s ``SupervisorStats`` (kind ``supervisor``) and
every ``dist.FleetSupervisor``'s ``FleetStats`` (kind ``fleet``) share
one registry (:func:`faults_report`): what broke and how it recovered.
The online loop's capture writers, trainers and gates share another
(:func:`online_report`).

Every tuning run (``autotune.Autotuner``, ``JointTuner``, the kernel
searches) registers its ``AutotuneStats`` (:func:`autotune_report`; the
autotune package keeps the last 64 alive), :func:`costmodel_report` is
the shared cost model's lifecycle, and :func:`compile_report` is a view
over the process's one ``compile_cache.CompileStats`` (per program
builds, hits, misses, bypasses and steady-state rebuilds) and the
persistent store.  :func:`unified_report` puts them all under one roof;
the run-metrics journal (``MXNET_TRACE_JOURNAL``) writes it every N
steps.
"""
from __future__ import annotations

import contextlib
import os
import weakref

from .base import make_lock

__all__ = ["profiler_set_config", "profiler_set_state", "scope",
           "dump_profile", "dump_trace", "state", "register_feed_stats",
           "feed_report", "feed_report_str", "register_checkpoint_stats",
           "checkpoint_report", "checkpoint_report_str", "SuperstepStats",
           "register_superstep_stats", "superstep_report",
           "superstep_report_str", "register_serve_stats", "serve_report",
           "serve_report_str", "register_embed_stats", "embed_report",
           "embed_report_str", "register_moe_stats", "moe_report",
           "moe_report_str", "compile_report", "compile_report_str",
           "register_passes_stats", "passes_report", "passes_report_str",
           "register_autotune_stats", "autotune_report",
           "autotune_report_str", "costmodel_report",
           "costmodel_report_str", "register_faults_stats",
           "faults_report", "faults_report_str",
           "register_online_stats", "online_report", "online_report_str",
           "MultichipStats", "register_multichip_stats",
           "multichip_report", "multichip_report_str", "unified_report",
           "unified_report_str"]

_config = {"filename": "profile_output", "mode": "symbolic"}
_state = "stop"
# the running torch.profiler.profile between "run" and "stop"
_prof = None
_state_lock = make_lock("profiler.state")


def profiler_set_config(mode: str = "symbolic",
                        filename: str = "profile_output") -> None:
    """Configure the trace output directory (reference
    MXSetProfilerConfig(mode, filename))."""
    _config["mode"] = mode
    _config["filename"] = filename


def profiler_set_state(state_name: str = "stop") -> None:
    """``"run"`` starts PyTorch's profiler over the host and, when a card
    is present, the card (CUDA activities, through CUPTI); ``"stop"``
    ends it and writes its Chrome trace into the configured directory
    (reference MXSetProfilerState(1/0), which ran jax.profiler's xprof
    trace).  The file is ``<filename>/device.<pid>.trace.json``;
    :func:`device_trace_path` names the last one."""
    global _state, _prof
    if state_name not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    with _state_lock:
        if state_name == "run" and _state != "run":
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(_config["filename"], exist_ok=True)
            _prof = profile(activities=acts)
            _prof.__enter__()
            _state = "run"
        elif state_name == "stop" and _state == "run":
            prof, _prof = _prof, None
            _state = "stop"
            prof.__exit__(None, None, None)
            path = os.path.join(_config["filename"],
                                "device.%d.trace.json" % os.getpid())
            prof.export_chrome_trace(path)


def state() -> str:
    return _state


def dump_profile() -> str:
    """Write the Chrome-format span trace for the configured filename
    and return its path (reference MXDumpProfile wrote the json to the
    configured file).  The device trace of ``profiler_set_state("run")``
    lands in the configured directory separately."""
    from . import trace as _trace
    out = _config["filename"]
    path = out if out.endswith(".json") else out + ".trace.json"
    return _trace.dump_trace(path)


def dump_trace(path: str) -> str:
    """Write the merged span timeline (this process + registered worker
    spill dirs) as Chrome/Perfetto trace-event JSON; returns ``path``.
    See mxnet_tpu_torch.trace."""
    from . import trace as _trace
    return _trace.dump_trace(path)


@contextlib.contextmanager
def scope(name: str):
    """A named region on both timelines: a ``trace.span(name,
    cat="scope")`` in the span dump, and ``torch.profiler.
    record_function`` in the device trace while ``profiler_set_state
    ("run")`` holds one open (the reference paired jax's
    TraceAnnotation with the span)."""
    import torch
    from . import trace as _trace
    with torch.profiler.record_function(name):
        with _trace.span(name, cat="scope"):
            yield

# register() runs on constructing threads while readers iterate: every
# reader snapshot-copies under this lock first
_registry_lock = make_lock("profiler.registry")


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

    def report(self, **kw) -> dict:
        return {key: obj.report(**kw) for key, obj in self.snapshot()}

    def report_str(self, **kw) -> str:
        parts = [obj.report_str(**kw) for _, obj in self.snapshot()]
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
    out = _superstep_registry.report_str()
    if len(_multichip_registry):
        out += ("\n\n(per-axis collective/compute split: see "
                "mx.profiler.multichip_report_str())")
    return out


# -- multichip (module/fused.py over a mesh of more than one rank) ------------
# One MultichipStats per such FusedTrainStep:
#   dispatch_s        host time issuing the step (the card runs on after)
#   sampled_device_s  the step's wall from a drained stream to a drained
#                     stream, on 1 in sample_every steps (never the
#                     first, whose wall is the warm-up and capture)
#   flops/bytes       this rank's work in one step, when a measurement
#                     of one eager step set it (the shard search's
#                     features: FlopCounterMode, the saved activations)
#   collectives       the calls and bytes of parallel.collectives in the
#                     step's first (eager) run, with the redistributions
#                     by op
# There is no partitioned HLO to read: the census is the collectives
# module's own count of what the step ran.
_multichip_registry = _Registry("multichip", "(no live multichip steps)")

_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all")


class MultichipStats:
    """Counters for one mesh-spanning fused train step (see the section
    note above).  ``axes`` is the mesh's ((name, size), ...) tuple;
    ``spec_axes`` the axes any per-param sharding spec references."""

    def __init__(self, name: str, axes, spec_axes=(), sample_every: int = 16):
        self.name = name
        self.axes = tuple((str(a), int(s)) for a, s in axes)
        self.spec_axes = tuple(spec_axes)
        self.devices = 1
        for _, s in self.axes:
            self.devices *= s
        self.sample_every = max(1, int(sample_every))
        self.steps = 0
        self.dispatch_s = 0.0
        self.first_step_s = 0.0
        self.sampled_steps = 0
        self.sampled_device_s = 0.0
        self.flops_per_step = 0.0
        self.bytes_per_step = 0.0
        self.collectives = None

    def add_step(self, dispatch_s: float) -> None:
        self.steps += 1
        self.dispatch_s += dispatch_s

    def note_first(self, dispatch_s: float) -> None:
        """The first step of a batch shape runs the warm-up and the
        capture: it gets its own counter, or it would dominate
        dispatch_s_per_step."""
        self.steps += 1
        self.first_step_s = dispatch_s

    def should_sample(self) -> bool:
        """Checked BEFORE add_step: true on the 2nd, (N+2)th, ... call,
        never the first (sample_every=1 samples every step after it)."""
        return self.sample_every == 1 \
            or self.steps % self.sample_every == 1

    def add_wait(self, device_s: float) -> None:
        self.sampled_steps += 1
        self.sampled_device_s += device_s

    def add_superstep(self, k: int, dispatch_s: float,
                      wait_s: float = 0.0) -> None:
        """K steps dispatched as one superstep: the metric drain's wait
        already measures the device wall, so it feeds the sampled column
        without extra syncs."""
        self.steps += int(k)
        self.dispatch_s += dispatch_s
        if wait_s:
            self.sampled_steps += int(k)
            self.sampled_device_s += wait_s

    def set_cost(self, flops: float = 0.0, bytes_accessed: float = 0.0,
                 collectives=None) -> None:
        self.flops_per_step = float(flops)
        self.bytes_per_step = float(bytes_accessed)
        if collectives is not None:
            self.collectives = dict(collectives)

    def report(self, peak_tflops=None, ici_gbps=None) -> dict:
        out = {
            "mesh": dict(self.axes),
            "devices": self.devices,
            "steps": self.steps,
            "dispatch_s": round(self.dispatch_s, 4),
            "sampled_steps": self.sampled_steps,
            "sampled_device_s": round(self.sampled_device_s, 4),
        }
        out["per_axis"] = {
            a: {"size": s,
                "batch_sharded": a == "dp",
                "param_sharded": a in self.spec_axes}
            for a, s in self.axes}
        if self.first_step_s:
            out["first_step_s"] = round(self.first_step_s, 4)
        if self.sampled_steps:
            out["device_s_per_step"] = round(
                self.sampled_device_s / self.sampled_steps, 6)
        steady = self.steps - (1 if self.first_step_s else 0)
        if steady > 0:
            out["dispatch_s_per_step"] = round(
                self.dispatch_s / steady, 6)
        if self.flops_per_step:
            out["flops_per_step"] = self.flops_per_step
            out["bytes_per_step"] = self.bytes_per_step
        if self.collectives is not None:
            out["collectives"] = self.collectives
        # the estimate's split, when the caller gives the rates: the
        # counts are this rank's already, so nothing divides by devices
        if peak_tflops and self.flops_per_step:
            out["compute_s_est"] = self.flops_per_step \
                / (peak_tflops * 1e12)
        if ici_gbps and self.collectives and \
                self.collectives.get("total_bytes"):
            out["collective_s_est"] = (self.collectives["total_bytes"]
                                       / (ici_gbps * 1e9))
            if out.get("compute_s_est"):
                tot = out["compute_s_est"] + out["collective_s_est"]
                out["collective_frac_est"] = out["collective_s_est"] / tot
        if out.get("device_s_per_step") and out.get("compute_s_est"):
            out["collective_s_measured_est"] = max(
                0.0, out["device_s_per_step"] - out["compute_s_est"])
        return out

    def report_str(self, peak_tflops=None, ici_gbps=None) -> str:
        r = self.report(peak_tflops=peak_tflops, ici_gbps=ici_gbps)
        mesh = " x ".join("%s=%d" % (a, s) for a, s in self.axes)
        lines = ["%s: mesh %s (%d devices), %d steps"
                 % (self.name, mesh or "1", r["devices"], r["steps"])]
        if "dispatch_s_per_step" in r:
            lines.append("  dispatch_s/step   %10.6f"
                         % r["dispatch_s_per_step"])
        if "first_step_s" in r:
            lines.append("  first step        %10.4f (warm-up+capture)"
                         % r["first_step_s"])
        if "device_s_per_step" in r:
            lines.append("  device_s/step     %10.6f (sampled %d)"
                         % (r["device_s_per_step"], r["sampled_steps"]))
        if "flops_per_step" in r:
            lines.append("  flops/step        %10.3e" % r["flops_per_step"])
        c = r.get("collectives")
        if c:
            lines.append("  collectives/step  %d ops, %.3f MB"
                         % (c["total_count"], c["total_bytes"] / 1e6))
            for op in _COLLECTIVE_OPS:
                if c.get(op, {}).get("count"):
                    lines.append("    %-19s %3d ops %10.3f MB"
                                 % (op, c[op]["count"],
                                    c[op]["bytes"] / 1e6))
        if "collective_frac_est" in r:
            lines.append("  collective frac   %10.3f (est @ %s TF/s, %s "
                         "GB/s link)" % (r["collective_frac_est"],
                                         peak_tflops, ici_gbps))
        for a, info in r["per_axis"].items():
            use = [u for u, on in (("batch", info["batch_sharded"]),
                                   ("params", info["param_sharded"])) if on]
            lines.append("  axis %-6s size %2d  shards: %s"
                         % (a, info["size"], ", ".join(use) or "(unused)"))
        return "\n".join(lines)


def register_multichip_stats(multichip_stats) -> None:
    """Called by FusedTrainStep when its mesh spans more than one rank."""
    _multichip_registry.register(multichip_stats)


def multichip_report(peak_tflops=None, ici_gbps=None) -> dict:
    """{key: counters} for every live mesh-spanning train step; pass
    per-device ``peak_tflops`` and the link's ``ici_gbps`` for the
    collective-vs-compute time estimate."""
    return _multichip_registry.report(peak_tflops=peak_tflops,
                                      ici_gbps=ici_gbps)


def multichip_report_str(peak_tflops=None, ici_gbps=None) -> str:
    """Human-readable per-mesh dispatch/device/collective table."""
    return _multichip_registry.report_str(peak_tflops=peak_tflops,
                                          ici_gbps=ici_gbps)


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


# -- autotune runs (mxnet_tpu_torch.autotune) ---------------------------------
_autotune_registry = _Registry("autotune", "(no autotune runs)")


def register_autotune_stats(autotune_stats) -> None:
    """Called by every tuner on construction."""
    _autotune_registry.register(autotune_stats)


def autotune_report() -> dict:
    """{run key: record} per tuning run: the store key, whether the
    config was measured or loaded, every candidate's cost, the winner."""
    return _autotune_registry.report()


def autotune_report_str() -> str:
    """The candidate/cost table of each tuning run as text."""
    return _autotune_registry.report_str()


# -- builds (mxnet_tpu_torch.compile_cache) -----------------------------------
# One CompileStats per process, owned by compile_cache; these are views.

def compile_report() -> dict:
    """Per-program build seconds, hits / misses / bypasses (with the
    reason in-process programs are not stored), steady-state rebuilds,
    and the store's directory, entries and bytes."""
    from .compile_cache import get_cache, get_stats
    return get_stats().report(cache=get_cache())


def compile_report_str() -> str:
    """The build table as text (see :func:`compile_report`)."""
    from .compile_cache import get_cache, get_stats
    return get_stats().report_str(cache=get_cache())


# -- pass pipelines (mxnet_tpu_torch.passes) ----------------------------------
_passes_registry = _Registry("passes", "(no pass pipelines)")


def register_passes_stats(passes_stats) -> None:
    """Called by passes.PassPipeline on construction."""
    _passes_registry.register(passes_stats)


def passes_report() -> dict:
    """Per-pipeline, per-pass wall seconds, node counts in/out, rewrite
    counts and the pipeline fingerprint (see mxnet_tpu_torch.passes)."""
    return _passes_registry.report()


def passes_report_str() -> str:
    """Human-readable pass-pipeline table (see passes_report)."""
    return _passes_registry.report_str()


def costmodel_report() -> dict:
    """The shared learned cost model's lifecycle snapshot for this
    backend: version, trained or prior-only, training-sample count, and
    the pickle path (see autotune.costmodel)."""
    from .autotune import costmodel
    return costmodel.report()


def costmodel_report_str() -> str:
    """Human-readable cost-model lifecycle line (see costmodel_report)."""
    r = costmodel_report()
    return ("costmodel v%d backend=%s %s samples=%d path=%s"
            % (r["version"], r["backend"],
               "trained" if r["trained"]
               else ("loaded(prior)" if r["loaded"] else "(not loaded)"),
               r["samples"], r["path"] or "-"))


# -- the online loop (mxnet_tpu_torch.online) ----------------------------------
# Every CaptureWriter (kind "capture"), OnlineTrainer (kind "trainer")
# and PromotionGate (kind "gate").
_online_registry = _Registry("online", "(no online loop)")


def register_online_stats(online_stats) -> None:
    """Called by online.CaptureWriter / OnlineTrainer / PromotionGate
    on construction."""
    _online_registry.register(online_stats)


def online_report() -> dict:
    """Per-component online-loop counters: capture sampling, fine-tune
    rounds, gate decisions.  See mxnet_tpu_torch.online."""
    return _online_registry.report()


def online_report_str() -> str:
    """Human-readable online-loop table."""
    return _online_registry.report_str()


# -- the unified view ----------------------------------------------------------
def unified_report() -> dict:
    """Every subsystem's report under one roof: ``{"feed": ...,
    "superstep": ..., "multichip": ..., "checkpoint": ..., "serve": ...,
    "compile": ..., "trace": ...}`` -- the snapshot the run-metrics
    journal (``MXNET_TRACE_JOURNAL``) writes every N steps."""
    out = {
        "feed": feed_report(),
        "superstep": superstep_report(),
        "multichip": multichip_report(),
        "checkpoint": checkpoint_report(),
        "serve": serve_report(),
        "embed": embed_report(),
        "moe": moe_report(),
        "passes": passes_report(),
        "autotune": autotune_report(),
        "costmodel": costmodel_report(),
        "faults": faults_report(),
        "online": online_report(),
    }
    try:
        out["compile"] = compile_report()
    except Exception:   # the store unreadable: the report degrades
        out["compile"] = {}
    from . import trace as _trace
    out["trace"] = _trace.trace_report()
    return out


def unified_report_str() -> str:
    """Every subsystem's human-readable table, sectioned."""
    sections = [
        ("feed", feed_report_str),
        ("superstep", superstep_report_str),
        ("multichip", multichip_report_str),
        ("checkpoint", checkpoint_report_str),
        ("serve", serve_report_str),
        ("embed", embed_report_str),
        ("moe", moe_report_str),
        ("passes", passes_report_str),
        ("autotune", autotune_report_str),
        ("costmodel", costmodel_report_str),
        ("faults", faults_report_str),
        ("online", online_report_str),
        ("compile", compile_report_str),
    ]
    parts = []
    for label, fn in sections:
        try:
            body = fn()
        except Exception as e:
            body = "(unavailable: %s)" % e
        parts.append("== %s %s\n%s" % (label, "=" * max(1, 68 - len(label)),
                                       body))
    from . import trace as _trace
    tr = _trace.trace_report()
    parts.append("== trace %s\nenabled=%s events=%d dropped=%d "
                 "spill_dirs=%d journal=%s"
                 % ("=" * 62, tr["enabled"], tr["events"], tr["dropped"],
                    len(tr["spill_dirs"]), tr["journal"] or "-"))
    return "\n\n".join(parts)
