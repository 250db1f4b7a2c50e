"""Measurement: timed candidate evaluation and tuning-key digests
(counterpart of ``mxnet_tpu/autotune/measure.py``).

:func:`measure_candidate` runs one candidate ``trials`` times and keeps the
least time.  Each trial is an ``autotune:candidate`` trace span, and its
cost is read back from the recorder (``trace.span_events``), so the
number the tuner decided on is the number the exported timeline shows.
The span starts after a ``torch.cuda.synchronize()`` and ends after
another once the process has touched the card, so it covers the device
work the trial launched, not only its enqueue.

Keys: :func:`tuning_key` digests the task, the shapes and the knob space
with :func:`backend_descriptor` -- framework, device kind, device count --
so a winner measured with one package's kernels, or on one card, never
applies to another.
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, List, Optional

import torch

from .. import trace as _trace

__all__ = ["backend_descriptor", "tuning_key", "measure_candidate",
           "timed_span", "wall_timer", "CANDIDATE_SPAN"]

CANDIDATE_SPAN = "autotune:candidate"


def wall_timer() -> Callable[[], float]:
    """Elapsed-seconds closure over one perf_counter origin: every
    duration autotune reports goes through here or :func:`timed_span`."""
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


def backend_descriptor(device=None) -> str:
    """The topology a measurement is valid for: ``torch-cuda/<device
    name>/x<device count>`` for a CUDA device, ``torch-cpu/x1`` for the
    host.  ``device`` (a ``torch.device`` or a string) defaults to the
    current CUDA device when the process sees one, else the host."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return "torch-cpu/x1"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return "torch-cuda/%s/x%d" % (torch.cuda.get_device_name(index),
                                  torch.cuda.device_count())


def tuning_key(*parts: Any, device=None) -> str:
    """sha256 over every ingredient that changes the winning config;
    :func:`backend_descriptor` of ``device`` is always appended."""
    h = hashlib.sha256()
    for part in parts + (backend_descriptor(device),):
        h.update(repr(part).encode())
        h.update(b"\x00")
    return h.hexdigest()


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_span(fn: Callable[[], Any], label: str = "", trial: int = 0,
               span: str = CANDIDATE_SPAN) -> float:
    """Run ``fn`` once under a ``span`` trace span (``label``, ``trial``
    as its attributes), the card synchronized before and inside the span
    when the process uses one, and return its duration in seconds, read
    back from the recorder.  Falls back to the same perf_counter pair
    when tracing is off."""
    _synchronize()
    t0 = time.perf_counter_ns()
    with _trace.span(span, cat="autotune", label=label, trial=trial):
        fn()
        _synchronize()
    t1 = time.perf_counter_ns()
    evs = _trace.span_events(names=(span,), since_ns=t0)
    if evs:
        # the newest matching span (ours started at or after t0)
        return max(evs, key=lambda e: e["ts"])["dur"] / 1e6
    return (t1 - t0) / 1e9


def measure_candidate(fn: Callable[[], Any], label: str = "",
                      trials: int = 3, warmup: int = 1,
                      setup: Optional[Callable[[], Any]] = None,
                      span: str = CANDIDATE_SPAN) -> float:
    """Cost of one candidate in seconds: ``fn`` runs ``warmup`` times off
    the clock (a kernel's build and first launch happen there), then
    ``trials`` times timed, and the least time is returned (autotune
    measures capability, not load).  ``setup`` runs before every call,
    off the clock."""
    for _ in range(max(0, warmup)):
        if setup is not None:
            setup()
        fn()
    costs: List[float] = []
    for i in range(max(1, trials)):
        if setup is not None:
            setup()
        costs.append(timed_span(fn, label=label, trial=i, span=span))
    return min(costs)
