"""Measurement: timed candidate evaluation and tuning-key digests
(counterpart of ``mxnet_tpu/autotune/measure.py``).

:func:`measure_candidate` runs one candidate ``trials`` times and keeps the
least time.  Each timed trial ends in ``torch.cuda.synchronize()`` once the
process has touched the card, so a trial's time covers the device work it
launched, not only its enqueue.  The clock is the ``perf_counter`` pair
around the trial: the JAX package reads the same span back from its trace
recorder, which the port does not have yet (ROADMAP.md, queue 1 item 12).

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
    """Run ``fn`` once, synchronize the card when the process uses one,
    and return the seconds it took.  ``label``, ``trial`` and ``span``
    name the trace span the JAX package records; the port keeps them for
    the same call sites and records no span yet."""
    _synchronize()
    t0 = time.perf_counter()
    fn()
    _synchronize()
    return time.perf_counter() - t0


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
