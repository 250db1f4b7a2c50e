"""The retry primitive (counterpart of ``mxnet_tpu/faults/retry.py``).

Everything that retries — the ServeRouter's retry budget and half-open
probes among them — rides :class:`Backoff`: jittered exponential backoff
with a deterministic jitter stream (seeded, so a chaos run replays the
same waits) and an interruptible :meth:`Backoff.sleep` (the caller's
``should_stop`` is polled every few ms).  :class:`RestartWindow` is the
companion budget: events counted over a sliding wall-clock window.
The ``fault:retry`` trace instant waits for the port's ``trace/``
(ROADMAP.md, queue 1 item 12).

::

    b = faults.Backoff(base_s=0.05, factor=2.0, max_s=2.0, seed=7)
    out = faults.retry_call(flaky_rpc, retries=4, backoff=b)
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["Backoff", "RestartWindow", "retry_call"]


class Backoff:
    """Jittered exponential backoff with a deterministic jitter stream.

    Wait ``i`` (0-based) is ``min(base_s * factor**i, max_s)`` scaled by
    a uniform jitter in ``[1 - jitter, 1 + jitter]`` drawn from a SEEDED
    rng — two Backoffs built with the same seed produce identical wait
    sequences, so chaos runs and their reproductions sleep identically.
    """

    def __init__(self, base_s: float = 0.05, factor: float = 2.0,
                 max_s: float = 5.0, jitter: float = 0.5, seed=0,
                 name: str = "backoff"):
        if base_s < 0 or factor < 1.0 or max_s < 0:
            raise ValueError("Backoff needs base_s >= 0, factor >= 1, "
                             "max_s >= 0 (got %r, %r, %r)"
                             % (base_s, factor, max_s))
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.max_s = float(max_s)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.name = name
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._attempt = 0
        self.total_wait_s = 0.0

    @property
    def attempt(self) -> int:
        """How many waits :meth:`next_wait` has handed out."""
        return self._attempt

    def peek(self) -> float:
        """The un-jittered wait the next :meth:`next_wait` will scale."""
        return min(self.base_s * self.factor ** self._attempt, self.max_s)

    def next_wait(self) -> float:
        """Advance the schedule and return the next wait in seconds."""
        raw = self.peek()
        self._attempt += 1
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        self.total_wait_s += raw
        return raw

    def reset(self) -> None:
        """Back to the first rung (the resource proved healthy); the
        jitter stream also restarts so a reset Backoff replays its
        original sequence."""
        self._attempt = 0
        self._rng = np.random.default_rng(self._seed)

    def sleep(self, wait: Optional[float] = None,
              should_stop: Optional[Callable[[], bool]] = None,
              poll_s: float = 0.02) -> float:
        """Sleep ``wait`` seconds (default: :meth:`next_wait`) in small
        slices, polling ``should_stop`` between them so the caller stays
        responsive to shutdown; returns the seconds actually slept."""
        if wait is None:
            wait = self.next_wait()
        t0 = time.perf_counter()
        deadline = t0 + wait
        while True:
            if should_stop is not None and should_stop():
                break
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            time.sleep(min(poll_s, remaining))
        return time.perf_counter() - t0


class RestartWindow:
    """Sliding-window event budget: ``note()`` records one event and
    returns how many landed within the trailing ``window_s`` seconds.
    The caller raises when ``note() > max_events`` — a restart budget
    that heals with time instead of a lifetime counter that eventually
    condemns any long-running job."""

    def __init__(self, max_events: int, window_s: float = 60.0):
        self.max_events = int(max_events)
        self.window_s = float(window_s)
        self._times: deque = deque()
        self.total = 0

    def _expire(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._times and self._times[0] < cutoff:
            self._times.popleft()

    def note(self, now: Optional[float] = None) -> int:
        """Record one event; returns the in-window count including it."""
        now = time.perf_counter() if now is None else now
        self._expire(now)
        self._times.append(now)
        self.total += 1
        return len(self._times)

    def count(self, now: Optional[float] = None) -> int:
        now = time.perf_counter() if now is None else now
        self._expire(now)
        return len(self._times)

    def exceeded(self, now: Optional[float] = None) -> bool:
        return self.count(now) > self.max_events


def retry_call(fn: Callable, *args,
               retries: int = 3,
               backoff: Optional[Backoff] = None,
               retry_on: Tuple = (Exception,),
               should_stop: Optional[Callable[[], bool]] = None,
               on_retry: Optional[Callable] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying up to ``retries`` times on
    ``retry_on`` exceptions with ``backoff`` (default: a fresh
    :class:`Backoff`) between attempts.  ``on_retry(attempt, exc)`` is
    invoked before each wait; the final failure re-raises."""
    b = backoff if backoff is not None else Backoff()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            attempt += 1
            if attempt > retries or (should_stop is not None
                                     and should_stop()):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            b.sleep(should_stop=should_stop)
