"""Elastic training supervisor (counterpart of
``mxnet_tpu/faults/supervisor.py``): run a training job under a watchdog
and restart it from its latest committed checkpoint when it dies.

A child process runs ``Module.fit(checkpoint=dir, resume=True)``; the
parent watches it.  On a crash (SIGKILL, preemption, an injected fault,
a hang past ``timeout_s``) the parent waits out a jittered exponential
:class:`~.retry.Backoff`, re-launches the child with
``MXNET_FAULTS_ATTEMPT`` advanced (so the fault plane's schedule can
target "crash attempts 0 and 1, let 2 finish"), and the child's
``fit(resume=True)`` restores the newest committed step and the feed
cursor: the recovered run is bitwise equal to a fault-free one.

Two launch modes:

* ``target=[sys.executable, "train.py", ...]``: argv mode, each attempt
  a fresh subprocess with a fresh CUDA context (the mode for the card);
* ``target=callable``: fork mode, the callable runs in a forked child.
  It is refused once CUDA is initialized in the parent (a forked child
  cannot use its parent's CUDA context): launchers, not trainers.

::

    sup = faults.Supervisor([sys.executable, "train.py"],
                            checkpoint_dir="/ckpt/run7", max_restarts=5)
    rc = sup.run()                      # blocks; raises after the budget
    print(mx.profiler.faults_report_str())

``recovery_s`` is measured against the checkpoint store when
``checkpoint_dir`` is given: from the death to the restarted child
committing a step past the pre-crash high water, i.e. training moving
again, not merely a process existing.  The ``fault:`` trace instants
are no-ops until the port's ``trace/`` (ROADMAP.md, queue 1 item 12).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

from ..base import MXNetError, get_env, make_lock
from .retry import Backoff, RestartWindow

__all__ = ["Supervisor", "SupervisorStats"]

_POLL_S = 0.05


def _trace_instant(name: str, **fields) -> None:
    """A ``fault:`` trace instant: a no-op until the port's ``trace/``
    (ROADMAP.md, queue 1 item 12)."""


class SupervisorStats:
    """Restart/recovery counters for one supervisor; one row (kind
    ``supervisor``) in ``mx.profiler.faults_report()``."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("faults.supervisor")
        self._c: Dict = {
            "attempts": 0, "restarts": 0, "gave_up": False,
            "backoff_wait_s": 0.0, "recovery_s": 0.0,
            "last_recovery_s": 0.0, "last_rc": None, "run_s": 0.0,
        }

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                if k in ("gave_up", "last_rc") or k.startswith("last_"):
                    self._c[k] = v
                elif isinstance(self._c[k], bool):
                    self._c[k] = v
                else:
                    self._c[k] += v

    def report(self) -> Dict:
        with self._lock:
            out = dict(self._c)
        out["kind"] = "supervisor"
        for k in ("backoff_wait_s", "recovery_s", "last_recovery_s",
                  "run_s"):
            out[k] = round(out[k], 4)
        return out

    def report_str(self) -> str:
        r = self.report()
        return ("supervisor %r: %d attempts, %d restarts%s\n"
                "  backoff wait %.2fs total; recovery %.2fs last / "
                "%.2fs total; last rc=%s; wall %.2fs"
                % (self.name, r["attempts"], r["restarts"],
                   " (GAVE UP)" if r["gave_up"] else "",
                   r["backoff_wait_s"], r["last_recovery_s"],
                   r["recovery_s"], r["last_rc"], r["run_s"]))


class Supervisor:
    """Bounded-retry watchdog over one training job (see module
    docstring).

    Parameters
    ----------
    target : argv list | callable
        What one attempt runs (see the two launch modes above).
    max_restarts : int
        Restart budget (``MXNET_SUPERVISOR_MAX_RESTARTS``, default 5),
        counted over a SLIDING ``restart_window_s`` window — a
        preemptible-fleet job preempted daily for a month is healthy,
        one that dies ``max_restarts`` times inside the window is not
        recovering; exceeding the in-window budget raises with the
        last exit code.  A *confirmed* recovery (a commit past the
        pre-crash high water, ``checkpoint_dir`` mode) also resets the
        backoff to its first rung.
    restart_window_s : float
        The window those restarts are counted over
        (``MXNET_SUPERVISOR_WINDOW_S``, default 3600).
    backoff : Backoff
        Wait schedule between restarts (default: jittered exponential
        from ``MXNET_SUPERVISOR_BACKOFF_S``, factor 2, max 30s).
    timeout_s : float | None
        Per-attempt watchdog: a child alive past this is SIGKILLed and
        counted as a crash (None = no hang detection).
    checkpoint_dir : str | None
        Checkpoint store root; enables the commit-based ``recovery_s``
        measurement and the post-restart progress watch.
    env : dict | None
        Extra environment for argv children (on top of the parent's;
        ``MXNET_FAULTS_ATTEMPT`` is always set per attempt).
    success_codes : tuple[int]
        Exit codes that end the loop successfully (default ``(0,)``).
    """

    def __init__(self, target: Union[Sequence[str], Callable], *,
                 max_restarts: Optional[int] = None,
                 restart_window_s: Optional[float] = None,
                 backoff: Optional[Backoff] = None,
                 timeout_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 success_codes=(0,), name: str = "supervisor"):
        if not (callable(target)
                or isinstance(target, (list, tuple))):
            raise MXNetError(
                "Supervisor target must be an argv list or a callable, "
                "got %r" % (target,))
        self.target = target
        if max_restarts is None:
            max_restarts = get_env("MXNET_SUPERVISOR_MAX_RESTARTS", 5, int)
        self.max_restarts = max(0, int(max_restarts))
        if restart_window_s is None:
            restart_window_s = get_env("MXNET_SUPERVISOR_WINDOW_S",
                                       3600.0, float)
        self.restart_window_s = float(restart_window_s)
        if backoff is None:
            backoff = Backoff(
                base_s=get_env("MXNET_SUPERVISOR_BACKOFF_S", 0.5, float),
                factor=2.0, max_s=30.0, jitter=0.5, seed=0,
                name="supervisor")
        self.backoff = backoff
        self.timeout_s = timeout_s
        self.checkpoint_dir = checkpoint_dir
        self.env = dict(env or {})
        self.success_codes = set(success_codes)
        self.name = name
        self.stats = SupervisorStats(name)
        self._stopping = False
        from .. import profiler
        profiler.register_faults_stats(self.stats)

    # -- one attempt -------------------------------------------------------
    def _latest_step(self) -> int:
        if self.checkpoint_dir is None:
            return -1
        from ..checkpoint import layout
        s = layout.latest_step(self.checkpoint_dir)
        return -1 if s is None else s

    def _spawn(self, attempt: int):
        """-> (kind, handle): a Popen or a multiprocessing.Process."""
        if callable(self.target):
            _refuse_fork_after_cuda(self.name)
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            proc = ctx.Process(target=_fork_child,
                               args=(self.target, attempt),
                               name="%s-a%d" % (self.name, attempt))
            with warnings.catch_warnings():
                # a multi-threaded parent (pytest, a launcher's threads)
                # draws a DeprecationWarning from os.fork
                warnings.simplefilter("ignore", DeprecationWarning)
                proc.start()
            return "fork", proc
        env = dict(os.environ)
        env.update(self.env)
        env["MXNET_FAULTS_ATTEMPT"] = str(attempt)
        return "argv", subprocess.Popen(list(self.target), env=env)

    def _attempt(self, attempt: int, watch_from: int,
                 died_t: Optional[float]):
        """Run one child to completion; returns ``(rc, recovered)`` —
        the exit code (negative = killed by that signal, per subprocess
        convention) and whether a checkpoint commit past ``watch_from``
        was observed (a CONFIRMED recovery).  While the child runs,
        watches the checkpoint store: the first commit past
        ``watch_from`` closes the ``recovery_s`` window opened at
        ``died_t``."""
        kind, proc = self._spawn(attempt)
        self.stats.add(attempts=1)
        t0 = time.perf_counter()
        recovered = died_t is None
        next_ckpt_poll = 0.0
        try:
            while True:
                if kind == "argv":
                    rc = proc.poll()
                else:
                    rc = None if proc.is_alive() else proc.exitcode
                now = time.perf_counter()
                if not recovered and now >= next_ckpt_poll:
                    next_ckpt_poll = now + 0.25
                    if self._latest_step() > watch_from:
                        dt = now - died_t
                        self.stats.add(recovery_s=dt, last_recovery_s=dt)
                        _trace_instant("fault:supervisor_recovered",
                                       cat="faults", attempt=attempt,
                                       recovery_s=round(dt, 4))
                        recovered = True
                if rc is None and self._stopping:
                    # stop() asked run() to wind down: the child is
                    # killed and its code returned without a restart
                    self._kill(kind, proc)
                    rc = -9
                if rc is not None:
                    if not recovered and rc in self.success_codes:
                        # finished before committing a new step: the
                        # recovery window closes at exit
                        dt = time.perf_counter() - died_t
                        self.stats.add(recovery_s=dt, last_recovery_s=dt)
                        recovered = True
                    return rc, recovered and died_t is not None
                if self.timeout_s is not None \
                        and now - t0 > self.timeout_s:
                    self._kill(kind, proc)
                    return -9, recovered and died_t is not None
                time.sleep(_POLL_S)
        finally:
            if kind == "fork":
                proc.join(timeout=5.0)

    @staticmethod
    def _kill(kind, proc) -> None:
        try:
            if kind == "argv":
                proc.kill()
                proc.wait(timeout=10.0)
            else:
                proc.kill()
                proc.join(timeout=10.0)
        except Exception:
            pass

    # -- the loop ----------------------------------------------------------
    def stop(self) -> None:
        """Ask a concurrent :meth:`run` to wind down: the current child
        is SIGKILLed, backoff waits are cut short, and run() returns
        the child's exit code without further restarts.  Call from
        another thread (a bench harness abort, a shutdown hook)."""
        self._stopping = True

    def run(self) -> int:
        """Run attempts until one exits with a success code; returns
        that code.  Raises :class:`MXNetError` when the in-window
        restart budget is exhausted (stats record ``gave_up``)."""
        t_run = time.perf_counter()
        attempt = 0
        # sliding budget: a long preemptible run restarted occasionally
        # over days stays healthy; max_restarts deaths INSIDE the
        # window means the job is not recovering
        window = RestartWindow(self.max_restarts, self.restart_window_s)
        died_t: Optional[float] = None
        watch_from = self._latest_step()
        try:
            while True:
                rc, recovered = self._attempt(attempt, watch_from,
                                              died_t)
                self.stats.add(last_rc=rc)
                if recovered:
                    # training provably moved past the crash point:
                    # the next failure is a fresh incident, not a
                    # deeper rung of this one
                    self.backoff.reset()
                if rc in self.success_codes or self._stopping:
                    return rc
                died_t = time.perf_counter()
                watch_from = self._latest_step()
                in_window = window.note()
                if in_window > self.max_restarts:
                    self.stats.add(gave_up=True)
                    raise MXNetError(
                        "supervisor %r: target failed %d times within "
                        "%.0fs (restart budget %d, MXNET_SUPERVISOR_"
                        "MAX_RESTARTS over MXNET_SUPERVISOR_WINDOW_S); "
                        "last exit code %s — the job is not recovering, "
                        "stop restarting it"
                        % (self.name, in_window, self.restart_window_s,
                           self.max_restarts, rc))
                wait = self.backoff.next_wait()
                _trace_instant("fault:supervisor_restart", cat="faults",
                               attempt=attempt, rc=rc,
                               wait_s=round(wait, 4))
                attempt += 1
                self.stats.add(restarts=1, backoff_wait_s=wait)
                self.backoff.sleep(wait,
                                   should_stop=lambda: self._stopping)
        finally:
            self.stats.add(run_s=time.perf_counter() - t_run)


def _refuse_fork_after_cuda(name: str) -> None:
    """Fork mode needs a parent without CUDA: a forked child cannot use
    the parent's CUDA context."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise MXNetError(
            "supervisor %r: fork mode (a callable target) is refused once "
            "CUDA is initialized in this process (a forked child cannot "
            "use its parent's CUDA context); pass an argv list, each "
            "attempt a fresh process" % name)


def _fork_child(target: Callable, attempt: int) -> None:
    """Fork-mode child main: advance the fault-plane attempt, run the
    target, exit with its return code (uncaught exception = rc 1)."""
    os.environ["MXNET_FAULTS_ATTEMPT"] = str(attempt)
    from . import plane
    plane.reload_from_env()
    try:
        rc = target()
    except SystemExit as e:
        rc = e.code or 0
    except BaseException:
        import traceback
        traceback.print_exc(file=sys.stderr)
        rc = 1
    os._exit(int(rc or 0))
