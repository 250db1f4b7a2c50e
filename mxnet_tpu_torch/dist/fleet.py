"""Fleet supervisor (counterpart of ``mxnet_tpu/dist/fleet.py``):
:class:`~mxnet_tpu_torch.faults.Supervisor` generalized to a job of
several rank processes.

A job of N ranks joined in one ``torch.distributed`` group has no
partial-failure mode: when one rank dies mid-collective the survivors
wait inside a collective that will never complete.  So the unit of
restart is the fleet, not the process:

1. spawn N workers wired to a fresh local coordinator through the
   ``MXNET_TPU_COORDINATOR`` / ``_NUM_WORKERS`` / ``_WORKER_ID`` envs
   that ``dist/boot.py`` reads at ``import mxnet_tpu_torch`` (a
   ``host:port`` coordinator becomes ``tcp://host:port``), as
   ``tools/launch.py`` does;
2. on any worker's death (a SIGKILL'd rank, an injected ``dist.host``
   fault, a hang past ``timeout_s``): kill the survivors, wait out the
   jittered :class:`~mxnet_tpu_torch.faults.retry.Backoff`, and form the
   fleet again with ``MXNET_FAULTS_ATTEMPT`` advanced;
3. the new fleet restores from the latest checkpoint commit (a
   multi-process save is committed whole or not at all), so the
   recovered run is bitwise equal to a fault-free one.

Two loss policies:

* ``on_loss="rejoin"`` (default): restart at full strength, the lost
  rank rejoining from the commit store;
* ``on_loss="shrink"``: one rank fewer each time (never below
  ``min_workers``); the restore lands the committed state on the new,
  smaller mesh, as ``Module.set_mesh`` carries a train state.

``recovery_s`` runs from the death to the new fleet committing a step
past the pre-crash high water (training moving, not merely processes
existing).  The ``fault:`` trace instants are no-ops until the port's
``trace/`` (ROADMAP.md, queue 1 item 12).

::

    sup = dist.FleetSupervisor(
        [sys.executable, "train.py"], nworkers=2,
        checkpoint_dir="/ckpt/run7", max_restarts=3)
    rc = sup.run()
    print(mx.profiler.faults_report_str())
"""
from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError, get_env, make_lock
from ..faults.retry import Backoff, RestartWindow
from ..faults.supervisor import _trace_instant

__all__ = ["FleetSupervisor", "FleetStats", "free_port"]

_POLL_S = 0.05


def free_port() -> int:
    """An OS-allocated free TCP port (each attempt gets a fresh
    coordinator port so a lingering socket from the killed fleet can
    never wedge the next rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class FleetStats:
    """Restart/recovery counters for one fleet; one row (kind
    ``fleet``) in ``mx.profiler.faults_report()``."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("dist.fleet")
        self._c: Dict = {
            "attempts": 0, "restarts": 0, "lost_hosts": 0,
            "gave_up": False, "backoff_wait_s": 0.0, "recovery_s": 0.0,
            "last_recovery_s": 0.0, "last_rc": None, "last_nworkers": 0,
            "run_s": 0.0,
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
        out["kind"] = "fleet"
        for k in ("backoff_wait_s", "recovery_s", "last_recovery_s",
                  "run_s"):
            out[k] = round(out[k], 4)
        return out

    def report_str(self) -> str:
        r = self.report()
        return ("fleet %r: %d attempts, %d restarts, %d hosts lost%s\n"
                "  %d workers last; backoff wait %.2fs total; recovery "
                "%.2fs last / %.2fs total; last rc=%s; wall %.2fs"
                % (self.name, r["attempts"], r["restarts"],
                   r["lost_hosts"], " (GAVE UP)" if r["gave_up"] else "",
                   r["last_nworkers"], r["backoff_wait_s"],
                   r["last_recovery_s"], r["recovery_s"], r["last_rc"],
                   r["run_s"]))


class FleetSupervisor:
    """Bounded-retry watchdog over an N-worker collective fleet (see
    module docstring).

    Parameters
    ----------
    target : argv list
        What every worker runs (argv mode only: each rank must be a
        fresh process with its own CUDA context).  Rank identity arrives
        through the launcher's envs.
    nworkers : int
        Fleet size for the first attempt.
    on_loss : "rejoin" | "shrink"
        Re-form at full strength (the lost rank rejoins from the commit
        store) or one host smaller (elastic remesh; never below
        ``min_workers``).
    min_workers : int
        Floor for ``on_loss="shrink"`` (default 1).
    max_restarts / restart_window_s / backoff / timeout_s /
    checkpoint_dir / env / success_codes
        As :class:`~mxnet_tpu.faults.Supervisor` — the budget counts
        FLEET restarts over a sliding window; ``checkpoint_dir``
        enables the commit-based ``recovery_s`` watch; ``timeout_s``
        SIGKILLs a fleet whose attempt outlives it (hang detection —
        a wedged collective never exits on its own).
    """

    def __init__(self, target: Sequence[str], nworkers: int, *,
                 on_loss: str = "rejoin", min_workers: int = 1,
                 max_restarts: Optional[int] = None,
                 restart_window_s: Optional[float] = None,
                 backoff: Optional[Backoff] = None,
                 timeout_s: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 success_codes=(0,), name: str = "fleet"):
        if callable(target) or not isinstance(target, (list, tuple)):
            raise MXNetError(
                "FleetSupervisor target must be an argv list (every rank "
                "needs a fresh process with its own CUDA context), got %r"
                % (target,))
        if on_loss not in ("rejoin", "shrink"):
            raise MXNetError("on_loss must be 'rejoin' or 'shrink', got %r"
                             % (on_loss,))
        if int(nworkers) < 1:
            raise MXNetError("nworkers must be >= 1, got %r" % (nworkers,))
        self.target = list(target)
        self.nworkers = int(nworkers)
        self.on_loss = on_loss
        self.min_workers = max(1, int(min_workers))
        if max_restarts is None:
            max_restarts = get_env("MXNET_DIST_FLEET_MAX_RESTARTS", 5, int)
        self.max_restarts = max(0, int(max_restarts))
        if restart_window_s is None:
            restart_window_s = get_env("MXNET_DIST_FLEET_WINDOW_S",
                                       3600.0, float)
        self.restart_window_s = float(restart_window_s)
        if backoff is None:
            backoff = Backoff(
                base_s=get_env("MXNET_DIST_FLEET_BACKOFF_S", 0.5, float),
                factor=2.0, max_s=30.0, jitter=0.5, seed=0, name="fleet")
        self.backoff = backoff
        self.timeout_s = timeout_s
        self.checkpoint_dir = checkpoint_dir
        self.env = dict(env or {})
        self.success_codes = set(success_codes)
        self.name = name
        self.stats = FleetStats(name)
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

    def _spawn_fleet(self, attempt: int) -> List[subprocess.Popen]:
        port = free_port()
        base = dict(os.environ)
        base.update(self.env)
        base["MXNET_TPU_COORDINATOR"] = "127.0.0.1:%d" % port
        base["MXNET_TPU_NUM_WORKERS"] = str(self.nworkers)
        base["MXNET_FAULTS_ATTEMPT"] = str(attempt)
        procs = []
        for rank in range(self.nworkers):
            env = dict(base)
            env["MXNET_TPU_WORKER_ID"] = str(rank)
            procs.append(subprocess.Popen(list(self.target), env=env))
        return procs

    def _kill_fleet(self, procs: List[subprocess.Popen]) -> None:
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except Exception:
                    pass
        deadline = time.perf_counter() + 5.0
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.0,
                                       deadline - time.perf_counter()))
                except Exception:
                    pass
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                    p.wait(timeout=10.0)
                except Exception:
                    pass

    def _attempt(self, attempt: int, watch_from: int,
                 died_t: Optional[float]) -> Tuple[int, bool]:
        """Run one fleet to completion; returns ``(rc, recovered)``.
        Success = every rank exits with a success code; the first
        non-success exit takes the fleet down (kill the survivors —
        they are wedged in a collective that will never complete)."""
        procs = self._spawn_fleet(attempt)
        self.stats.add(attempts=1, last_nworkers=self.nworkers)
        t0 = time.perf_counter()
        recovered = died_t is None
        next_ckpt_poll = 0.0
        pending = list(procs)
        rc = 0
        while True:
            for p in list(pending):
                prc = p.poll()
                if prc is None:
                    continue
                pending.remove(p)
                if prc not in self.success_codes:
                    # one host down = the fleet is down: survivors are
                    # blocked inside a collective missing a participant
                    self.stats.add(lost_hosts=1)
                    self._kill_fleet(pending)
                    return prc, recovered and died_t is not None
            now = time.perf_counter()
            if not recovered and now >= next_ckpt_poll:
                next_ckpt_poll = now + 0.25
                if self._latest_step() > watch_from:
                    dt = now - died_t
                    self.stats.add(recovery_s=dt, last_recovery_s=dt)
                    _trace_instant("fault:fleet_recovered", cat="faults",
                                   attempt=attempt,
                                   nworkers=self.nworkers,
                                   recovery_s=round(dt, 4))
                    recovered = True
            if not pending:
                if not recovered and rc in self.success_codes \
                        and died_t is not None:
                    dt = time.perf_counter() - died_t
                    self.stats.add(recovery_s=dt, last_recovery_s=dt)
                    recovered = True
                return rc, recovered and died_t is not None
            if self._stopping:
                self._kill_fleet(pending)
                return -9, recovered and died_t is not None
            if self.timeout_s is not None and now - t0 > self.timeout_s:
                self._kill_fleet(pending)
                return -9, recovered and died_t is not None
            time.sleep(_POLL_S)

    # -- the loop ----------------------------------------------------------
    def stop(self) -> None:
        """Ask a concurrent :meth:`run` to wind down: the current fleet
        is killed, backoff waits are cut short, run() returns without
        further restarts."""
        self._stopping = True

    def run(self) -> int:
        """Run fleet attempts until one finishes clean (every rank
        exits a success code); returns that code.  Raises
        :class:`MXNetError` when the in-window restart budget is
        exhausted."""
        t_run = time.perf_counter()
        attempt = 0
        window = RestartWindow(self.max_restarts, self.restart_window_s)
        died_t: Optional[float] = None
        watch_from = self._latest_step()
        try:
            while True:
                rc, recovered = self._attempt(attempt, watch_from,
                                              died_t)
                self.stats.add(last_rc=rc)
                if recovered:
                    self.backoff.reset()
                if rc in self.success_codes or self._stopping:
                    return rc
                died_t = time.perf_counter()
                watch_from = self._latest_step()
                if self.on_loss == "shrink" \
                        and self.nworkers > self.min_workers:
                    self.nworkers -= 1
                in_window = window.note()
                if in_window > self.max_restarts:
                    self.stats.add(gave_up=True)
                    raise MXNetError(
                        "fleet %r: lost a host %d times within %.0fs "
                        "(restart budget %d, MXNET_DIST_FLEET_MAX_"
                        "RESTARTS over MXNET_DIST_FLEET_WINDOW_S); last "
                        "exit code %s — the fleet is not recovering, "
                        "stop re-forming it"
                        % (self.name, in_window, self.restart_window_s,
                           self.max_restarts, rc))
                wait = self.backoff.next_wait()
                _trace_instant("fault:fleet_restart", cat="faults",
                               attempt=attempt, rc=rc,
                               nworkers=self.nworkers,
                               wait_s=round(wait, 4))
                attempt += 1
                self.stats.add(restarts=1, backoff_wait_s=wait)
                self.backoff.sleep(wait,
                                   should_stop=lambda: self._stopping)
        finally:
            self.stats.add(run_s=time.perf_counter() - t_run)
