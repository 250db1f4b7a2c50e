"""ServeRouter: a front door spreading load across replica engines
(counterpart of ``mxnet_tpu/serve/router.py``).

The router

* **dispatches by queue depth**: each request goes to the live replica
  with the least work in flight (outstanding + queued);
* **routes around overload**: a replica whose bounded queue rejects is
  skipped and the next-least-loaded one tried; only when every live
  replica rejects does the caller see ``ServeOverloadError``;
* **tracks health**: engine-side failures count per replica; at
  ``MXNET_SERVE_ROUTER_UNHEALTHY`` consecutive failures the replica goes
  ``down``.  A failed request is re-dispatched to another replica under
  a retry budget (``MXNET_SERVE_ROUTER_RETRIES``) with deterministic
  jittered backoff (``faults.Backoff``) before the client sees the error;
* **heals itself**: after a backed-off probe interval
  (``MXNET_SERVE_ROUTER_PROBE_S``) the breaker goes half-open: one live
  request probes the down replica; success reinstates it, failure
  re-trips it with a doubled interval, and the probe request itself
  retries on a healthy replica;
* **restarts without dropping**: ``restart(i)`` drains the replica (no
  new dispatch; its in-flight futures resolve on the old engine), then
  hot-swaps weights (``reload=``) or rebuilds it through the factory
  before closing the old engine, and puts it back in rotation;
  ``rolling_restart()`` does this to every replica in turn.

::

    router = mx.serve.ServeRouter(
        lambda i: PagedDecodeEngine(params, cfg, name="rep%d" % i),
        replicas=2)
    fut = router.submit(prompt_ids)
    router.rolling_restart()
    print(mx.profiler.serve_report_str())
    router.close()

``capture=`` takes any object with ``offer(data, result)``: every
successful request is queued for it and offered on the router's own
drain thread (``online.CaptureWriter`` is one).  The breaker's moves are
trace instants (``serve:router_probe``, ``_probe_up``, ``_probe_fail``,
``_down``, ``_drain``) and each restart a ``serve:router_restart`` span.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from .. import trace as _trace
from ..base import get_env, make_condition
from ..faults import InjectedFault
from ..faults.retry import Backoff
from .batcher import _set_exception, _set_result
from .errors import (ServeClosedError, ServeDeadlineError, ServeError,
                     ServeOverloadError, ServeRequestError,
                     ServeUnavailableError)

__all__ = ["ServeRouter", "RouterStats"]

LIVE, DRAINING, DOWN = "live", "draining", "down"

# drain poll bound: wakes also arrive via the cv notify in _on_done, so
# this only bounds shutdown/timeout latency
_IDLE_WAIT_S = 0.05

# a dispatched probe whose future never settles (a down replica that
# accepts but wedges) is reclaimed after this long so the breaker can
# keep probing instead of freezing open
_PROBE_STALE_S = 30.0


class RouterStats:
    """Router counters + per-replica rollup: one row in
    ``mx.profiler.serve_report()`` (kind "router")."""

    def __init__(self, name: str, router: "ServeRouter"):
        self.name = name
        import weakref
        self._router = weakref.ref(router)

    def report(self) -> Dict:
        r = self._router()
        if r is None:
            return {"kind": "router", "closed": True}
        return r._report()

    def report_str(self) -> str:
        r = self._router()
        if r is None:
            return "serve router (closed)"
        return r._report_str()


class _Replica:
    __slots__ = ("index", "engine", "state", "outstanding", "dispatched",
                 "failures", "restarts", "probe_at", "probe_inflight",
                 "probe_backoff", "probe_gen", "probes", "reinstated")

    def __init__(self, index: int, engine, probe_base_s: float):
        self.index = index
        self.engine = engine
        self.state = LIVE
        self.outstanding = 0        # dispatched via the router, unresolved
        self.dispatched = 0
        self.failures = 0           # consecutive engine-side failures
        self.restarts = 0
        # half-open circuit breaker (see module docstring): while DOWN,
        # probe_at is the perf_counter after which ONE request may be
        # routed here as a probe; the interval backs off per re-trip
        self.probe_at: Optional[float] = None
        self.probe_inflight = False
        self.probe_backoff = Backoff(
            base_s=probe_base_s, factor=2.0, max_s=30.0, jitter=0.25,
            seed=[977, index], name="router.probe")
        # generation token: a reclaimed-stale probe's future that
        # settles LATE carries an old gen and must not touch the
        # breaker (at most one live probe decides its state)
        self.probe_gen = 0
        self.probes = 0
        self.reinstated = 0


class ServeRouter:
    """Queue-depth/health-aware dispatch over replica engines (see
    module docstring).

    Parameters
    ----------
    factory : callable(index) -> engine
        Builds replica ``i``; also used by ``restart`` to rebuild.  Any
        engine with ``submit / pending_requests / outstanding / close``
        qualifies (ServeEngine, DecodeEngine).
    replicas : int
        How many replicas to build at construction.
    unhealthy_after : int
        Consecutive engine-side failures that take a replica out of
        rotation (``MXNET_SERVE_ROUTER_UNHEALTHY``, default 3; 0
        disables).
    retries : int
        Retry budget: how many times a failed request is re-dispatched
        to another replica before the client sees the failure
        (``MXNET_SERVE_ROUTER_RETRIES``, default 2; 0 disables), with
        jittered backoff between attempts (base
        ``MXNET_SERVE_ROUTER_RETRY_MS``, default 2ms, factor 2, capped
        50ms — short enough for a completion-thread wait, long enough
        to ride out a replica's draining hiccup).
    probe_after_s : float
        Half-open breaker base interval: how long a freshly tripped
        replica stays down before one live request probes it
        (``MXNET_SERVE_ROUTER_PROBE_S``, default 1.0; the interval
        doubles per failed probe, caps at 30s; 0 disables probing —
        a down replica then waits for an operator ``restart()``).
        Probing drafts a real request and relies on the retry budget
        to shield that client, so it is also disabled when
        ``retries`` is 0.
    capture : object with ``offer(data, result)``
        Optional request/response capture sampler (the online-training
        loop's intake in the JAX package): every SUCCESSFUL request
        is offered as ``capture.offer(data, result)``.  The completion
        path only ENQUEUES the pair (one lock + append); a dedicated
        capture thread drains the queue and pays the sampling/spill
        cost, so capture stays off the serving path.  By the time a
        client's ``result()`` returns, its pair is queued — so queue
        order is completion order, and :meth:`capture_sync` (or
        :meth:`close`) is a barrier after which every completed
        request has been offered.  Capture failures are counted
        (``capture_errors``), never surfaced to clients.
    """

    def __init__(self, factory: Callable[[int], object], replicas: int = 2,
                 *, unhealthy_after: Optional[int] = None,
                 retries: Optional[int] = None,
                 probe_after_s: Optional[float] = None,
                 capture=None, name: str = "router"):
        if replicas < 1:
            raise ServeError("replicas must be >= 1, got %d" % replicas)
        if unhealthy_after is None:
            unhealthy_after = get_env("MXNET_SERVE_ROUTER_UNHEALTHY", 3, int)
        self.unhealthy_after = max(0, int(unhealthy_after))
        if retries is None:
            retries = get_env("MXNET_SERVE_ROUTER_RETRIES", 2, int)
        self.retries = max(0, int(retries))
        if probe_after_s is None:
            probe_after_s = get_env("MXNET_SERVE_ROUTER_PROBE_S", 1.0,
                                    float)
        self.probe_after_s = max(0.0, float(probe_after_s))
        self._retry_base_s = max(
            0.0, get_env("MXNET_SERVE_ROUTER_RETRY_MS", 2.0, float) / 1e3)
        self._retry_seed = itertools.count()
        self.name = name
        self._factory = factory
        self.capture = capture
        self._cv = make_condition("serve.router")
        self._closed = False
        self._rejected = 0
        self._captured = 0
        self._capture_errors = 0
        self._retried = 0
        self._retry_wait_s = 0.0
        self._drains = 0
        self._downs = 0
        self._probes = 0
        self._reinstated = 0
        self._capture_cv = make_condition("serve.router.capture")
        self._capture_q = collections.deque()
        self._capture_busy = False
        self._capture_thread = None
        self._replicas: List[_Replica] = []
        try:
            for i in range(int(replicas)):
                self._replicas.append(
                    _Replica(i, factory(i), self.probe_after_s or 1.0))
        except BaseException:
            for rep in self._replicas:
                try:
                    rep.engine.close(drain=False)
                except Exception:
                    pass
            raise
        self.stats = RouterStats(name, self)
        if self.capture is not None:
            self._capture_thread = threading.Thread(
                target=self._capture_drain_loop,
                name="%s-capture" % name, daemon=True)
            self._capture_thread.start()
        from .. import profiler
        profiler.register_serve_stats(self.stats)

    # -- dispatch ----------------------------------------------------------
    def _load(self, rep: _Replica) -> int:
        try:
            return rep.outstanding + rep.engine.pending_requests()
        except Exception:
            return 1 << 30

    def _pick_locked(self, exclude):
        """-> (replica, is_probe).  Least-loaded live replica not in
        ``exclude`` — unless a DOWN replica's half-open probe timer has
        expired, in which case THAT replica gets this one request as
        its probe (at most one in flight; the retry budget shields the
        client if the probe fails)."""
        # probing drafts a real client request, and the retry budget is
        # what shields that client from a failing probe — with no
        # budget, probing would break the "clients never pay for
        # probing" contract, so it requires retries >= 1
        if self.probe_after_s > 0 and self.retries > 0:
            now = time.perf_counter()
            for r in self._replicas:
                if r.probe_inflight and r.probe_at is not None \
                        and now - r.probe_at > _PROBE_STALE_S:
                    # the probe's future never settled (a down replica
                    # that accepts but wedges): reclaim the breaker so
                    # probing can continue — counts as a failed probe,
                    # and the gen bump invalidates the wedged future's
                    # eventual late outcome
                    self._probe_result_locked(r, False, r.probe_gen)
                    r.probe_gen += 1
                if (r.state == DOWN and not r.probe_inflight
                        and r.index not in exclude
                        and r.probe_at is not None and now >= r.probe_at):
                    r.probe_inflight = True
                    r.probe_at = now        # stale-probe watermark
                    r.probe_gen += 1
                    r.probes += 1
                    self._probes += 1
                    _trace.instant("serve:router_probe", cat="serve",
                                   replica=r.index)
                    return r, True
        live = [r for r in self._replicas
                if r.state == LIVE and r.index not in exclude]
        if not live:
            return None, False
        return min(live, key=self._load), False

    def _probe_result_locked(self, rep: _Replica, ok,
                             gen: Optional[int] = None) -> None:
        """Half-open probe outcome (cv held): True reinstates the
        replica, False re-trips it with a doubled interval, None
        (client-side outcome — cancel, deadline, malformed request:
        says nothing about replica health) re-arms the CURRENT
        interval without advancing the backoff.  ``gen`` is the probe
        generation the outcome belongs to: a reclaimed-stale probe's
        future settling late must not touch the breaker."""
        if gen is not None and gen != rep.probe_gen:
            return
        rep.probe_inflight = False
        if rep.state != DOWN:       # restarted/reinstated underneath
            return
        if ok is True:
            rep.state = LIVE
            rep.failures = 0
            rep.probe_backoff.reset()
            rep.probe_at = None
            rep.reinstated += 1
            self._reinstated += 1
            _trace.instant("serve:router_probe_up", cat="serve",
                           replica=rep.index)
        elif ok is False:
            rep.probe_at = time.perf_counter() \
                + rep.probe_backoff.next_wait()
            _trace.instant("serve:router_probe_fail", cat="serve",
                           replica=rep.index)
        else:
            rep.probe_at = time.perf_counter() + rep.probe_backoff.peek()

    def submit(self, data, deadline_ms: Optional[float] = None,
               **kwargs) -> Future:
        """Dispatch one request; returns a router-owned Future.  Raises
        ServeUnavailableError when no replica is live,
        ServeOverloadError when every live replica's queue rejects;
        replica-side failures are retried on another replica before
        they reach this future."""
        rfut: Future = Future()
        self._dispatch(rfut, data, deadline_ms, kwargs, tried=set(),
                       retries_left=self.retries)
        return rfut

    def predict(self, data, timeout: Optional[float] = None, **kwargs):
        """Blocking one-shot: submit + result."""
        return self.submit(data, **kwargs).result(timeout=timeout)

    def _dispatch(self, rfut: Future, data, deadline_ms, kwargs,
                  tried, retries_left: int,
                  backoff: Optional[Backoff] = None) -> None:
        """Place the request on the best available replica; on overload
        walk the remaining live replicas.  Raises into the CALLER when
        nothing accepted and ``rfut`` was never dispatched; replica
        failures after acceptance retry via the done callback."""
        overloads = 0
        last_exc = None
        relaxed = False
        while True:
            with self._cv:
                if self._closed:
                    raise ServeClosedError(
                        "serve router %r is closed" % self.name)
                rep, is_probe = self._pick_locked(tried)
                if rep is None and tried and not relaxed \
                        and any(r.state == LIVE for r in self._replicas):
                    # the exclusion set (a just-failed replica, an
                    # earlier overload) ate every live replica: retrying
                    # an excluded LIVE replica beats failing the client
                    # — relax once and re-pick
                    relaxed = True
                    tried.clear()
                    continue
                if rep is None:
                    self._rejected += 1
                    if overloads:
                        raise ServeOverloadError(
                            "every live replica's queue is full "
                            "(%d rejected this dispatch): shed load or "
                            "add replicas" % overloads)
                    if last_exc is not None:
                        raise last_exc
                    raise ServeUnavailableError(
                        "no live replica (states: %s) — all draining/"
                        "down; restart or add replicas"
                        % [r.state for r in self._replicas])
                probe_gen = rep.probe_gen if is_probe else None
                rep.outstanding += 1    # reserve before releasing the lock
            try:
                efut = rep.engine.submit(data, deadline_ms=deadline_ms,
                                         **kwargs)
            except ServeOverloadError:
                with self._cv:
                    rep.outstanding -= 1
                    if is_probe:    # a probe that can't even queue
                        self._probe_result_locked(rep, False, probe_gen)
                    self._cv.notify_all()
                tried.add(rep.index)
                overloads += 1
                continue
            except ServeRequestError:
                # the request itself is malformed: no replica will take
                # it — the caller's problem, not the replica's
                with self._cv:
                    rep.outstanding -= 1
                    if is_probe:
                        self._probe_result_locked(rep, None, probe_gen)
                    self._cv.notify_all()
                raise
            except (ServeError, InjectedFault) as e:
                # replica broken at submit time (closed underneath,
                # wedged, chaos-injected): health-count it and walk on
                with self._cv:
                    rep.outstanding -= 1
                    if is_probe:
                        self._probe_result_locked(rep, False, probe_gen)
                    self._note_failure_locked(rep)
                    self._cv.notify_all()
                tried.add(rep.index)
                last_exc = e
                continue
            except BaseException:
                with self._cv:
                    rep.outstanding -= 1
                    if is_probe:
                        self._probe_result_locked(rep, None, probe_gen)
                    self._cv.notify_all()
                raise
            with self._cv:
                rep.dispatched += 1
            efut.add_done_callback(
                lambda f, rep=rep, is_probe=is_probe,
                probe_gen=probe_gen: self._on_done(
                    f, rep, rfut, data, deadline_ms, kwargs, tried,
                    retries_left, is_probe, probe_gen, backoff))
            return

    def _note_failure_locked(self, rep: _Replica) -> None:
        """Health policy, ONE implementation (cv held): submit-time and
        future-time failures must agree on when a replica goes down.
        Tripping arms the half-open probe timer."""
        rep.failures += 1
        if (self.unhealthy_after and rep.state == LIVE
                and rep.failures >= self.unhealthy_after):
            rep.state = DOWN
            self._downs += 1
            if self.probe_after_s > 0:
                rep.probe_at = time.perf_counter() \
                    + rep.probe_backoff.next_wait()
            _trace.instant("serve:router_down", cat="serve",
                           replica=rep.index)

    def _retryable(self, exc: BaseException) -> bool:
        """Engine-side failures worth another replica: a closed or
        broken replica, or a chaos-injected fault.  Client-side
        outcomes (deadline, malformed request) and overload (handled
        at dispatch) are final."""
        if isinstance(exc, (ServeDeadlineError, ServeRequestError,
                            ServeOverloadError)):
            return False
        return isinstance(exc, (ServeClosedError, ServeError,
                                InjectedFault))

    def _on_done(self, efut: Future, rep: _Replica, rfut: Future, data,
                 deadline_ms, kwargs, tried, retries_left: int,
                 is_probe: bool = False, probe_gen: Optional[int] = None,
                 backoff: Optional[Backoff] = None) -> None:
        exc = efut.exception() if not efut.cancelled() else None
        engine_fail = exc is not None and self._retryable(exc)
        with self._cv:
            rep.outstanding -= 1
            if is_probe:
                if exc is None and not efut.cancelled():
                    self._probe_result_locked(rep, True, probe_gen)
                elif engine_fail:
                    self._probe_result_locked(rep, False, probe_gen)
                else:
                    self._probe_result_locked(rep, None, probe_gen)
            if engine_fail:
                self._note_failure_locked(rep)
            elif exc is None and not efut.cancelled():
                rep.failures = 0
            self._cv.notify_all()       # drain waiters watch outstanding
        if efut.cancelled():
            rfut.cancel()
            return
        if exc is None:
            result = efut.result()
            # enqueue BEFORE the client future settles: once result()
            # returns, the pair is in the queue, so capture_sync()/
            # close() see every completed request
            if self.capture is not None:
                # append only — no notify: waking the capture thread
                # per request would put a context switch on every
                # completion; it polls at _IDLE_WAIT_S and drains in
                # batches instead
                with self._capture_cv:
                    self._capture_q.append((rep, data, result))
            _set_result(rfut, result)
            return
        if engine_fail and retries_left > 0 and not self._closed:
            if backoff is None:
                # one jittered schedule per request's retry chain —
                # concurrent failures fan back in de-synchronized
                backoff = Backoff(base_s=self._retry_base_s, factor=2.0,
                                  max_s=0.05, jitter=0.5,
                                  seed=next(self._retry_seed),
                                  name="router.retry")
            with self._cv:
                self._retried += 1
            if self._retry_base_s > 0:
                wait = backoff.next_wait()
                with self._cv:
                    self._retry_wait_s += wait
                time.sleep(wait)        # bounded: max_s caps at 50ms
            try:
                # fresh exclusion set: only the replica that just failed
                # is off-limits — an earlier transient overload on
                # another replica must not shrink the retry's options
                self._dispatch(rfut, data, deadline_ms, kwargs,
                               {rep.index}, retries_left - 1, backoff)
                return
            except Exception as redispatch_exc:
                exc = redispatch_exc
        _set_exception(rfut, exc)

    def _capture_drain_loop(self) -> None:
        """The capture thread: drains queued pairs into the sampler.
        Exits when the router is closed AND the queue is empty, so
        every pair enqueued before close() is still offered."""
        while True:
            with self._capture_cv:
                if not self._capture_q:
                    if self._closed:
                        return
                    self._capture_cv.wait(_IDLE_WAIT_S)
                    if not self._capture_q:
                        continue
                batch = list(self._capture_q)
                self._capture_q.clear()
                self._capture_busy = True
            try:
                for rep, data, result in batch:
                    self._offer_capture(rep, data, result)
            finally:
                with self._capture_cv:
                    self._capture_busy = False
                    self._capture_cv.notify_all()

    def _offer_capture(self, rep: _Replica, data, result) -> None:
        """Feed a served pair to the capture sampler (capture thread
        only).  A capture failure is counted here and remembered by the
        writer (its flush() re-raises), so the serving path never
        breaks but the online loop still dies loud on a torn shard."""
        try:
            kept = self.capture.offer(data, result)
        except Exception:
            with self._cv:
                self._capture_errors += 1
            return
        if not kept:
            return
        with self._cv:
            self._captured += 1
        # mirror onto the replica's engine stats so the sampled rate is
        # verifiable from serve_report() (captured / completed)
        st = getattr(rep.engine, "stats", None)
        fn = getattr(st, "on_captured", None)
        if fn is not None:
            fn()

    def capture_sync(self, timeout: Optional[float] = None) -> None:
        """Barrier: wait until every pair enqueued so far has been
        offered to the capture sampler.  Because completions enqueue
        before the client future settles, calling this after the last
        ``result()`` guarantees the writer saw the whole flood.
        Raises ServeError on timeout."""
        if self.capture is None:
            return
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        with self._capture_cv:
            while self._capture_q or self._capture_busy:
                wait = _IDLE_WAIT_S
                if deadline is not None:
                    wait = min(wait, deadline - time.perf_counter())
                    if wait <= 0:
                        raise ServeError(
                            "capture_sync timed out with %d pair(s) "
                            "pending" % len(self._capture_q))
                self._capture_cv.wait(wait)

    # -- draining restart --------------------------------------------------
    def drain(self, index: int, timeout: Optional[float] = None) -> None:
        """Take replica ``index`` out of rotation and wait until its
        in-flight work resolves (new traffic rides the other
        replicas).  On timeout the replica STAYS out of rotation
        (state ``draining``) — a drain that cannot finish means the
        replica is wedged, and handing it fresh traffic would hang
        clients; retry the restart or rebuild it."""
        rep = self._rep(index)
        with self._cv:
            if rep.state != DRAINING:   # idempotent: restart() after a
                rep.state = DRAINING    # manual drain() just waits
                self._drains += 1
                _trace.instant("serve:router_drain", cat="serve",
                               replica=index)
        deadline = (time.perf_counter() + timeout) if timeout else None
        with self._cv:
            while rep.outstanding > 0 or rep.engine.pending_requests() > 0:
                remaining = _IDLE_WAIT_S if deadline is None \
                    else min(_IDLE_WAIT_S, deadline - time.perf_counter())
                if remaining <= 0:
                    raise ServeError(
                        "replica %d did not drain within %.1fs "
                        "(%d outstanding); it stays out of rotation — "
                        "retry restart() or rebuild it"
                        % (index, timeout, rep.outstanding))
                self._cv.wait(remaining)

    def restart(self, index: int, reload: Optional[Dict] = None,
                factory: Optional[Callable] = None,
                timeout: Optional[float] = None) -> None:
        """Draining restart of one replica, zero dropped requests: drain
        it (see :meth:`drain`), then either hot-swap weights into the
        existing engine (``reload=`` params dict) or close it and
        rebuild via ``factory`` (default: the constructor's, so a
        checkpoint-dir factory redeploys the newest step), then return
        it to rotation with a clean health record."""
        rep = self._rep(index)
        self.drain(index, timeout=timeout)
        try:
            with _trace.span("serve:router_restart", cat="serve",
                             replica=index):
                if reload is not None:
                    rep.engine.reload(reload)
                else:
                    old = rep.engine
                    build = factory if factory is not None \
                        else self._factory
                    # build BEFORE closing the old engine: a failed
                    # build must leave the old replica restorable
                    fresh = build(index)
                    rep.engine = fresh
                    old.close(drain=True)
        finally:
            with self._cv:
                rep.failures = 0
                rep.restarts += 1
                rep.state = LIVE
                # an operator restart is a clean bill of health: the
                # breaker re-arms from its first rung
                rep.probe_inflight = False
                rep.probe_at = None
                rep.probe_backoff.reset()
                self._cv.notify_all()

    def rolling_restart(self, reload: Optional[Dict] = None,
                        factory: Optional[Callable] = None,
                        timeout: Optional[float] = None) -> None:
        """Restart every replica in turn — the zero-downtime deploy."""
        for rep in list(self._replicas):
            self.restart(rep.index, reload=reload, factory=factory,
                         timeout=timeout)

    # -- introspection -----------------------------------------------------
    def _rep(self, index: int) -> _Replica:
        if not 0 <= index < len(self._replicas):
            raise ServeError(
                "replica index %d out of range [0, %d)"
                % (index, len(self._replicas)))
        return self._replicas[index]

    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    def replica_states(self) -> List[str]:
        with self._cv:
            return [r.state for r in self._replicas]

    def replica(self, index: int):
        """The replica's engine (maintenance access; dispatch decisions
        belong to the router)."""
        return self._rep(index).engine

    def _report(self) -> Dict:
        with self._cv:
            reps = list(self._replicas)
            out = {
                "kind": "router",
                "replicas": len(reps),
                "rejected": self._rejected,
                "captured": self._captured,
                "capture_errors": self._capture_errors,
                "retried": self._retried,
                "retry_wait_s": round(self._retry_wait_s, 4),
                "drains": self._drains,
                "downs": self._downs,
                "probes": self._probes,
                "reinstated": self._reinstated,
            }
        per = {}
        agg_submitted = agg_completed = agg_failed = 0
        for r in reps:
            row = {"state": r.state, "dispatched": r.dispatched,
                   "outstanding": r.outstanding, "failures": r.failures,
                   "restarts": r.restarts, "probes": r.probes,
                   "reinstated": r.reinstated}
            st = getattr(r.engine, "stats", None)
            if st is not None:
                erep = st.report()
                row["engine"] = erep
                agg_submitted += erep.get("submitted", 0)
                agg_completed += erep.get("completed", 0)
                agg_failed += erep.get("failed", 0)
            per[r.index] = row
        out["per_replica"] = per
        out["submitted"] = agg_submitted
        out["completed"] = agg_completed
        out["failed"] = agg_failed
        out["capture_rate"] = round(out["captured"] / agg_completed, 4) \
            if agg_completed else 0.0
        return out

    def _report_str(self) -> str:
        r = self._report()
        lines = ["serve router %r" % self.name,
                 "  replicas: %d, %d rejected, %d retried, %d drains, "
                 "%d downs, %d probes (%d reinstated)"
                 % (r["replicas"], r["rejected"], r["retried"],
                    r["drains"], r["downs"], r["probes"],
                    r["reinstated"]),
                 "  rollup: %d submitted / %d completed / %d failed, "
                 "%d captured (rate %.3f, %d capture errors)"
                 % (r["submitted"], r["completed"], r["failed"],
                    r["captured"], r["capture_rate"],
                    r["capture_errors"])]
        for i, row in sorted(r["per_replica"].items()):
            erep = row.get("engine") or {}
            lines.append(
                "  replica %d [%s]: %d dispatched, %d outstanding, "
                "p99 %.2f ms, %d restarts"
                % (i, row["state"], row["dispatched"], row["outstanding"],
                   erep.get("latency_p99_ms", 0.0), row["restarts"]))
        return "\n".join(lines)

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Close every replica.  Idempotent; concurrent closers
        serialize on the replicas' own close locks."""
        with self._cv:
            if self._closed:
                reps = []
            else:
                self._closed = True
                reps = list(self._replicas)
            self._cv.notify_all()
        for rep in reps:
            rep.engine.close(drain=drain)
        t = self._capture_thread
        if t is not None:
            # wake the capture thread; it drains whatever is queued
            # (everything enqueued before close) and exits
            with self._capture_cv:
                self._capture_cv.notify_all()
            t.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
