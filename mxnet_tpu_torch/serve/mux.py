"""ModelMultiplexer: N models sharing one card, memory-aware, LRU-evicted
(counterpart of ``mxnet_tpu/serve/mux.py``).

One engine is one model; production traffic is a catalog of models
whose working set exceeds device memory.  The multiplexer keeps the
catalog behind one ``submit(model, data)`` surface and manages which
models are *live* (device buffers resident) under two budgets:

* ``budget_bytes`` (``MXNET_SERVE_MUX_BYTES``, 0 = unlimited): the sum
  of live engines' measured ``device_bytes()`` must fit;
* ``max_live`` (``MXNET_SERVE_MUX_LIVE``, 0 = unlimited): a live-model
  count cap.

When admitting a model would burst a budget, the least-recently-used
idle live model is evicted: its engine drains (busy models are never
evicted), every reference to it is dropped, and the caching allocator
hands its blocks back to the card (``torch.cuda.empty_cache``), so
``torch.cuda.memory_allocated()`` falls by its footprint.  Swap-in
builds the engine again through the factory.

::

    mux = mx.serve.ModelMultiplexer(budget_bytes=2 << 30)
    mux.add_model("ranker",  lambda: ServeEngine(sym_a, params_a, shapes))
    mux.add_model("lm", lambda: PagedDecodeEngine(params, cfg))
    fut = mux.submit("ranker", x)         # builds "ranker" lazily
    print(mx.profiler.serve_report_str()) # per-model rows + mux counters

The factory contract is any engine exposing ``submit / close /
pending_requests / outstanding / device_bytes / stats``: ServeEngine,
DecodeEngine and PagedDecodeEngine all qualify, so one card multiplexes
batch models and decode models together.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import trace as _trace
from ..base import get_env, make_lock
from .errors import ServeClosedError, ServeError, ServeOverloadError

__all__ = ["ModelMultiplexer", "MuxStats"]


class MuxStats:
    """Multiplexer counters: one row in ``mx.profiler.serve_report()``
    (kind "mux") next to the per-model engine rows."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("serve.stats")
        self._submits: Dict[str, int] = {}
        self._swap_ins = 0
        self._evictions = 0
        self._rejected = 0
        self._live = 0
        self._models = 0
        self._bytes_live = 0
        self._budget_bytes = 0
        self._max_live = 0

    def configure(self, budget_bytes: int, max_live: int) -> None:
        with self._lock:
            self._budget_bytes = int(budget_bytes)
            self._max_live = int(max_live)

    def on_submit(self, model: str) -> None:
        with self._lock:
            self._submits[model] = self._submits.get(model, 0) + 1

    def on_swap_in(self) -> None:
        with self._lock:
            self._swap_ins += 1

    def on_eviction(self) -> None:
        with self._lock:
            self._evictions += 1

    def on_rejected(self) -> None:
        with self._lock:
            self._rejected += 1

    def set_gauges(self, live: int, models: int, bytes_live: int) -> None:
        with self._lock:
            self._live = live
            self._models = models
            self._bytes_live = bytes_live

    def report(self) -> Dict:
        with self._lock:
            return {
                "kind": "mux",
                "models": self._models,
                "live": self._live,
                "bytes_live": self._bytes_live,
                "budget_bytes": self._budget_bytes,
                "max_live": self._max_live,
                "swap_ins": self._swap_ins,
                "evictions": self._evictions,
                "rejected": self._rejected,
                "submits": dict(sorted(self._submits.items())),
            }

    def report_str(self) -> str:
        r = self.report()
        subs = ", ".join("%s:%d" % (m, n)
                         for m, n in r["submits"].items()) or "-"
        budget = ("%.1f MB" % (r["budget_bytes"] / 1e6)
                  if r["budget_bytes"] else "unlimited")
        return ("model multiplexer %r\n"
                "  models: %d registered / %d live "
                "(%.1f MB resident, budget %s, max_live %s)\n"
                "  swap-ins %d, evictions %d, rejected %d\n"
                "  submits: %s" % (
                    self.name, r["models"], r["live"],
                    r["bytes_live"] / 1e6, budget,
                    r["max_live"] or "unlimited",
                    r["swap_ins"], r["evictions"], r["rejected"], subs))


def _close_all(engines: List) -> None:
    """Close evicted engines (draining) and give their device memory
    back: drop the list's references, collect the reference cycles an
    engine keeps (its worker threads, its stats), and empty the caching
    allocator."""
    if not engines:
        return
    while engines:
        engines.pop().close(drain=True)
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


class _Entry:
    __slots__ = ("name", "factory", "engine", "bytes_hint",
                 "measured_bytes", "last_used", "outstanding",
                 "build_lock")

    def __init__(self, name: str, factory: Callable, bytes_hint: int):
        self.name = name
        self.factory = factory
        self.engine = None
        self.bytes_hint = int(bytes_hint)
        self.measured_bytes = 0         # from device_bytes() after build
        self.last_used = time.perf_counter()
        self.outstanding = 0            # reserved + in-flight via mux
        self.build_lock = make_lock("serve.mux_build")

    def cost(self) -> int:
        return self.measured_bytes or self.bytes_hint


class ModelMultiplexer:
    """Multiplex N models on one chip (see module docstring).

    Locking: the table lock covers registry membership, LRU bookkeeping
    and eviction; per-entry build locks cover engine construction so a
    slow swap-in never blocks traffic to already-live models.  The
    build lock is only ever taken with the table lock RELEASED."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 max_live: Optional[int] = None, name: str = "mux"):
        if budget_bytes is None:
            budget_bytes = get_env("MXNET_SERVE_MUX_BYTES", 0, int)
        if max_live is None:
            max_live = get_env("MXNET_SERVE_MUX_LIVE", 0, int)
        self.budget_bytes = max(0, int(budget_bytes))
        self.max_live = max(0, int(max_live))
        self.name = name
        self._lock = make_lock("serve.mux_table")
        self._entries: Dict[str, _Entry] = {}
        self._closed = False
        self.stats = MuxStats(name)
        self.stats.configure(self.budget_bytes, self.max_live)
        from .. import profiler
        profiler.register_serve_stats(self.stats)

    # -- registry ----------------------------------------------------------
    def add_model(self, name: str, factory: Callable,
                  bytes_hint: int = 0) -> None:
        """Register a model.  ``factory()`` builds its engine (called
        lazily, possibly repeatedly after evictions).  ``bytes_hint``
        seeds the admission budget until the first build measures the
        real footprint; with it, a first swap-in evicts before it
        builds."""
        if not callable(factory):
            raise ServeError("factory for model %r must be callable" % name)
        with self._lock:
            if self._closed:
                raise ServeClosedError("multiplexer %r is closed" % self.name)
            if name in self._entries:
                raise ServeError("model %r already registered" % name)
            self._entries[name] = _Entry(name, factory, bytes_hint)
            self._update_gauges_locked()

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def live_models(self) -> List[str]:
        with self._lock:
            return sorted(n for n, e in self._entries.items()
                          if e.engine is not None)

    # -- admission ---------------------------------------------------------
    def _update_gauges_locked(self) -> None:
        live = [e for e in self._entries.values() if e.engine is not None]
        self.stats.set_gauges(len(live), len(self._entries),
                              sum(e.measured_bytes for e in live))

    def _over_budget_locked(self, extra_models: int,
                            extra_bytes: int) -> bool:
        """Would the live set plus a hypothetical extra burst a budget?
        Pre-build the incoming model is (1, cost); post-build it is
        already live and counted, so both extras are 0."""
        live = [e for e in self._entries.values() if e.engine is not None]
        if self.max_live and len(live) + extra_models > self.max_live:
            return True
        if self.budget_bytes and \
                sum(e.cost() for e in live) + extra_bytes \
                > self.budget_bytes:
            return True
        return False

    def _pop_victim_locked(self, protect: _Entry):
        """Detach the least-recently-used IDLE live model's engine
        (never the one being admitted, never one with outstanding
        requests) and return it for the CALLER to close with the table
        lock released — joining the victim's worker threads under the
        lock would stall traffic to every other model.  Detaching under
        the lock is what makes this safe: once ``entry.engine`` is
        None, no mux-routed submit can reach the old engine (a racing
        ``_acquire`` rebuilds), and idle means nothing is in flight.
        Returns None when nothing is evictable."""
        victims = [e for e in self._entries.values()
                   if e.engine is not None and e is not protect
                   and e.outstanding == 0
                   and e.engine.pending_requests() == 0]
        if not victims:
            return None
        victim = min(victims, key=lambda e: e.last_used)
        eng = victim.engine
        victim.engine = None
        self.stats.on_eviction()
        _trace.instant("serve:mux_evict", cat="serve", model=victim.name)
        self._update_gauges_locked()
        return eng

    def ensure_live(self, model: str):
        """The engine for ``model``, building it (and evicting idle LRU
        models to make room) if needed.  Public so callers can prewarm.
        Does NOT reserve the engine — use ``submit`` for traffic."""
        entry, engine = self._acquire(model)
        self._release(entry)
        return engine

    def prewarm(self, models: Optional[List[str]] = None) -> None:
        """Build the given (default: all) models' engines now, in
        registration order, honoring the budgets."""
        for m in (models if models is not None else self.models()):
            self.ensure_live(m)

    def _acquire(self, model: str):
        """(entry, engine) with entry.outstanding reserved (+1): the
        entry cannot be evicted until ``_release``."""
        with self._lock:
            if self._closed:
                raise ServeClosedError("multiplexer %r is closed" % self.name)
            entry = self._entries.get(model)
            if entry is None:
                raise ServeError(
                    "unknown model %r (registered: %s)"
                    % (model, sorted(self._entries)))
            entry.last_used = time.perf_counter()
            entry.outstanding += 1      # reserve: not evictable from here
            if entry.engine is not None:
                return entry, entry.engine
        try:
            return entry, self._build(entry)
        except BaseException:
            self._release(entry)
            raise

    def _release(self, entry: _Entry) -> None:
        with self._lock:
            entry.outstanding = max(0, entry.outstanding - 1)
            entry.last_used = time.perf_counter()

    def _build(self, entry: _Entry):
        """Swap a model in: make room under the budgets, run the
        factory (table lock released — live models keep serving), then
        measure the real footprint."""
        with entry.build_lock:
            to_close = []
            try:
                with self._lock:
                    if entry.engine is not None:  # lost the build race
                        return entry.engine
                    if self.budget_bytes and \
                            entry.cost() > self.budget_bytes:
                        # no amount of eviction can fit it: reject
                        # BEFORE trashing the warm live set
                        self.stats.on_rejected()
                        raise ServeOverloadError(
                            "model %r alone (%.1f MB) exceeds the "
                            "multiplexer budget (%.1f MB): raise "
                            "MXNET_SERVE_MUX_BYTES"
                            % (entry.name, entry.cost() / 1e6,
                               self.budget_bytes / 1e6))
                    while self._over_budget_locked(1, entry.cost()):
                        eng = self._pop_victim_locked(entry)
                        if eng is None:
                            live = [e for e in self._entries.values()
                                    if e.engine is not None]
                            self.stats.on_rejected()
                            raise ServeOverloadError(
                                "cannot admit model %r: live working set "
                                "is at budget (%d live, %.1f MB, budget "
                                "%s MB / max_live %s) and every live "
                                "model is busy — shed load or raise "
                                "MXNET_SERVE_MUX_BYTES"
                                % (entry.name, len(live),
                                   sum(e.measured_bytes
                                       for e in live) / 1e6,
                                   "%.1f" % (self.budget_bytes / 1e6)
                                   if self.budget_bytes else "unlimited",
                                   self.max_live or "unlimited"))
                        to_close.append(eng)
                        eng = None
            finally:
                # lock released: traffic to the other models keeps
                # flowing while the victims drain
                _close_all(to_close)
            with _trace.span("serve:mux_swap_in", cat="serve",
                             model=entry.name):
                engine = entry.factory()
            for attr in ("submit", "close", "pending_requests",
                         "outstanding", "device_bytes", "stats"):
                if not hasattr(engine, attr):
                    try:
                        engine.close()
                    except Exception:
                        pass
                    raise ServeError(
                        "factory for model %r returned %r without the "
                        "engine surface (missing %r)"
                        % (entry.name, type(engine).__name__, attr))
            to_close = []
            with self._lock:
                admitted = not self._closed
                if admitted:
                    entry.engine = engine
                    entry.measured_bytes = int(engine.device_bytes())
                    self.stats.on_swap_in()
                    self._update_gauges_locked()
                    # the measured footprint may exceed the hint:
                    # rebalance by evicting idle LRU models until back
                    # under budget (the fresh model is protected)
                    while self._over_budget_locked(0, 0):
                        eng = self._pop_victim_locked(entry)
                        if eng is None:
                            break
                        to_close.append(eng)
                        eng = None
            _close_all(to_close)
            if not admitted:
                # a close() landed while the factory ran: the fresh
                # engine must not outlive the multiplexer
                engine.close(drain=False)
                raise ServeClosedError(
                    "multiplexer %r closed while model %r was building"
                    % (self.name, entry.name))
            return engine

    # -- traffic -----------------------------------------------------------
    def submit(self, model: str, data, **kwargs):
        """Route one request to ``model`` (building it if needed);
        returns the engine's Future.  The model counts as busy — and is
        therefore not evictable — until the future resolves."""
        entry, engine = self._acquire(model)
        self.stats.on_submit(model)
        try:
            fut = engine.submit(data, **kwargs)
        except BaseException:
            self._release(entry)
            raise
        fut.add_done_callback(lambda _f: self._release(entry))
        return fut

    def predict(self, model: str, data,
                timeout: Optional[float] = None, **kwargs):
        """Blocking one-shot."""
        return self.submit(model, data, **kwargs).result(timeout=timeout)

    def evict(self, model: str) -> bool:
        """Explicitly evict one model's device buffers (False when it is
        not live or is busy)."""
        with self._lock:
            entry = self._entries.get(model)
            if entry is None:
                raise ServeError("unknown model %r" % model)
            if entry.engine is None:
                return False
            if entry.outstanding or entry.engine.pending_requests():
                return False
            victims = [entry.engine]
            entry.engine = None
            self.stats.on_eviction()
            self._update_gauges_locked()
        _close_all(victims)         # lock released (see _pop_victim_locked)
        return True

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Close every live engine (draining) and refuse new traffic.
        Idempotent."""
        with self._lock:
            if self._closed:
                engines = []
            else:
                self._closed = True
                engines = [e.engine for e in self._entries.values()
                           if e.engine is not None]
                for e in self._entries.values():
                    e.engine = None
                self._update_gauges_locked()
        _close_all(engines)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
