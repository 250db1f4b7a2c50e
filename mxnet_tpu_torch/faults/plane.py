"""Deterministic fault-injection plane (counterpart of
``mxnet_tpu/faults/plane.py``).

Named **fault points** sit at the seams the recovery machinery defends;
in the port, the serving ones: ``serve.dispatch`` (a ServeEngine batch),
``paged.step`` and ``decode.step`` (a decode engine's step)::

    faults.point("decode.step", active=n_active)

With no plan installed a point is one module-global ``is None`` check.
With a plan (:func:`install`, or the ``MXNET_FAULTS`` spec parsed at
import, so child processes inherit it), each hit consults a seeded
per-(rule, point) rng stream: whether invocation N of a point faults,
and with which kind, is a pure function of ``(seed, attempt, rule,
point, N)`` — the same function as the JAX package's, so one spec fires
at the same calls in both packages.

Env spec (``MXNET_FAULTS``)::

    seed=7,rate=0.02,kinds=crash|torn|delay|error
    points=decode.step|serve.dispatch,after=2,max=1
    attempts=0|1,delay_ms=20

Kinds: ``crash`` (SIGKILL the process), ``torn`` (truncate the file the
point's ``path`` ctx names to half, then raise), ``delay`` (sleep
``delay_ms``, then continue), ``error`` (raise :class:`InjectedFault`).

:func:`stats` counts every injection; the first :func:`install`
registers it as the ``plane`` row of ``mx.profiler.faults_report()``.
Every injection is a ``fault:<point>`` trace instant, and every install
a ``fault:install``.
"""
from __future__ import annotations

import os
import signal
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from .. import trace as _trace
from ..base import MXNetError, get_env, make_lock

__all__ = ["InjectedFault", "Rule", "FaultPlan", "FaultStats", "point",
           "install", "clear", "active", "enabled", "attempt",
           "parse_spec", "reload_from_env", "refresh_attempt", "stats",
           "KINDS"]

KINDS = ("crash", "torn", "delay", "error")


class InjectedFault(MXNetError):
    """An injected (not organic) failure from the fault plane."""


class FaultStats:
    """Process-wide injection counters; one row (kind ``plane``) in
    ``mx.profiler.faults_report()``."""

    def __init__(self, name: str = "plane"):
        self.name = name
        self._lock = make_lock("faults.stats")
        self._injected = 0
        self._by_kind: Dict[str, int] = {}
        self._by_point: Dict[str, int] = {}
        self._delay_s = 0.0

    def note(self, pt: str, kind: str, delay_s: float = 0.0) -> None:
        with self._lock:
            self._injected += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            self._by_point[pt] = self._by_point.get(pt, 0) + 1
            self._delay_s += delay_s

    def report(self) -> Dict:
        with self._lock:
            return {"kind": "plane", "enabled": enabled(),
                    "attempt": attempt(), "injected": self._injected,
                    "by_kind": dict(self._by_kind),
                    "by_point": dict(self._by_point),
                    "delay_s": round(self._delay_s, 4)}

    def report_str(self) -> str:
        r = self.report()
        lines = ["fault plane [%s]: %d injected (attempt %d)"
                 % ("on" if r["enabled"] else "off", r["injected"],
                    r["attempt"])]
        if r["by_kind"]:
            lines.append("  kinds:  " + ", ".join(
                "%s=%d" % kv for kv in sorted(r["by_kind"].items())))
        if r["by_point"]:
            lines.append("  points: " + ", ".join(
                "%s=%d" % kv for kv in sorted(r["by_point"].items())))
        return "\n".join(lines)


_STATS = FaultStats()
_registered = False


def stats() -> FaultStats:
    return _STATS


def _register_stats() -> None:
    global _registered
    if _registered:
        return
    _registered = True
    from .. import profiler
    profiler.register_faults_stats(_STATS)


class Rule:
    """One injection rule: which points, which kinds, at what rate.

    Parameters
    ----------
    points : str | list | None
        Point names this rule covers (None = every point); an entry may
        carry ``@stage`` to narrow to hits whose ctx ``stage`` matches.
    kinds : str | sequence
        Fault kinds drawn from on a firing hit (``"crash|torn"`` or a
        list).  The kind choice spends the SAME uniform draw as the
        rate check, so one rng draw fully decides a hit.
    rate : float
        Per-hit fault probability (1.0 = every eligible hit).
    after : int
        Skip the first ``after`` eligible hits per point — "fault on
        the third commit" without racing a rate.
    max_faults : int | None
        Cap on faults this rule injects in this process.
    when : callable(ctx) -> bool | None
        Programmatic guard over the point's ctx kwargs (tests target
        ``stage``/``step`` exactly with this).
    attempts : iterable[int] | None
        Supervisor attempts (``MXNET_FAULTS_ATTEMPT``) the rule is live
        on; None = all.
    delay_s : float
        Sleep for ``delay`` kind faults.
    """

    def __init__(self, points=None, kinds: Sequence = ("error",),
                 rate: float = 1.0, after: int = 0,
                 max_faults: Optional[int] = None,
                 when: Optional[Callable[[Dict], bool]] = None,
                 attempts: Optional[Iterable[int]] = None,
                 delay_s: Optional[float] = None):
        if isinstance(points, str):
            points = [points]
        self.points: Optional[List] = None
        if points is not None:
            self.points = []
            for p in points:
                name, _, stage = str(p).partition("@")
                self.points.append((name, stage or None))
        if isinstance(kinds, str):
            kinds = [k for k in kinds.split("|") if k]
        self.kinds = tuple(kinds)
        for k in self.kinds:
            if k not in KINDS:
                raise MXNetError("unknown fault kind %r (kinds: %s)"
                                 % (k, "|".join(KINDS)))
        if not self.kinds:
            raise MXNetError("a fault Rule needs at least one kind")
        self.rate = float(rate)
        self.after = int(after)
        self.max_faults = max_faults if max_faults is None \
            else int(max_faults)
        self.when = when
        self.attempts = None if attempts is None \
            else {int(a) for a in attempts}
        if delay_s is None:
            delay_s = get_env("MXNET_FAULTS_DELAY_MS", 20.0, float) / 1e3
        self.delay_s = float(delay_s)

    def matches(self, name: str, ctx: Dict, attempt_i: int) -> bool:
        if self.attempts is not None and attempt_i not in self.attempts:
            return False
        if self.points is not None:
            for pname, stage in self.points:
                if pname == name and (stage is None
                                      or ctx.get("stage") == stage):
                    break
            else:
                return False
        if self.when is not None and not self.when(ctx):
            return False
        return True


class _PointState:
    __slots__ = ("count", "fired", "rng")

    def __init__(self, rng):
        self.count = 0
        self.fired = 0
        self.rng = rng


class FaultPlan:
    """An installed set of :class:`Rule`\\ s plus the seeded per-(rule,
    point) decision streams (see module docstring)."""

    def __init__(self, rules: Sequence[Rule] = (), seed: int = 0,
                 name: str = "plan"):
        if isinstance(rules, Rule):
            rules = [rules]
        self.rules = list(rules)
        self.seed = int(seed)
        self.name = name
        self.attempt = attempt()
        self._lock = make_lock("faults.plan")
        self._state: Dict = {}

    def _st(self, idx: int, name: str) -> _PointState:
        key = (idx, name)
        st = self._state.get(key)
        if st is None:
            st = _PointState(np.random.default_rng(
                [self.seed & 0x7fffffff, self.attempt, idx,
                 zlib.crc32(name.encode())]))
            self._state[key] = st
        return st

    def decide(self, name: str, ctx: Dict):
        """-> (rule, kind) for a firing hit, else None.  One uniform
        draw per eligible (rule, point) hit decides both whether and
        which kind — fully deterministic given hit order."""
        with self._lock:
            for idx, rule in enumerate(self.rules):
                if not rule.matches(name, ctx, self.attempt):
                    continue
                st = self._st(idx, name)
                st.count += 1
                if st.count <= rule.after:
                    continue
                if rule.max_faults is not None \
                        and st.fired >= rule.max_faults:
                    continue
                if rule.rate <= 0.0:
                    continue
                u = st.rng.random()
                if u >= rule.rate:
                    continue
                st.fired += 1
                kind = rule.kinds[min(int(u / rule.rate * len(rule.kinds)),
                                      len(rule.kinds) - 1)]
                return rule, kind
        return None


# the installed plan; None = plane disabled (the production state)
_PLAN: Optional[FaultPlan] = None


def enabled() -> bool:
    return _PLAN is not None


def attempt() -> int:
    """The supervisor attempt index this process runs as (0 outside a
    supervisor); folded into every decision stream so a restarted child
    does not replay the exact faults that killed its predecessor unless
    the schedule says so."""
    return get_env("MXNET_FAULTS_ATTEMPT", 0, int)


def point(name: str, **ctx) -> None:
    """Declare a named fault point.  A no-op (one ``is None`` check)
    unless a plan is installed; may sleep (``delay``), raise
    :class:`InjectedFault` (``error``/``torn``) or SIGKILL the process
    (``crash``) per the plan's deterministic schedule."""
    plan = _PLAN
    if plan is None:
        return
    decision = plan.decide(name, ctx)
    if decision is not None:
        _fire(name, decision[1], ctx, decision[0])


def _fire(name: str, kind: str, ctx: Dict, rule: Rule) -> None:
    attrs = {k: v for k, v in ctx.items()
             if isinstance(v, (int, float, str, bool))}
    _trace.instant("fault:" + name, cat="faults", kind=kind, **attrs)
    _STATS.note(name, kind, rule.delay_s if kind == "delay" else 0.0)
    if kind == "delay":
        time.sleep(rule.delay_s)
        return
    if kind == "crash":
        try:        # a killed reader worker's spans must still merge
            _trace.flush_spill()
        except Exception:
            pass
        os.kill(os.getpid(), signal.SIGKILL)
        return      # pragma: no cover — unreachable
    if kind == "torn":
        torn = _tear(ctx.get("path"))
        raise InjectedFault(
            "injected torn write at %r (%s) [faults plane, seed=%d "
            "attempt=%d]" % (name, torn, _PLAN.seed if _PLAN else -1,
                             attempt()))
    raise InjectedFault(
        "injected fault at %r (kind=error, ctx=%r) [faults plane, "
        "seed=%d attempt=%d]"
        % (name, attrs, _PLAN.seed if _PLAN else -1, attempt()))


def _tear(path) -> str:
    """Truncate ``path`` (a file, or the newest file inside a
    directory) to half its bytes — the torn-write simulator."""
    if not path or not os.path.exists(path):
        return "no path to tear"
    target = path
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in os.listdir(path)]
        files = [f for f in files if os.path.isfile(f)]
        if not files:
            return "empty dir %r" % path
        target = max(files, key=os.path.getmtime)
    try:
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(size // 2)
        return "truncated %r %d -> %d bytes" % (target, size, size // 2)
    except OSError as e:
        return "tear of %r failed: %s" % (target, e)


# -- install / parse ---------------------------------------------------------

def parse_spec(spec) -> FaultPlan:
    """Build a plan from the ``MXNET_FAULTS`` spec string (or a dict of
    the same keys) — see the module docstring for the grammar."""
    if isinstance(spec, FaultPlan):
        return spec
    if isinstance(spec, Rule):
        return FaultPlan([spec])
    if isinstance(spec, (list, tuple)):
        return FaultPlan(list(spec))
    kv: Dict[str, str] = {}
    if isinstance(spec, str):
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise MXNetError(
                    "MXNET_FAULTS: %r is not key=value (full spec: %r)"
                    % (part, spec))
            k, v = part.split("=", 1)
            kv[k.strip()] = v.strip()
    elif isinstance(spec, dict):
        kv = {str(k): v for k, v in spec.items()}
    else:
        raise MXNetError("cannot parse fault spec from %r" % (spec,))
    known = {"seed", "rate", "kinds", "points", "after", "max",
             "attempts", "delay_ms"}
    unknown = set(kv) - known
    if unknown:
        raise MXNetError("MXNET_FAULTS: unknown key(s) %s (known: %s)"
                         % (sorted(unknown), sorted(known)))
    points = kv.get("points")
    if isinstance(points, str):
        points = [p for p in points.split("|") if p]
    attempts = kv.get("attempts")
    if isinstance(attempts, str):
        attempts = [int(a) for a in attempts.split("|") if a]
    delay_ms = kv.get("delay_ms")
    rule = Rule(points=points,
                kinds=kv.get("kinds", "error"),
                rate=float(kv.get("rate", 1.0)),
                after=int(kv.get("after", 0)),
                max_faults=(int(kv["max"]) if "max" in kv else None),
                attempts=attempts,
                delay_s=(float(delay_ms) / 1e3 if delay_ms is not None
                         else None))
    return FaultPlan([rule], seed=int(kv.get("seed", 0)))


def install(plan) -> FaultPlan:
    """Install ``plan`` (a FaultPlan / Rule / rules list / spec string
    or dict) as THE process fault plan; returns it."""
    global _PLAN
    plan = parse_spec(plan)
    _PLAN = plan
    _register_stats()
    _trace.instant("fault:install", cat="faults", seed=plan.seed,
                   rules=len(plan.rules), attempt=plan.attempt)
    return plan


def clear() -> None:
    """Remove the installed plan (points go back to no-ops)."""
    global _PLAN
    _PLAN = None


class active:
    """``with faults.active("rate=1,kinds=error"): ...`` — install for
    the block, restore the previous plan after."""

    def __init__(self, spec):
        self._spec = spec
        self._prev = None

    def __enter__(self):
        self._prev = _PLAN
        return install(self._spec)

    def __exit__(self, *exc):
        global _PLAN
        _PLAN = self._prev


def refresh_attempt() -> Optional[FaultPlan]:
    """Re-read ``MXNET_FAULTS_ATTEMPT`` into the installed plan and
    re-seed its decision streams (supervisor fork-children inherit the
    parent's PROGRAMMATIC plan across the fork; only the attempt index
    changed)."""
    plan = _PLAN
    if plan is not None:
        with plan._lock:
            plan.attempt = attempt()
            plan._state.clear()
    return plan


def reload_from_env() -> Optional[FaultPlan]:
    """(Re-)parse ``MXNET_FAULTS``; used at import and by supervisor
    fork-children whose attempt index just changed.  With the env
    unset, a PROGRAMMATICALLY installed plan (inherited across a fork)
    is kept — only its attempt index refreshes; there is nothing env
    to reload."""
    spec = get_env("MXNET_FAULTS", None)
    if not spec:
        return refresh_attempt()
    return install(spec)


# a process with MXNET_FAULTS in its environment is born with the plan
# installed — subprocess children (the supervisor's, a bench child, a
# forked reader worker) inherit the chaos schedule with zero wiring
reload_from_env()
