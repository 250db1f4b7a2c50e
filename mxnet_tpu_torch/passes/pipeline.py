"""Pass protocol + PassPipeline: ordered graph-to-graph rewrites
(counterpart of ``mxnet_tpu/passes/pipeline.py``).

A ``Pass`` rewrites ``(Symbol, params) -> (Symbol, params)``; a
``PassPipeline`` runs an ordered list of them, verifies each result
(JSON round trip, attrs of surviving nodes kept — ``passes.verify``) and
stamps its fingerprint, a digest of the pass list and each pass's
config, into the result's graph attrs as ``__passes__``.  The digest is
computed exactly as the JAX package computes it, so both packages stamp
the same value on the same pipeline.  A pass that retypes an input (the
uint8 wire) names it in its summary's ``type_overrides``; the pipeline
gathers them for the Predictor to bind.  Per pass, the pipeline keeps
wall time, node counts and rewrites (``PassStats``, ``report_str``;
``last_report`` holds the last run's rows).  A mis-ordered pass list
raises with the corrected order.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import trace as _trace
from ..base import MXNetError
from ..symbol import Symbol, _topo

__all__ = ["Pass", "PassPipeline", "PassStats", "PassError"]


class PassError(MXNetError):
    """A pass failed or produced a graph that fails verification."""


def _as_np(v):
    """params values may be NDArray or numpy; passes work on numpy."""
    import numpy as np
    asnumpy = getattr(v, "asnumpy", None)
    return asnumpy() if callable(asnumpy) else np.asarray(v)


class Pass:
    """One graph rewrite.  ``apply`` must not mutate its input symbol;
    ``summary`` is reset by the pipeline before each apply."""

    name = "pass"
    # names of passes that, when present in the same pipeline, must run
    # BEFORE this one
    order_after: Tuple[str, ...] = ()

    def __init__(self):
        self.summary: Dict[str, Any] = {}

    def apply(self, sym: Symbol, params: Optional[Dict]) -> \
            Tuple[Symbol, Optional[Dict]]:
        return sym, params

    def config(self) -> str:
        """Everything that changes what this pass would do; joins the
        pipeline fingerprint.  Must be stable across processes."""
        return ""

    def transform_params(self, params: Dict) -> Dict:
        """Replay this pass's params-side transform on fresh params."""
        return params


class PassStats:
    """Per-pipeline pass counters (reference ``PassStats``): per pass,
    runs, wall seconds, nodes in/out and rewrites; the fingerprint of
    the last run."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._passes: Dict[str, Dict[str, float]] = {}
        self._order: List[str] = []
        self.runs = 0
        self.fingerprint = ""

    def on_pass(self, pass_name: str, wall_s: float, nodes_in: int,
                nodes_out: int, rewrites: int) -> None:
        with self._lock:
            d = self._passes.get(pass_name)
            if d is None:
                d = self._passes[pass_name] = {
                    "runs": 0, "wall_s": 0.0, "nodes_in": 0,
                    "nodes_out": 0, "rewrites": 0}
                self._order.append(pass_name)
            d["runs"] += 1
            d["wall_s"] += wall_s
            d["nodes_in"] = nodes_in
            d["nodes_out"] = nodes_out
            d["rewrites"] += rewrites

    def on_run(self, fingerprint: str) -> None:
        with self._lock:
            self.runs += 1
            self.fingerprint = fingerprint

    def report(self) -> dict:
        with self._lock:
            return {"pipeline": self.name, "runs": self.runs,
                    "fingerprint": self.fingerprint,
                    "passes": {k: dict(self._passes[k])
                               for k in self._order}}

    def report_str(self) -> str:
        rep = self.report()
        lines = ["passes pipeline %r: %d run(s), fingerprint %s" % (
            rep["pipeline"], rep["runs"],
            (rep["fingerprint"][:16] + "...") if rep["fingerprint"] else "-")]
        fmt = "  %-22s %5s %9s %9s %9s %9s"
        lines.append(fmt % ("pass", "runs", "wall_s", "nodes_in",
                            "nodes_out", "rewrites"))
        for k, d in rep["passes"].items():
            lines.append(fmt % (k, d["runs"], "%.4f" % d["wall_s"],
                                d["nodes_in"], d["nodes_out"],
                                d["rewrites"]))
        return "\n".join(lines)


class PassPipeline:
    """Ordered passes over (Symbol, params)."""

    def __init__(self, passes: Sequence[Pass], name: str = "passes",
                 verify: bool = True):
        self.passes: List[Pass] = list(passes)
        for p in self.passes:
            if not isinstance(p, Pass):
                raise PassError("PassPipeline expects Pass instances, got %r"
                                % (p,))
        self.name = name
        self.verify = verify
        self._validate_order()
        self.stats = PassStats(name)
        from .. import profiler
        profiler.register_passes_stats(self.stats)
        # per run: [{"pass", "wall_s", "nodes_in", "nodes_out",
        #            "summary"}, ...]
        self.last_report: List[Dict[str, Any]] = []
        self.type_overrides: Dict[str, Any] = {}

    def canonical_order(self) -> List[Pass]:
        """The pass list re-ordered to satisfy every ``order_after``,
        stably (ties keep the given order); a declaration cycle keeps
        the given order for the cyclic remainder."""
        remaining = list(self.passes)
        out: List[Pass] = []
        while remaining:
            for i, p in enumerate(remaining):
                deps = set(p.order_after)
                if not any(q.name in deps for q in remaining if q is not p):
                    out.append(remaining.pop(i))
                    break
            else:
                out.extend(remaining)
                break
        return out

    def _validate_order(self) -> None:
        """Raise on a mis-ordered pipeline (an early pass would rewrite
        nodes a later one needs unrewritten), with the corrected order."""
        violations = []
        for i, p in enumerate(self.passes):
            for dep in p.order_after:
                if any(q.name == dep for q in self.passes[i + 1:]):
                    violations.append("%r must run after %r" % (p.name, dep))
        if violations:
            raise PassError(
                "pipeline %r pass ordering invalid: %s — the early pass "
                "would silently rewrite nodes the later pass needs to "
                "see in their unrewritten form.  Corrected order: %s"
                % (self.name, "; ".join(violations),
                   [p.name for p in self.canonical_order()]))

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for p in self.passes:
            h.update(p.name.encode())
            h.update(b"\x00")
            h.update(p.config().encode())
            h.update(b"\x01")
        return h.hexdigest()

    def run(self, sym: Symbol, params: Optional[Dict] = None) -> \
            Tuple[Symbol, Optional[Dict]]:
        """Apply every pass in order; the input symbol is never mutated."""
        from .verify import check_attrs_preserved, verify_roundtrip
        self.last_report = []
        self.type_overrides = {}
        out_sym, out_params = sym, params
        with _trace.span("passes:pipeline", cat="passes", pipeline=self.name):
            for p in self.passes:
                nodes_in = len(_topo(out_sym._heads))
                p.summary = {}
                t0 = time.perf_counter()
                with _trace.span("passes:%s" % p.name, cat="passes"):
                    try:
                        new_sym, new_params = p.apply(out_sym, out_params)
                    except PassError:
                        raise
                    except Exception as e:
                        raise PassError("pass %r failed: %s: %s"
                                        % (p.name, type(e).__name__, e)) \
                            from e
                wall = time.perf_counter() - t0
                if self.verify:
                    verify_roundtrip(new_sym, label="after pass %r" % p.name)
                    check_attrs_preserved(out_sym, new_sym, pass_name=p.name)
                nodes_out = len(_topo(new_sym._heads))
                rewrites = int(p.summary.get("rewrites",
                                             abs(nodes_in - nodes_out)))
                self.stats.on_pass(p.name, wall, nodes_in, nodes_out,
                                   rewrites)
                self.last_report.append({
                    "pass": p.name, "wall_s": wall, "nodes_in": nodes_in,
                    "nodes_out": nodes_out, "summary": dict(p.summary)})
                self.type_overrides.update(
                    p.summary.get("type_overrides") or {})
                out_sym, out_params = new_sym, new_params
        fp = self.fingerprint()
        if out_sym is sym:          # every pass was an identity
            out_sym = sym.__copy__()
        out_sym._graph_attrs["__passes__"] = fp
        self.stats.on_run(fp)
        return out_sym, out_params

    def transform_params(self, params: Dict) -> Dict:
        """Replay the params-side transforms of every pass, in order."""
        out = dict(params)
        for p in self.passes:
            out = p.transform_params(out)
        return out

    def report_str(self) -> str:
        return self.stats.report_str()
