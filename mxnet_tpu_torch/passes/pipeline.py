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
gathers them for the Predictor to bind.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..base import MXNetError
from ..symbol import Symbol

__all__ = ["Pass", "PassPipeline", "PassError"]


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
        self.type_overrides: Dict[str, Any] = {}

    def _validate_order(self) -> None:
        violations = []
        for i, p in enumerate(self.passes):
            for dep in p.order_after:
                if any(q.name == dep for q in self.passes[i + 1:]):
                    violations.append("%r must run after %r" % (p.name, dep))
        if violations:
            raise PassError("pipeline %r pass ordering invalid: %s"
                            % (self.name, "; ".join(violations)))

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
        self.type_overrides = {}
        out_sym, out_params = sym, params
        for p in self.passes:
            p.summary = {}
            try:
                new_sym, new_params = p.apply(out_sym, out_params)
            except PassError:
                raise
            except Exception as e:
                raise PassError("pass %r failed: %s: %s"
                                % (p.name, type(e).__name__, e)) from e
            if self.verify:
                verify_roundtrip(new_sym, label="after pass %r" % p.name)
                check_attrs_preserved(out_sym, new_sym, pass_name=p.name)
            self.type_overrides.update(p.summary.get("type_overrides") or {})
            out_sym, out_params = new_sym, new_params
        if out_sym is sym:          # every pass was an identity
            out_sym = sym.__copy__()
        out_sym._graph_attrs["__passes__"] = self.fingerprint()
        return out_sym, out_params

    def transform_params(self, params: Dict) -> Dict:
        """Replay the params-side transforms of every pass, in order."""
        out = dict(params)
        for p in self.passes:
            out = p.transform_params(out)
        return out
