"""Drift-gated candidate promotion into the live router (counterpart of
``mxnet_tpu/online/promote.py``).

The loop's last leg: decide whether the fine-tuned candidate checkpoint
replaces the serving weights, and if so land it with **zero dropped
requests** via ``ServeRouter.rolling_restart`` (drain one replica at a
time, hot-swap, return to rotation).

The gate is deliberately dual:

* **quality** — held-out accuracy of the candidate vs the live model;
  the candidate must improve by at least ``MXNET_ONLINE_PROMOTE_MIN``
  (default 0.0: never promote a regression);
* **drift** — the fraction of held-out predictions whose argmax
  *changed*; above ``MXNET_ONLINE_MAX_DRIFT`` (default 1.0: off) the
  candidate is quarantined even if its aggregate accuracy improved — a
  model that flips most of its answers is a different model, and the
  blast radius of a silent behavioral swap is exactly what the gate
  exists to bound.

Either outcome is recorded three ways: a trace instant
(``online:promote`` / ``online:quarantine``) with the reasoned
numbers, an atomically-published ``PROMOTED``/``QUARANTINED`` record in
the checkpoint store (crash-safe: re-running a promotion that already
landed is idempotent), and the gate's own counters in
``online_report()``.  The decision also tails the run-metrics journal
(:mod:`mxnet_tpu_torch.trace.journal`) so the recorded context carries the
serve-side metric deltas that accompanied the candidate's training
window.

Embed freshness: sparse embedding tables absorb new ids while serving;
a candidate trained before those rows existed must not shrink
the live table.  :func:`freshen_embed` carries the live table's extra
tail rows into the promoted params.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..base import MXNetError, atomic_local_write, get_env, make_lock
from ..faults import point as _fault_point
from .. import trace as _trace

__all__ = ["PromotionGate", "promote", "quarantine", "freshen_embed",
           "read_record", "PROMOTED_RECORD", "QUARANTINED_RECORD"]

PROMOTED_RECORD = "PROMOTED"
QUARANTINED_RECORD = "QUARANTINED"


def freshen_embed(cand_params: dict, live_params: dict,
                  keys=None) -> dict:
    """Carry live embedding rows the candidate predates: for every
    2-D table in ``keys`` (default: every param 2-D in both dicts)
    where the LIVE copy has more rows, append the live tail to the
    candidate's table.  Returns a new params dict; non-table entries
    pass through untouched."""
    out = dict(cand_params)
    names = keys if keys is not None else \
        [k for k in cand_params if k in live_params]
    for k in names:
        if k not in cand_params or k not in live_params:
            if keys is not None:
                raise MXNetError("freshen_embed: %r missing from %s"
                                 % (k, "candidate" if k in live_params
                                    else "live params"))
            continue
        cand = np.asarray(cand_params[k])
        live = np.asarray(live_params[k])
        if (cand.ndim == 2 and live.ndim == 2
                and live.shape[0] > cand.shape[0]
                and live.shape[1] == cand.shape[1]):
            out[k] = np.concatenate([cand, live[cand.shape[0]:]], axis=0)
    return out


def _write_record(directory: str, name: str, doc: dict) -> None:
    with atomic_local_write(os.path.join(directory, name), "w") as f:
        json.dump(doc, f, sort_keys=True)


def read_record(directory: str, name: str):
    """The last published ``PROMOTED``/``QUARANTINED`` record, or None
    (absent, torn-free by construction: records publish atomically)."""
    try:
        with open(os.path.join(directory, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def promote(router, directory: str, step=None, *, decision=None,
            timeout=None, freshen_from=None, embed_keys=None) -> dict:
    """Land checkpoint ``step`` (default newest committed) of
    ``directory`` on every router replica via ``rolling_restart`` —
    the zero-drop deploy: each replica drains, hot-swaps, and returns
    to rotation before the next one leaves it.  ``freshen_from`` (live
    params dict) applies :func:`freshen_embed` first.  Publishes the
    ``PROMOTED`` record after the restart, so a crash mid-promotion
    leaves either no record (the re-run re-promotes, idempotent — the
    swap lands the same weights) or a complete one."""
    from ..serve.engine import load_checkpoint_dir_params
    params, meta = load_checkpoint_dir_params(directory, step)
    if freshen_from is not None:
        params = freshen_embed(params, freshen_from, keys=embed_keys)
    step = meta.get("global_step") if isinstance(meta, dict) else step
    # the chaos schedule's "crash mid-promotion" seam: weights loaded,
    # restart not yet begun — a re-run must re-evaluate and re-land
    _fault_point("online.promote", stage="restart", step=step)
    router.rolling_restart(reload=params, timeout=timeout)
    record = {"action": "promote", "step": step,
              "decision": decision,
              "replicas": router.num_replicas}
    _fault_point("online.promote", stage="record", step=step)
    _write_record(directory, PROMOTED_RECORD, record)
    _trace.instant("online:promote", cat="online", step=step,
                   replicas=router.num_replicas)
    return record


def quarantine(directory: str, decision: dict) -> dict:
    """Record a refused candidate with its reasons; the live weights
    stay.  The record is advisory (the next round overwrites it) — the
    authoritative history is the trace/journal stream."""
    record = {"action": "quarantine", "decision": decision}
    _write_record(directory, QUARANTINED_RECORD, record)
    _trace.instant("online:quarantine", cat="online",
                   reasons=list(decision.get("reasons", [])))
    return record


class PromotionGate:
    """Quality + drift gate between a candidate checkpoint and the
    live model.

    ``min_improve``: least held-out accuracy gain that may promote
    (``MXNET_ONLINE_PROMOTE_MIN``, default 0.0 — ties promote, any
    regression quarantines).  ``max_drift``: largest tolerated fraction
    of changed argmax predictions (``MXNET_ONLINE_MAX_DRIFT``, default
    1.0 — disabled).  ``journal``: run-metrics journal path to tail
    into the decision (default ``MXNET_TRACE_JOURNAL``)."""

    def __init__(self, min_improve: float = None, max_drift: float = None,
                 journal: str = None, name: str = "online-gate"):
        if min_improve is None:
            min_improve = get_env("MXNET_ONLINE_PROMOTE_MIN", 0.0, float)
        if max_drift is None:
            max_drift = get_env("MXNET_ONLINE_MAX_DRIFT", 1.0, float)
        self.min_improve = float(min_improve)
        self.max_drift = float(max_drift)
        self.journal = journal
        self.name = name
        self._lock = make_lock("online.gate")
        self._decisions = 0
        self._promoted = 0
        self._quarantined = 0
        from .. import profiler
        profiler.register_online_stats(self)

    # -- the decision ------------------------------------------------------
    def decide(self, live_scores, cand_scores, labels) -> dict:
        """Score both models' held-out outputs (``[N, C]`` score rows
        vs ``[N]`` integer labels) -> decision dict: ``promote`` plus
        the reasoned numbers (accuracies, improvement, drift, journal
        deltas, failed criteria)."""
        live = np.asarray(live_scores)
        cand = np.asarray(cand_scores)
        y = np.asarray(labels).reshape(-1).astype(np.int64)
        if live.shape != cand.shape or live.shape[0] != y.shape[0]:
            raise MXNetError(
                "gate needs matching held-out shapes, got live %s / "
                "cand %s / labels %s"
                % (live.shape, cand.shape, y.shape))
        live_top = live.argmax(axis=1)
        cand_top = cand.argmax(axis=1)
        live_acc = float((live_top == y).mean())
        cand_acc = float((cand_top == y).mean())
        improvement = cand_acc - live_acc
        drift = float((live_top != cand_top).mean())
        reasons = []
        if improvement < self.min_improve:
            reasons.append(
                "improvement %.4f < MXNET_ONLINE_PROMOTE_MIN %.4f"
                % (improvement, self.min_improve))
        if drift > self.max_drift:
            reasons.append("drift %.4f > MXNET_ONLINE_MAX_DRIFT %.4f"
                           % (drift, self.max_drift))
        decision = {
            "promote": not reasons,
            "live_acc": round(live_acc, 6),
            "cand_acc": round(cand_acc, 6),
            "improvement": round(improvement, 6),
            "drift": round(drift, 6),
            "n_holdout": int(y.shape[0]),
            "reasons": reasons,
            "journal": self._journal_context(),
        }
        _fault_point("online.promote", stage="decide",
                     promote=decision["promote"])
        with self._lock:
            self._decisions += 1
            if decision["promote"]:
                self._promoted += 1
            else:
                self._quarantined += 1
        return decision

    def apply(self, decision: dict, router, directory: str, step=None,
              timeout=None, freshen_from=None, embed_keys=None) -> dict:
        """Act on a decision: promote via the zero-drop rolling restart
        or quarantine with the reasons.  -> the published record."""
        if decision["promote"]:
            return promote(router, directory, step=step,
                           decision=decision, timeout=timeout,
                           freshen_from=freshen_from,
                           embed_keys=embed_keys)
        return quarantine(directory, decision)

    def _journal_context(self):
        """Tail the run-metrics journal: the last two snapshots'
        step delta situates the decision in the serve/train timeline.
        Best-effort — a missing or rotated-away journal yields
        ``None``, never an error inside the gate."""
        from ..trace import journal as _journal
        path = self.journal if self.journal is not None \
            else _journal.journal_path()
        if not path:
            return None
        lines = _journal.tail(path, 2)
        if not lines:
            return None
        out = {"lines": len(lines), "last_step": lines[-1].get("step")}
        if len(lines) == 2:
            try:
                out["step_delta"] = (lines[1]["step"] - lines[0]["step"])
            except (KeyError, TypeError):
                pass
        return out

    # -- introspection -----------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            return {
                "kind": "gate",
                "min_improve": self.min_improve,
                "max_drift": self.max_drift,
                "decisions": self._decisions,
                "promoted": self._promoted,
                "quarantined": self._quarantined,
            }

    def report_str(self) -> str:
        r = self.report()
        return ("online gate %r: %d decisions (%d promoted, "
                "%d quarantined), min_improve %.3f, max_drift %.3f"
                % (self.name, r["decisions"], r["promoted"],
                   r["quarantined"], r["min_improve"], r["max_drift"]))
