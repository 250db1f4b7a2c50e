"""Fleet-level rollup of ``multichip_report()`` across host journals
(counterpart of ``mxnet_tpu/dist/report.py``).

``mx.profiler.multichip_report()`` sees ONE process.  A multi-host run
has N of them, each journaling its own counters (``MXNET_TRACE_JOURNAL``
— every rank writes ``reports.multichip`` into its own JSONL file).
:func:`fleet_multichip_report` joins those files after (or during) the
run: per-host dispatch/device/collective columns plus a fleet summary
with the cross-host skew — the number that says "host 3 is the
straggler" before anyone ssh'es anywhere.

The reader rides :func:`mxnet_tpu_torch.trace.journal.tail`, so it degrades
like every other journal consumer: a missing or torn file yields an
absent host entry, never an exception — this is a reporting path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

__all__ = ["fleet_multichip_report", "fleet_multichip_report_str"]


def _host_rollup(mc: dict) -> Optional[dict]:
    """One journal line's ``reports.multichip`` section (possibly
    several live steps) -> one host row."""
    if not isinstance(mc, dict) or not mc:
        return None
    out = {"steps": 0, "dispatch_s": 0.0, "sampled_device_s": 0.0,
           "sampled_steps": 0, "collective_count_per_step": 0,
           "collective_bytes_per_step": 0, "mesh": None, "devices": 0}
    seen = False
    for rep in mc.values():
        if not isinstance(rep, dict) or "steps" not in rep:
            continue
        seen = True
        out["steps"] += int(rep.get("steps", 0))
        out["dispatch_s"] += float(rep.get("dispatch_s", 0.0))
        out["sampled_device_s"] += float(rep.get("sampled_device_s", 0.0))
        out["sampled_steps"] += int(rep.get("sampled_steps", 0))
        c = rep.get("collectives") or {}
        out["collective_count_per_step"] += int(c.get("total_count", 0))
        out["collective_bytes_per_step"] += int(c.get("total_bytes", 0))
        if out["mesh"] is None:
            out["mesh"] = rep.get("mesh")
            out["devices"] = rep.get("devices", 0)
    if not seen:
        return None
    if out["steps"] > 1:
        out["dispatch_s_per_step"] = round(
            out["dispatch_s"] / out["steps"], 6)
    if out["sampled_steps"]:
        out["device_s_per_step"] = round(
            out["sampled_device_s"] / out["sampled_steps"], 6)
    return out


def fleet_multichip_report(
        journals: Union[List[str], Dict[str, str]]) -> dict:
    """Per-host multichip rollup from the fleet's trace journals.

    ``journals``: ``{host_label: journal_path}`` or a list of paths
    (labels become ``rank0..rankN`` in list order — hand the supervisor's
    per-rank journal paths straight in).  Returns::

        {"hosts": {label: {steps, dispatch_s_per_step, device_s_per_step,
                           collective_{count,bytes}_per_step, mesh, ...}},
         "fleet": {hosts, reporting, steps_min, steps_max,
                   dispatch_s_per_step_mean, dispatch_skew,
                   collective_bytes_per_step_total}}

    ``dispatch_skew`` is max/min per-step dispatch across reporting
    hosts (1.0 = perfectly even; the straggler detector).  Hosts whose
    journal is missing or empty appear in ``fleet.hosts`` but not in
    ``hosts`` — reporting is best-effort by design."""
    from ..trace.journal import tail
    if isinstance(journals, dict):
        items = list(journals.items())
    else:
        items = [("rank%d" % i, p) for i, p in enumerate(journals)]
    hosts = {}
    for label, path in items:
        lines = tail(path, 1)
        if not lines:
            continue
        mc = (lines[-1].get("reports") or {}).get("multichip")
        row = _host_rollup(mc)
        if row is not None:
            row["step"] = lines[-1].get("step")
            hosts[str(label)] = row
    fleet = {"hosts": len(items), "reporting": len(hosts)}
    if hosts:
        steps = [h["steps"] for h in hosts.values()]
        fleet["steps_min"] = min(steps)
        fleet["steps_max"] = max(steps)
        fleet["collective_bytes_per_step_total"] = sum(
            h["collective_bytes_per_step"] for h in hosts.values())
        rates = [h["dispatch_s_per_step"] for h in hosts.values()
                 if h.get("dispatch_s_per_step")]
        if rates:
            fleet["dispatch_s_per_step_mean"] = round(
                sum(rates) / len(rates), 6)
            if min(rates) > 0:
                fleet["dispatch_skew"] = round(max(rates) / min(rates), 3)
    return {"hosts": hosts, "fleet": fleet}


def fleet_multichip_report_str(
        journals: Union[List[str], Dict[str, str]]) -> str:
    """Human-readable table form of :func:`fleet_multichip_report`."""
    r = fleet_multichip_report(journals)
    f = r["fleet"]
    lines = ["fleet: %d/%d hosts reporting" % (f["reporting"], f["hosts"])]
    for label in sorted(r["hosts"]):
        h = r["hosts"][label]
        lines.append(
            "  %-8s steps %-6d dispatch/step %-10s device/step %-10s "
            "coll %d ops %.3f MB"
            % (label, h["steps"],
               "%.6fs" % h["dispatch_s_per_step"]
               if h.get("dispatch_s_per_step") else "-",
               "%.6fs" % h["device_s_per_step"]
               if h.get("device_s_per_step") else "-",
               h["collective_count_per_step"],
               h["collective_bytes_per_step"] / 1e6))
    if f.get("dispatch_skew"):
        lines.append("  dispatch skew %.3fx (max/min across hosts)"
                     % f["dispatch_skew"])
    return "\n".join(lines)
