"""Chrome/Perfetto trace-event export: merge every process's spans into
one loadable JSON file (counterpart of ``mxnet_tpu/trace/export.py``).

The exported file is the `Trace Event Format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
"JSON object" flavor: ``{"traceEvents": [...], "displayTimeUnit": "ms"}``
with

* ``ph:"X"`` complete events for synchronous spans (``ts``/``dur`` in
  microseconds on the shared CLOCK_MONOTONIC timeline),
* ``ph:"b"/"n"/"e"`` async events for request lifecycles (same ``cat`` +
  ``id`` draws the flow arrows linking a serve request from ``submit()``
  through batcher, dispatch, D2H and future-resolve),
* ``ph:"M"`` metadata naming each pid lane (parent vs reader worker
  processes) and tid lane (thread names), so Perfetto shows one labeled
  track per process/thread.

Sources merged per dump: this process's live rings (the recorder
snapshot) plus every spill file under the registered spill directories —
the per-worker JSONL files ParallelReader workers append to, which
survive the worker (even a SIGKILL'd one) because the parent owns the
directory.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

__all__ = ["export_chrome", "read_spill_dir"]


def read_spill_dir(directory: str) -> List[Dict]:
    """Every event from every ``*.jsonl`` spill file under
    ``directory``.  A torn final line (the writer died mid-write) is
    skipped, not fatal."""
    events: List[Dict] = []
    for path in sorted(glob.glob(os.path.join(directory, "*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue       # torn tail from a killed writer
                    if isinstance(ev, dict):
                        events.append(ev)
        except OSError:
            continue
    return events


def _metadata(events: List[Dict], main_pid: int,
              thread_names: Dict[int, str],
              process_labels: Optional[Dict[int, str]] = None) -> List[Dict]:
    """process_name / thread_name metadata records for every (pid, tid)
    seen in ``events``."""
    labels = dict(process_labels or {})
    pids = {}
    for ev in events:
        pids.setdefault(ev["pid"], set()).add(ev["tid"])
    meta = []
    for pid, tids in sorted(pids.items()):
        if pid == main_pid:
            pname = labels.get(pid, "mxnet-tpu (main)")
        else:
            pname = labels.get(pid, "mxnet-tpu worker pid=%d" % pid)
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": pname}})
        for tid in sorted(tids):
            tname = thread_names.get(tid) if pid == main_pid else None
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid,
                         "args": {"name": tname or "tid=%d" % tid}})
    return meta


def export_chrome(path: str, recorder, spill_dirs, drops: int = 0,
                  process_labels: Optional[Dict[int, str]] = None) -> str:
    """Write the merged trace to ``path``; returns ``path``."""
    events = recorder.snapshot()
    for d in spill_dirs:
        events.extend(read_spill_dir(d))
    events.sort(key=lambda ev: ev.get("ts", 0.0))
    meta = _metadata(events, recorder.pid, recorder.thread_names(),
                     process_labels)
    if drops:
        # surface lost events IN the trace, where the person reading it
        # will look, not only in a report dict
        events.append({"name": "trace:dropped_events", "cat": "trace",
                      "ph": "i", "s": "g", "ts": events[-1]["ts"]
                       if events else 0.0, "pid": recorder.pid, "tid": 0,
                       "args": {"dropped": drops}})
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    out_dir = os.path.dirname(os.path.abspath(path))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        # attrs are arbitrary **kwargs; one np.float32 must not cost the
        # whole trace (default=str matches the journal's policy)
        json.dump(doc, f, default=str)
    return path
