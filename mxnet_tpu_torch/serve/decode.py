"""Decode-stream plumbing shared by the decode engines (counterpart of the
request half of ``mxnet_tpu/serve/decode.py``).

Only what the paged engine needs is here: the request record and its
trace hook.  The dense ``DecodeEngine`` comes with a later slice
(ROADMAP queue 1 item 3).
"""
from __future__ import annotations

__all__ = []


def _trace_end(req: "_DecodeRequest", outcome: str) -> None:
    """Close a stream's trace span with its outcome.  A no-op until the
    ``trace/`` subsystem is ported (ROADMAP queue 1 item 12); the calls
    stay at the places the JAX package traces, so the port's engines gain
    their spans without moving a line."""


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "future", "enqueue_t",
                 "deadline_t", "trace_id")

    def __init__(self, prompt, max_new, eos_id, future, enqueue_t,
                 deadline_t, trace_id=None):
        self.prompt = prompt            # np.int64 1-D, len >= 1
        self.max_new = max_new
        self.eos_id = eos_id
        self.future = future
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t    # admission deadline (queue wait)
        self.trace_id = trace_id
