"""Serving instrumentation for one ServeEngine (counterpart of
``ServeStats`` in ``mxnet_tpu/serve/stats.py``): latency p50/p95/p99
over a sliding window of completed requests (queue wait + inference +
device-to-host copy, what the client saw), batch occupancy, pad waste,
per-bucket hit counts, queue depth and the reject/expiry/cancel/failure
counters.

:class:`DecodeStats` (continuous-batching decode) adds slot occupancy,
steps and tokens emitted and admission counters; :class:`PagedStats`
(paged LLM serving) adds prefill tokens, speculative-decode
proposed/accepted counters, KV-block-pool gauges (used / reserved /
total, and the peak), an inter-token latency window, and
``dropped_streams``, which exact block reservation holds at 0.  Each
is a row of ``mx.profiler.serve_report()`` (``report_str`` for the
table).
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List

from ..base import make_lock


__all__ = ["ServeStats", "DecodeStats", "PagedStats"]

# sliding latency window: big enough for stable p99, small enough that a
# report reflects the recent regime rather than the whole process life
LATENCY_WINDOW = 4096


def _percentile(sorted_ms: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (0 when empty)."""
    if not sorted_ms:
        return 0.0
    idx = max(0, min(len(sorted_ms) - 1,
                     int(math.ceil(q / 100.0 * len(sorted_ms))) - 1))
    return sorted_ms[idx]


class ServeStats:
    """Counters for one ServeEngine; written from the submit/dispatch/
    completion threads under a lock, snapshotted atomically by
    ``report()``."""

    def __init__(self, name: str, max_batch_size: int):
        self.name = name
        self.max_batch_size = int(max_batch_size)
        self._lock = make_lock("serve.stats")
        self._submitted = 0
        self._completed = 0
        self._captured = 0
        self._overloaded = 0
        self._expired = 0
        self._cancelled = 0
        self._failed = 0
        self._reloads = 0
        self._batches = 0
        self._batch_items = 0
        self._pad_items = 0
        self._bucket_hits: Dict[int, int] = {}
        self._queue_depth = 0
        self._queue_depth_max = 0
        self._lat_ms = collections.deque(maxlen=LATENCY_WINDOW)

    # -- recording ---------------------------------------------------------
    def on_submit(self, queue_depth: int) -> None:
        with self._lock:
            self._submitted += 1
            self._queue_depth = queue_depth
            if queue_depth > self._queue_depth_max:
                self._queue_depth_max = queue_depth

    def on_overload(self) -> None:
        with self._lock:
            self._overloaded += 1

    def on_expired(self, n: int) -> None:
        with self._lock:
            self._expired += n

    def on_cancelled(self, n: int) -> None:
        with self._lock:
            self._cancelled += n

    def on_failed(self, n: int) -> None:
        with self._lock:
            self._failed += n

    def on_batch(self, items: int, bucket: int) -> None:
        with self._lock:
            self._batches += 1
            self._batch_items += items
            self._pad_items += bucket - items
            self._bucket_hits[bucket] = self._bucket_hits.get(bucket, 0) + 1

    def on_complete(self, latencies_ms) -> None:
        with self._lock:
            self._completed += len(latencies_ms)
            self._lat_ms.extend(latencies_ms)

    def on_reload(self) -> None:
        with self._lock:
            self._reloads += 1

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = depth

    def _outstanding_locked(self) -> int:
        """Terminal-outcome balance — EVERY new terminal counter must be
        subtracted here and only here (lock held by the caller)."""
        return max(0, self._submitted - self._completed - self._failed
                   - self._expired - self._cancelled)

    def on_captured(self) -> None:
        """A completed request was offered to a router's capture hook and
        kept: not a terminal outcome (the request already completed), so
        it stays out of the outstanding balance; captured / completed is
        the sampled rate."""
        with self._lock:
            self._captured += 1

    def outstanding(self) -> int:
        """Admitted requests not yet resolved (queued or in flight)."""
        with self._lock:
            return self._outstanding_locked()

    # -- reading -----------------------------------------------------------
    def report(self) -> Dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            dispatched = self._batch_items + self._pad_items
            out = {
                "kind": "engine",
                "max_batch_size": self.max_batch_size,
                "outstanding": self._outstanding_locked(),
                "submitted": self._submitted,
                "completed": self._completed,
                "overloaded": self._overloaded,
                "expired": self._expired,
                "cancelled": self._cancelled,
                "failed": self._failed,
                "reloads": self._reloads,
                "captured": self._captured,
                "capture_rate": round(self._captured / self._completed, 4)
                if self._completed else 0.0,
                "batches": self._batches,
                "batch_occupancy": round(
                    self._batch_items
                    / (self._batches * self.max_batch_size), 4)
                if self._batches else 0.0,
                "pad_waste_frac": round(self._pad_items / dispatched, 4)
                if dispatched else 0.0,
                "bucket_hits": dict(sorted(self._bucket_hits.items())),
                "queue_depth": self._queue_depth,
                "queue_depth_max": self._queue_depth_max,
            }
        out["latency_p50_ms"] = round(_percentile(lat, 50), 3)
        out["latency_p95_ms"] = round(_percentile(lat, 95), 3)
        out["latency_p99_ms"] = round(_percentile(lat, 99), 3)
        return out

    def report_str(self) -> str:
        r = self.report()
        buckets = ", ".join("%d:%d" % (b, n)
                            for b, n in r["bucket_hits"].items()) or "-"
        return ("serve engine %r\n"
                "  requests: %d submitted / %d completed "
                "(%d overloaded, %d expired, %d cancelled, %d failed), "
                "%d reloads\n"
                "  latency ms: p50 %.2f  p95 %.2f  p99 %.2f\n"
                "  batches: %d, occupancy %.2f of max %d, "
                "pad waste %.1f%%\n"
                "  bucket hits: %s\n"
                "  queue depth: %d now / %d high-water" % (
                    self.name, r["submitted"], r["completed"],
                    r["overloaded"], r["expired"], r["cancelled"],
                    r["failed"], r["reloads"],
                    r["latency_p50_ms"], r["latency_p95_ms"],
                    r["latency_p99_ms"], r["batches"], r["batch_occupancy"],
                    self.max_batch_size, 100.0 * r["pad_waste_frac"],
                    buckets, r["queue_depth"], r["queue_depth_max"]))



class DecodeStats:
    """Counters for one continuous-batching decode engine: stream
    admission, steps, tokens emitted and slot occupancy (mean fraction of
    slots active per step), and the latency window measured submit ->
    stream resolved."""

    def __init__(self, name: str, num_slots: int):
        self.name = name
        self.num_slots = int(num_slots)
        self._lock = make_lock("serve.stats")
        self._submitted = 0
        self._admitted = 0
        self._completed = 0
        self._captured = 0
        self._failed = 0
        self._expired = 0
        self._cancelled = 0
        self._overloaded = 0
        self._reloads = 0
        self._steps = 0
        self._slot_steps = 0
        self._tokens_out = 0
        self._queue_depth = 0
        self._queue_depth_max = 0
        self._lat_ms = collections.deque(maxlen=LATENCY_WINDOW)

    # -- recording ---------------------------------------------------------
    def on_submit(self, queue_depth: int) -> None:
        with self._lock:
            self._submitted += 1
            self._queue_depth = queue_depth
            if queue_depth > self._queue_depth_max:
                self._queue_depth_max = queue_depth

    def on_overload(self) -> None:
        with self._lock:
            self._overloaded += 1

    def on_admitted(self, n: int = 1) -> None:
        with self._lock:
            self._admitted += n

    def on_expired(self, n: int = 1) -> None:
        with self._lock:
            self._expired += n

    def on_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self._cancelled += n

    def on_failed(self, n: int = 1) -> None:
        with self._lock:
            self._failed += n

    def on_step(self, active: int, emitted: int) -> None:
        with self._lock:
            self._steps += 1
            self._slot_steps += active
            self._tokens_out += emitted

    def on_complete(self, latencies_ms) -> None:
        with self._lock:
            self._completed += len(latencies_ms)
            self._lat_ms.extend(latencies_ms)

    def on_reload(self) -> None:
        with self._lock:
            self._reloads += 1

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = depth

    def _outstanding_locked(self) -> int:
        """Terminal-outcome balance — EVERY new terminal counter must be
        subtracted here and only here (lock held by the caller)."""
        return max(0, self._submitted - self._completed - self._failed
                   - self._expired - self._cancelled)

    def on_captured(self) -> None:
        """A completed stream was offered to a router's capture hook and
        kept: not a terminal outcome (the request already completed), so
        it stays out of the outstanding balance; captured / completed is
        the sampled rate."""
        with self._lock:
            self._captured += 1

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding_locked()

    # -- reading -----------------------------------------------------------
    def report(self) -> Dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            out = {
                "kind": "decode",
                "num_slots": self.num_slots,
                "outstanding": self._outstanding_locked(),
                "submitted": self._submitted,
                "admitted": self._admitted,
                "completed": self._completed,
                "overloaded": self._overloaded,
                "expired": self._expired,
                "cancelled": self._cancelled,
                "failed": self._failed,
                "reloads": self._reloads,
                "captured": self._captured,
                "capture_rate": round(self._captured / self._completed, 4)
                if self._completed else 0.0,
                "steps": self._steps,
                "tokens_out": self._tokens_out,
                "slot_occupancy": round(
                    self._slot_steps / (self._steps * self.num_slots), 4)
                if self._steps else 0.0,
                "queue_depth": self._queue_depth,
                "queue_depth_max": self._queue_depth_max,
            }
        out["latency_p50_ms"] = round(_percentile(lat, 50), 3)
        out["latency_p95_ms"] = round(_percentile(lat, 95), 3)
        out["latency_p99_ms"] = round(_percentile(lat, 99), 3)
        return out

    def report_str(self) -> str:
        r = self.report()
        return ("decode engine %r\n"
                "  streams: %d submitted / %d admitted / %d completed "
                "(%d overloaded, %d expired, %d cancelled, %d failed), "
                "%d reloads\n"
                "  latency ms: p50 %.2f  p95 %.2f  p99 %.2f\n"
                "  steps: %d, %d tokens out, slot occupancy %.2f of %d "
                "slots\n"
                "  queue depth: %d now / %d high-water" % (
                    self.name, r["submitted"], r["admitted"],
                    r["completed"], r["overloaded"], r["expired"],
                    r["cancelled"], r["failed"], r["reloads"],
                    r["latency_p50_ms"], r["latency_p95_ms"],
                    r["latency_p99_ms"], r["steps"], r["tokens_out"],
                    r["slot_occupancy"], self.num_slots,
                    r["queue_depth"], r["queue_depth_max"]))



class PagedStats(DecodeStats):
    """DecodeStats plus the paged-serving axes (see module docstring).
    ``dropped_streams`` is not a terminal counter (a dropped stream also
    counts failed); it is the gauge that must stay 0."""

    def __init__(self, name: str, num_slots: int, pool_blocks: int):
        super().__init__(name, num_slots)
        self.pool_blocks = int(pool_blocks)
        self._prefill_tokens = 0
        self._spec_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._dropped_streams = 0
        self._blocks_used = 0
        self._blocks_reserved = 0
        self._blocks_used_peak = 0
        self._it_ms = collections.deque(maxlen=LATENCY_WINDOW)

    # -- recording ---------------------------------------------------------
    def on_prefill(self, tokens: int) -> None:
        with self._lock:
            self._prefill_tokens += tokens

    def on_spec_round(self, proposed: int, accepted: int) -> None:
        with self._lock:
            self._spec_rounds += 1
            self._spec_proposed += proposed
            self._spec_accepted += accepted

    def on_dropped(self, n: int = 1) -> None:
        with self._lock:
            self._dropped_streams += n

    def on_inter_token(self, gaps_ms) -> None:
        with self._lock:
            self._it_ms.extend(gaps_ms)

    def set_pool(self, used: int, reserved: int) -> None:
        with self._lock:
            self._blocks_used = used
            self._blocks_reserved = reserved
            if used > self._blocks_used_peak:
                self._blocks_used_peak = used

    # -- reading -----------------------------------------------------------
    def report(self) -> Dict:
        out = super().report()
        with self._lock:
            it = sorted(self._it_ms)
            out.update({
                "kind": "paged",
                "prefill_tokens": self._prefill_tokens,
                "spec_rounds": self._spec_rounds,
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "spec_accept_rate": round(
                    self._spec_accepted / self._spec_proposed, 4)
                if self._spec_proposed else 0.0,
                "dropped_streams": self._dropped_streams,
                "kv_blocks": self.pool_blocks,
                "kv_blocks_used": self._blocks_used,
                "kv_blocks_reserved": self._blocks_reserved,
                "kv_utilization": round(
                    self._blocks_used / self.pool_blocks, 4)
                if self.pool_blocks else 0.0,
                # the peak outlives the streams that made it
                "kv_utilization_peak": round(
                    self._blocks_used_peak / self.pool_blocks, 4)
                if self.pool_blocks else 0.0,
            })
        out["inter_token_p50_ms"] = round(_percentile(it, 50), 3)
        out["inter_token_p99_ms"] = round(_percentile(it, 99), 3)
        return out

    def report_str(self) -> str:
        r = self.report()
        return ("paged decode engine %r\n"
                "  streams: %d submitted / %d admitted / %d completed "
                "(%d overloaded, %d expired, %d cancelled, %d failed, "
                "%d dropped)\n"
                "  latency ms: p50 %.2f  p99 %.2f; inter-token p50 %.2f "
                "p99 %.2f\n"
                "  steps: %d, %d tokens out, %d prefill tokens, slot "
                "occupancy %.2f of %d\n"
                "  spec decode: %d rounds, %d proposed, %d accepted "
                "(rate %.2f)\n"
                "  kv pool: %d used / %d reserved / %d blocks "
                "(util %.2f)\n"
                "  queue depth: %d now / %d high-water" % (
                    self.name, r["submitted"], r["admitted"],
                    r["completed"], r["overloaded"], r["expired"],
                    r["cancelled"], r["failed"], r["dropped_streams"],
                    r["latency_p50_ms"], r["latency_p99_ms"],
                    r["inter_token_p50_ms"], r["inter_token_p99_ms"],
                    r["steps"], r["tokens_out"], r["prefill_tokens"],
                    r["slot_occupancy"], self.num_slots,
                    r["spec_rounds"], r["spec_proposed"],
                    r["spec_accepted"], r["spec_accept_rate"],
                    r["kv_blocks_used"], r["kv_blocks_reserved"],
                    r["kv_blocks"], r["kv_utilization"],
                    r["queue_depth"], r["queue_depth_max"]))
