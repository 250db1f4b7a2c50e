"""Multi-process sharded readers: scale the host input pipeline past
one core (counterpart of ``mxnet_tpu/feed/parallel.py``).

:class:`ParallelReader` is a feed-pipeline head stage that forks N
worker PROCESSES (the GIL bounds the thread-pool decode path at ~1 core
of real Python/PIL work).  Each worker owns a deterministic shard of the source
— records ``i % N == w`` of a RecordIO file, or every N-th file of a
file list — streams it with chunked ``pread`` (recordio.stream_records:
the file is never materialized), decodes and augments in-process, and
publishes fixed-shape sample buffers into a single-producer/single-
consumer shared-memory ring.  The parent drains the rings in a
DETERMINISTIC round-robin, smooths the shard interleave through a
seeded global-shuffle window (the TensorFlow input-service design:
"ordered enough" for SGD, reproducible for checkpointing), and emits
``(sample, label)`` items into the ordinary staged pipeline.

Delivery is a pure function of ``(seed, epoch, delivered_count)``;
everything else follows from that one invariant:

* **crash recovery** — a worker killed mid-epoch is detected (ring
  empty + process dead), its ring is drained then reset, and a
  replacement forks resuming at the exact next shard offset: the
  delivered stream is IDENTICAL to a crash-free run (no lost or
  duplicated samples);
* **cursors** — ``state()`` is ``(epoch, delivered)`` plus derived
  per-worker ``(epoch, offset)`` positions; ``fast_restore`` re-runs
  the pull/shuffle schedule as a pure integer simulation (no decode),
  restarts each worker at the earliest shard offset still needed, and
  re-pulls only the ~window's worth of samples that were in flight —
  mid-epoch resume is exact and costs O(window/N) decodes per worker.

Backpressure: a full ring blocks its worker (bounded memory); the
parent's round-robin pull blocks on the slowest worker (the price of
determinism — the shuffle window exists so shard interleave, not pull
order, provides the shuffling).

The workers run numpy and file reads only -- no torch op, no CUDA call
-- so forking a parent whose CUDA context (and OpenMP pool) is live is
safe.  The shuffle is numpy's in both packages, so the delivered order
equals the reference's for the same seed and workers.  The reference's
per-worker decode spans (its trace spill files) wait for the trace
timeline (ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import ctypes
import multiprocessing as mp
import threading
import time
import traceback
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..base import MXNetError, get_env
from ..faults import point as _fault_point
from ..faults.retry import Backoff, RestartWindow
from .pipeline import EndOfEpoch, EndOfStream, QueueClosed, Stage

__all__ = ["ParallelReader"]

# slot states
_EMPTY, _FULL = 0, 1
# slot kinds
_DATA, _EPOCH_END, _STREAM_END, _ERROR = 0, 1, 2, 3

_POLL_S = 0.0005
_LIVENESS_EVERY = 100        # poll loops between worker liveness checks


class _WorkerStop(Exception):
    """Raised inside a worker's ring wait when shutdown is requested."""


class _Ring:
    """SPSC fixed-slot ring over an anonymous shared mmap (mp.RawArray,
    inherited by fork).  Slot layout::

        int64[4] header: [state, kind, epoch, seq]
        float32[label_width] label
        uint8[sample_nbytes] sample

    The producer fills payload THEN flips ``state`` to FULL; the
    consumer copies out THEN flips it to EMPTY — a half-written slot
    from a killed worker is simply never FULL, so the parent can always
    trust a FULL slot.  Every ``state`` transition (and the read that
    observes it) goes through a per-ring lock: the acquire/release
    pairs are the memory barriers that make the payload stores visible
    before FULL, and the copy-out loads complete before EMPTY — plain
    stores alone would be unsound on weakly-ordered CPUs (ARM hosts).
    The lock is SPSC-uncontended, so the cost is two cheap futex-free
    operations per slot.  Each side keeps its own cursor; ``reset()``
    (parent-only, with no live producer) rewinds both for a restarted
    worker."""

    _HDR = 32

    def __init__(self, slots: int, sample_shape, sample_dtype, label_width,
                 ctx):
        self.slots = int(slots)
        self.sample_shape = tuple(sample_shape)
        self.sample_dtype = np.dtype(sample_dtype)
        self.label_width = int(label_width)
        self.sample_nbytes = int(np.prod(self.sample_shape)
                                 * self.sample_dtype.itemsize)
        body = self._HDR + 4 * self.label_width + self.sample_nbytes
        self.slot_nbytes = -(-body // 64) * 64        # 64B-align slots
        self._raw = mp.RawArray(ctypes.c_uint8,
                                self.slots * self.slot_nbytes)
        self._lock = ctx.Lock()
        self._read_i = 0          # parent-side cursor
        self._write_i = 0         # child-side cursor (fork copies it)

    def _hdr(self, i: int):
        return np.frombuffer(self._raw, np.int64, 4, i * self.slot_nbytes)

    def _label_view(self, i: int):
        return np.frombuffer(self._raw, np.float32, self.label_width,
                             i * self.slot_nbytes + self._HDR)

    def _sample_view(self, i: int):
        return np.frombuffer(self._raw, np.uint8, self.sample_nbytes,
                             i * self.slot_nbytes + self._HDR
                             + 4 * self.label_width)

    # -- producer (worker process) ---------------------------------------
    def put(self, kind: int, epoch: int, seq: int, label=None, sample=None,
            stop=None) -> None:
        i = self._write_i
        hdr = self._hdr(i)
        while True:
            with self._lock:       # acquire: order after consumer's copy
                if hdr[0] == _EMPTY:
                    break
            if stop is not None and stop.is_set():
                raise _WorkerStop()
            time.sleep(_POLL_S)
        self._fill_slot(i, hdr, kind, epoch, seq, label, sample)

    def _fill_slot(self, i, hdr, kind, epoch, seq, label, sample):
        if label is not None:
            lv = self._label_view(i)
            lv[:] = np.asarray(label, np.float32).reshape(-1)[:len(lv)]
        if sample is not None:
            np.copyto(self._sample_view(i),
                      np.ascontiguousarray(sample).reshape(-1)
                      .view(np.uint8))
        with self._lock:           # release: payload visible before FULL
            hdr[1], hdr[2], hdr[3] = kind, epoch, seq
            hdr[0] = _FULL
        self._write_i = (i + 1) % self.slots

    def put_error(self, msg: str) -> None:
        """Publish an in-band error marker with the SAME slot discipline
        as data (wait for EMPTY, payload before FULL): scribbling over
        an unread FULL slot would tear a sample the parent is copying
        out.  Bounded wait — if the parent never drains, the dying
        worker gives up and exits; the parent's liveness path then
        reports the death instead of the lost traceback."""
        i = self._write_i
        hdr = self._hdr(i)
        data = msg.encode("utf-8", "replace")[:self.sample_nbytes]
        deadline = time.monotonic() + 5.0
        while True:
            with self._lock:
                if hdr[0] == _EMPTY:
                    break
            if time.monotonic() > deadline:
                return
            time.sleep(_POLL_S)
        sv = self._sample_view(i)
        sv[:len(data)] = np.frombuffer(data, np.uint8)
        with self._lock:
            hdr[1], hdr[2], hdr[3] = _ERROR, 0, len(data)
            hdr[0] = _FULL

    # -- consumer (parent) ------------------------------------------------
    def try_get(self):
        """One item if the next slot is FULL, else None.  Data items are
        copied out (the slot is recycled immediately).  Lock waits are
        time-bounded: mp locks are not robust, so a worker killed inside
        its tiny critical section must read as "nothing available" (the
        caller's liveness check then restarts it and reset() swaps in a
        fresh lock) rather than hang the parent forever."""
        i = self._read_i
        hdr = self._hdr(i)
        if not self._lock.acquire(timeout=0.05):
            return None            # dead-held lock: treat as empty
        try:                       # acquire: payload stores now visible
            if hdr[0] != _FULL:
                return None
            kind, epoch, seq = int(hdr[1]), int(hdr[2]), int(hdr[3])
        finally:
            self._lock.release()
        if kind == _DATA:
            label = np.array(self._label_view(i))
            sample = (np.array(self._sample_view(i))
                      .view(self.sample_dtype).reshape(self.sample_shape))
            item = (kind, epoch, seq, sample,
                    label[0] if self.label_width == 1 else label)
        elif kind == _ERROR:
            msg = bytes(self._sample_view(i)[:seq]).decode("utf-8",
                                                           "replace")
            item = (kind, epoch, seq, msg, None)
        else:
            item = (kind, epoch, seq, None, None)
        # release: copy-out loads complete before EMPTY becomes visible.
        # Retry the acquire for a while: an alive-but-preempted producer
        # must be waited out (an unlocked EMPTY store would break the
        # barrier protocol); only a dead lock-holder — whose ring is
        # about to be reset anyway — falls through unlocked.
        got = False
        for _ in range(40):
            got = self._lock.acquire(timeout=0.05)
            if got:
                break
        try:
            hdr[0] = _EMPTY
        finally:
            if got:
                self._lock.release()
        self._read_i = (i + 1) % self.slots
        return item

    def reset(self, ctx=None) -> None:
        """Parent-only, with the producer dead: mark every slot EMPTY
        and rewind the read cursor for the replacement worker (whose
        fork re-copies ``_write_i = 0``).  The lock is REPLACED — the
        dead worker may have been killed while holding it, and mp locks
        are not robust; the replacement forks with the fresh one."""
        if ctx is not None:
            self._lock = ctx.Lock()
        for i in range(self.slots):
            self._hdr(i)[0] = _EMPTY
        self._read_i = 0
        self._write_i = 0


def _shard_stream(source, shard: int, nshards: int, offset: int):
    """Yield ``(label, payload_bytes)`` for THIS worker's shard, skipping
    its first ``offset`` samples.  RecordIO shards are records with
    ``index % nshards == shard`` (streamed via chunked pread — skipped
    and foreign records cost no payload copy); file-list shards take
    every N-th file."""
    kind = source[0]
    if kind == "rec":
        from .. import recordio
        start_global = shard + offset * nshards

        def want(i):
            return i % nshards == shard and i >= start_global

        for _idx, payload in recordio.stream_records(source[1], want=want):
            header, img = recordio.unpack(payload)
            label = np.asarray(header.label, np.float32).reshape(-1)
            yield (float(label[0]) if label.size == 1 else label), img
    elif kind == "files":
        paths, labels = source[1], source[2]
        seen = 0
        for i, path in enumerate(paths):
            if i % nshards != shard:
                continue
            if seen < offset:
                seen += 1
                continue
            seen += 1
            with open(path, "rb") as f:
                yield (labels[i] if labels is not None else float(i)), \
                    f.read()
    else:
        raise MXNetError("unknown ParallelReader source kind %r" % (kind,))


def _reader_worker(ring: _Ring, counters, stop, source, decode,
                   shard: int, nshards: int, start_epoch: int,
                   start_offset: int, max_epochs, label_width: int,
                   seed: int):
    """Worker-process main: stream the shard, decode, publish.  Lives
    across epochs (epoch-end markers flow in-band through the ring);
    exceptions are forwarded as in-band error slots (fail loud — a
    decode error is a data bug, not a crash to retry)."""
    try:
        epoch, offset = start_epoch, start_offset
        while max_epochs is None or epoch < max_epochs:
            seq = offset
            for label, payload in _shard_stream(source, shard, nshards,
                                                offset):
                if stop.is_set():
                    return
                # host-side augmentation draws (decode fns built on
                # np.random, e.g. make_jpeg_decode's crop/mirror) must
                # be a pure function of POSITION: forked workers all
                # inherit the parent's global RNG state (identical
                # draws across shards), and a crash-restarted or
                # fast-restored worker would otherwise re-decode its
                # in-flight samples with different crops than the
                # uninterrupted run — breaking the stream-identical
                # and exact-resume guarantees
                np.random.seed(np.random.SeedSequence(
                    [seed & 0x7fffffff, shard, epoch, seq])
                    .generate_state(1)[0])
                t0 = time.perf_counter()
                data, lab = decode((label, payload))
                dt = time.perf_counter() - t0
                # fires BEFORE the ring publish: a `crash` here loses
                # only this unpublished sample, and the refork re-enters
                # at exactly (epoch, seq) — the chaos suite proves the
                # delivered stream stays identical
                _fault_point("feed.worker_decode", shard=shard,
                             epoch=epoch, seq=seq)
                counters[1] += dt
                ring.put(_DATA, epoch, seq, lab, data, stop)
                counters[0] += 1
                seq += 1
            ring.put(_EPOCH_END, epoch, seq, stop=stop)
            epoch += 1
            offset = 0
            counters[2] = epoch
        ring.put(_STREAM_END, epoch, 0, stop=stop)
    except _WorkerStop:
        pass
    except BaseException:  # noqa: BLE001 — forwarded in-band
        try:
            ring.put_error("%s (reader worker %d)"
                           % (traceback.format_exc(), shard))
        except Exception:
            pass


class _ShuffleScheduler:
    """The deterministic pull/deliver schedule for one epoch.

    Drives BOTH the live run loop (pulls block on real rings) and the
    restore-time pure simulation (pull results come from shard sizes) —
    one code path, so the replayed schedule cannot drift from the
    original.  Protocol: ``next_action()`` returns ``("pull", w)``,
    ``("deliver", (w, seq))`` or ``("done", None)``; every pull must be
    answered with ``pull_result(got_data)`` before the next action.

    Shuffle discipline (the tf.data shuffle-buffer algorithm): samples
    enter a ``window_cap``-sized reservoir; once full, each new arrival
    evicts (delivers) a uniformly drawn element and takes its place; at
    epoch end the reservoir drains in random order.  Exactly ONE rng
    draw per delivered sample, in delivery order — the whole schedule
    is a pure function of (nworkers, window_cap, rng stream, shard
    sizes)."""

    def __init__(self, nworkers: int, window_cap: int, rng):
        self.nworkers = nworkers
        self.window_cap = max(0, int(window_cap))
        self.rng = rng
        self.pulled = [0] * nworkers
        self.finished: set = set()
        self.window: List[Tuple[int, int]] = []
        self._ready: deque = deque()
        self._rr = 0
        self._awaiting: Optional[int] = None

    def next_action(self):
        assert self._awaiting is None, "answer the pending pull first"
        if self._ready:
            return ("deliver", self._ready.popleft())
        if len(self.finished) < self.nworkers:
            w = self._rr
            while w in self.finished:
                w = (w + 1) % self.nworkers
            self._awaiting = w
            return ("pull", w)
        if self.window:
            j = int(self.rng.integers(len(self.window)))
            return ("deliver", self.window.pop(j))
        return ("done", None)

    def pull_result(self, got_data: bool) -> None:
        w = self._awaiting
        self._awaiting = None
        self._rr = (w + 1) % self.nworkers
        if not got_data:
            self.finished.add(w)
            return
        ref = (w, self.pulled[w])
        self.pulled[w] += 1
        if self.window_cap == 0:
            self._ready.append(ref)
        elif len(self.window) < self.window_cap:
            self.window.append(ref)
        else:
            j = int(self.rng.integers(self.window_cap))
            self._ready.append(self.window[j])
            self.window[j] = ref


class ParallelReader(Stage):
    """Head stage: N forked reader processes over a sharded source, a
    shared-memory ring per worker, deterministic round-robin + global-
    shuffle-window delivery.  See the module docstring for the design.

    Parameters
    ----------
    source : ``("rec", path)`` | ``("files", paths, labels)`` | str
        What to read; a bare string means a RecordIO path.
    decode : callable
        ``(label, payload_bytes) -> (sample_array, label_array)`` run
        INSIDE each worker; output must match ``sample_shape`` /
        ``sample_dtype`` exactly (fixed-shape ring slots).
    workers : int
        Reader processes (``MXNET_FEED_WORKERS`` is the conventional
        knob at the ``record_pipeline`` level).
    shuffle_window : int
        Global-shuffle reservoir size; 0 = deterministic round-robin
        interleave only (``MXNET_FEED_SHUFFLE_WINDOW``).
    seed : int
        Shuffle seed; the delivered stream is a pure function of
        ``(seed, epoch)``.
    hold : bool
        Start paused: workers fork and delivery begins only at
        :meth:`release` (or a :meth:`fast_restore`) — how a fresh
        iterator restores mid-epoch without first streaming epoch 0.
    """

    def __init__(self, source, decode: Callable, workers: int = 2,
                 sample_shape=(), sample_dtype=np.float32,
                 label_width: int = 1, shuffle_window: int = 0,
                 seed: int = 0, max_epochs: Optional[int] = None,
                 slots_per_worker: int = 8, hold: bool = False,
                 max_restarts: Optional[int] = None, name: str = "reader"):
        super().__init__(name)
        if "fork" not in mp.get_all_start_methods():
            raise MXNetError(
                "ParallelReader needs the fork start method (workers "
                "inherit rings and the decode closure); this platform "
                "has none — use the thread-pool MapStage path instead")
        if isinstance(source, str):
            source = ("rec", source)
        self._source = source
        self._decode = decode
        self._nworkers = max(1, int(workers))
        self._sample_shape = tuple(sample_shape)
        self._sample_dtype = np.dtype(sample_dtype)
        self._label_width = int(label_width)
        self._window = max(0, int(shuffle_window))
        self._seed = int(seed)
        self._max_epochs = max_epochs
        if max_restarts is None:
            max_restarts = get_env("MXNET_FEED_MAX_RESTARTS", 3, int)
        self._max_restarts = max_restarts
        # refork discipline: restarts are budgeted over a
        # SLIDING window (a worker that dies once an hour for a week is
        # healthy; one that dies max_restarts times inside the window is
        # a crash loop) and each refork waits out a seeded jittered
        # Backoff — a crash-looping decode bug can never hot-loop the
        # fork spinner, and the parent stays responsive throughout
        # (the backoff sleep polls the stop flag)
        window_s = get_env("MXNET_FEED_RESTART_WINDOW_S", 60.0, float)
        base_s = get_env("MXNET_FEED_RESTART_BACKOFF_S", 0.05, float)
        self._restart_windows = [RestartWindow(max_restarts, window_s)
                                 for _ in range(self._nworkers)]
        self._backoffs = [Backoff(base_s=base_s, factor=2.0, max_s=2.0,
                                  jitter=0.25, seed=[seed, w],
                                  name="feed.refork")
                          for w in range(self._nworkers)]
        self._just_restarted = [False] * self._nworkers
        self._ctx = mp.get_context("fork")
        self._rings = [_Ring(slots_per_worker, self._sample_shape,
                             self._sample_dtype, self._label_width,
                             self._ctx)
                       for _ in range(self._nworkers)]
        self._counters = [mp.RawArray(ctypes.c_double, 4)
                          for _ in range(self._nworkers)]
        self._stop_evt = self._ctx.Event()
        self._procs: List[Optional[mp.Process]] = [None] * self._nworkers
        self._bufs = [deque() for _ in range(self._nworkers)]
        self.restarts = [0] * self._nworkers
        self._stopping = False
        self._gate = threading.Event()
        if not hold:
            self._gate.set()
        self._resume: Optional[dict] = None
        self._total: Optional[int] = None
        # per-worker shard sizes learned from consumed epoch-end markers
        # (their seq == the shard's sample count): lets cursor() simulate
        # without ever walking the file — a worker whose marker has NOT
        # been consumed cannot end inside any already-delivered range,
        # so "unknown" is exactly "unbounded" for those simulations
        self._observed_end: List[Optional[int]] = [None] * self._nworkers
        self._t0 = time.perf_counter()
        # memoized cursor simulation (state() is called per checkpoint
        # save with a monotonically growing `delivered`; advancing one
        # persistent sim keeps each call O(delta) not O(delivered))
        self._cursim: Optional[tuple] = None

    # -- public surface ----------------------------------------------------
    def release(self) -> None:
        """Open the start gate (no-op when not held)."""
        self._gate.set()

    def worker_pids(self) -> List[Optional[int]]:
        return [p.pid if p is not None else None for p in self._procs]

    def can_fast_restore(self) -> bool:
        """True while the reader is still held (fresh, nothing
        delivered): the window a cursor can be installed in."""
        return not self._gate.is_set()

    def start(self) -> None:
        if self.stats is not None:
            self.stats.wire_external(self._worker_stats)
        super().start()

    # -- sizes / cursors ---------------------------------------------------
    def _count_total(self) -> int:
        if self._total is None:
            kind = self._source[0]
            if kind == "rec":
                from .. import recordio
                self._total = recordio.count_records(self._source[1])
            else:
                self._total = len(self._source[1])
        return self._total

    def _shard_sizes(self) -> List[int]:
        total = self._count_total()
        n = self._nworkers
        return [max(0, (total - w + n - 1) // n) for w in range(n)]

    def _simulate(self, epoch: int, delivered: int, resume=None,
                  sizes=None):
        """Replay the epoch's schedule as pure integers: returns the
        scheduler (pulled counts, window refs, finished set) and its rng
        positioned exactly after ``delivered`` deliveries.  ``resume``
        continues a previously returned ``(sched, d)`` instead of
        starting from the epoch head (the cursor memoization);
        ``sizes`` supplies per-worker shard sizes (``inf`` = the worker
        cannot end inside the simulated range)."""
        if sizes is None:
            sizes = self._shard_sizes()
        if resume is not None:
            sched, d = resume
        else:
            rng = np.random.default_rng([self._seed, epoch])
            sched = _ShuffleScheduler(self._nworkers, self._window, rng)
            d = 0
        while d < delivered:
            act, arg = sched.next_action()
            if act == "pull":
                sched.pull_result(sched.pulled[arg] < sizes[arg])
            elif act == "deliver":
                d += 1
            else:              # fewer samples than the cursor asks for
                break
        return sched, d

    def cursor(self, epoch: int, delivered: int) -> dict:
        """Per-worker ``(epoch, offset)`` positions after ``delivered``
        samples of ``epoch`` — the reader half of a checkpoint cursor.
        ``offset`` counts shard samples CONSUMED into the delivered
        stream or the in-flight shuffle window.  Simulates against the
        OBSERVED shard ends (unknown = unbounded, exact for any already-
        delivered range), so a cursor never costs a file walk."""
        memo = self._cursim
        sizes = [s if s is not None else float("inf")
                 for s in self._observed_end]
        sched, d = self._simulate(
            epoch, delivered,
            resume=(memo[1], memo[2]) if memo is not None
            and memo[0] == epoch and memo[2] <= delivered else None,
            sizes=sizes)
        self._cursim = (epoch, sched, d)
        workers = {}
        for w in range(self._nworkers):
            done = w in sched.finished and not any(
                ww == w for ww, _ in sched.window)
            workers[str(w)] = {"epoch": epoch + 1 if done else epoch,
                               "offset": 0 if done else sched.pulled[w]}
        return {"epoch": epoch, "delivered": d, "workers": workers,
                "seed": self._seed, "nworkers": self._nworkers,
                "shuffle_window": self._window,
                "shard_sizes": list(self._observed_end)}

    def fast_restore(self, epoch: int, delivered: int,
                     saved: Optional[dict] = None) -> None:
        """Position a FRESH (held, unreleased) reader so its next
        delivery is sample ``delivered`` of ``epoch`` — without decoding
        the first ``delivered`` samples.  A pure-integer simulation
        reconstructs the schedule (against the cursor's saved shard
        sizes when it carries them — an unknown size was unbounded for
        the saved range, so no file walk is needed; a size-less legacy
        cursor falls back to one counting pass); each worker restarts
        at the earliest shard offset still inside the shuffle window;
        the run loop re-pulls only those in-flight samples before
        resuming."""
        if self._gate.is_set():
            raise MXNetError(
                "fast_restore needs a fresh, still-held ParallelReader "
                "(this one already started delivering)")
        sizes = None
        if saved is not None and \
                len(saved.get("shard_sizes") or []) == self._nworkers:
            # adopt the save-time observations: a cursor() taken right
            # after this restore (before the replay re-consumes the
            # markers) must simulate against the same shard bounds the
            # saved schedule used, not treat ended shards as unbounded
            for w, s in enumerate(saved["shard_sizes"]):
                if s is not None:
                    self._observed_end[w] = int(s)
            sizes = [s if s is not None else float("inf")
                     for s in saved["shard_sizes"]]
        sched, d = self._simulate(epoch, delivered, sizes=sizes)
        if d < delivered:
            raise MXNetError(
                "feed restore: epoch %d holds only %d samples but the "
                "cursor wants %d (did the dataset shrink between save "
                "and resume?)" % (epoch, d, delivered))
        window_set = set(sched.window)
        starts = []
        for w in range(self._nworkers):
            mine = [seq for ww, seq in window_set if ww == w]
            starts.append(min(mine) if mine else sched.pulled[w])
        self._resume = {"epoch": epoch, "sched": sched,
                        "starts": starts, "window_set": window_set,
                        "pulled": list(sched.pulled),
                        "finished": set(sched.finished)}
        self._gate.set()

    # -- worker management -------------------------------------------------
    def _spawn(self, w: int, epoch: int, offset: int) -> None:
        for c in range(4):
            self._counters[w][c] = self._counters[w][c] if c < 2 else 0.0
        proc = self._ctx.Process(
            target=_reader_worker,
            args=(self._rings[w], self._counters[w], self._stop_evt,
                  self._source, self._decode, w, self._nworkers, epoch,
                  offset, self._max_epochs, self._label_width,
                  self._seed),
            name="feed-%s-p%d" % (self.name, w), daemon=True)
        proc.start()
        self._procs[w] = proc

    def _restart(self, w: int, epoch: int, offset: int) -> None:
        self.restarts[w] += 1
        in_window = self._restart_windows[w].note()
        if in_window > self._max_restarts:
            raise MXNetError(
                "reader worker %d of %r died %d times within %.0fs "
                "(limit %d, MXNET_FEED_MAX_RESTARTS over "
                "MXNET_FEED_RESTART_WINDOW_S) — a crash loop, not a "
                "flake; giving up"
                % (w, self.name, in_window,
                   self._restart_windows[w].window_s, self._max_restarts))
        wait = self._backoffs[w].next_wait()
        # interruptible: close() flips _stopping and this returns in
        # ~one poll tick, so a backing-off parent never blocks shutdown
        self._backoffs[w].sleep(wait,
                                should_stop=lambda: self._stopping)
        if self._stopping:
            raise QueueClosed()
        proc = self._procs[w]
        if proc is not None:
            proc.join(timeout=1.0)
        self._rings[w].reset(ctx=self._ctx)
        self._spawn(w, epoch, offset)
        self._just_restarted[w] = True

    def _worker_stats(self) -> Dict[str, dict]:
        wall = max(time.perf_counter() - self._t0, 1e-9)
        out = {}
        for w in range(self._nworkers):
            c = self._counters[w]
            proc = self._procs[w]
            out["w%d" % w] = {
                "items": int(c[0]),
                "items_per_s": round(c[0] / wall, 2),
                "busy_s": round(c[1], 4),
                "epoch": int(c[2]),
                "restarts": self.restarts[w],
                "alive": bool(proc is not None and proc.is_alive()),
            }
        return out

    # -- the run loop ------------------------------------------------------
    def _pull(self, w: int, epoch: int, expect_seq: int):
        """Blocking read of worker ``w``'s next in-band item, with crash
        detection: ring empty + process dead => drain, reset, refork at
        exactly (epoch, expect_seq).  Returns a ring item tuple."""
        buf = self._bufs[w]
        ring = self._rings[w]
        ticks = 0
        while True:
            if buf:
                return buf.popleft()
            got = ring.try_get()
            if got is not None:
                if self._just_restarted[w]:
                    # the refork took: this worker's backoff rung resets
                    # (the sliding window still remembers the crash)
                    self._just_restarted[w] = False
                    self._backoffs[w].reset()
                return got
            if self._stopping:
                raise QueueClosed()
            ticks += 1
            if ticks % _LIVENESS_EVERY == 0:
                proc = self._procs[w]
                if proc is not None and not proc.is_alive():
                    while True:          # published-but-unread survivors
                        g = ring.try_get()
                        if g is None:
                            break
                        buf.append(g)
                    if buf:
                        return buf.popleft()
                    self._restart(w, epoch, expect_seq)
            time.sleep(_POLL_S)

    def _pull_data(self, w: int, epoch: int, sched: _ShuffleScheduler):
        """One schedule pull: returns ``(sample, label)`` or None at the
        worker's epoch end, verifying the (epoch, seq) the deterministic
        schedule expects — a restarted worker re-enters the stream at
        exactly this position."""
        expect = sched.pulled[w]
        item = self._pull(w, epoch, expect)
        kind, e, seq, a, b = item
        if kind == _ERROR:
            raise MXNetError("feed reader worker failed:\n%s" % a)
        if kind == _EPOCH_END:
            if e != epoch:
                raise MXNetError(
                    "reader %d epoch desync: marker for epoch %d while "
                    "delivering epoch %d" % (w, e, epoch))
            self._observed_end[w] = seq     # marker seq == shard size
            return None
        if kind == _STREAM_END:
            return None
        if (e, seq) != (epoch, expect):
            raise MXNetError(
                "reader %d sequence desync: got (epoch %d, seq %d), "
                "schedule expects (epoch %d, seq %d)"
                % (w, e, seq, epoch, expect))
        return (a, b)

    def run(self):
        while not self._gate.is_set():
            if self._stopping:
                raise QueueClosed()
            self._gate.wait(0.05)
        if self._stopping:        # stop() opens the gate to unblock us
            raise QueueClosed()
        resume = self._resume
        epoch = resume["epoch"] if resume is not None else 0
        # rate denominators start when workers exist, not at __init__:
        # held readers (record_pipeline) can sit through bind/compile
        # for a long time, and counting that idle interval would
        # understate every reported worker items/s
        self._t0 = time.perf_counter()
        for w in range(self._nworkers):
            start = resume["starts"][w] if resume is not None else 0
            self._spawn(w, epoch, start)
        payloads: Dict[Tuple[int, int], tuple] = {}
        if resume is not None:
            payloads = self._replay(resume, epoch)
        while self._max_epochs is None or epoch < self._max_epochs:
            if resume is not None:
                sched = resume["sched"]
                resume = None
            else:
                rng = np.random.default_rng([self._seed, epoch])
                sched = _ShuffleScheduler(self._nworkers, self._window, rng)
                payloads = {}
            while True:
                act, arg = sched.next_action()
                if act == "pull":
                    expect = sched.pulled[arg]
                    t0 = time.perf_counter()
                    data = self._pull_data(arg, epoch, sched)
                    self.stats.add_stall_in(time.perf_counter() - t0)
                    sched.pull_result(data is not None)
                    if data is not None:
                        payloads[(arg, expect)] = data
                elif act == "deliver":
                    self.stats.add_items(1)
                    self.out_q.put(payloads.pop(arg))
                else:
                    break
            self.out_q.put(EndOfEpoch(epoch))
            epoch += 1
        self.out_q.put(EndOfStream())

    def _replay(self, resume: dict, epoch: int):
        """Re-pull the in-flight window after a fast_restore: for each
        worker, consume shard samples ``[start, pulled)`` keeping only
        the refs the simulated window still holds, plus the epoch-end
        marker for workers the schedule already finished."""
        payloads: Dict[Tuple[int, int], tuple] = {}
        for w in range(self._nworkers):
            for seq in range(resume["starts"][w], resume["pulled"][w]):
                item = self._pull(w, epoch, seq)
                kind, e, sq, a, b = item
                if kind == _ERROR:
                    raise MXNetError("feed reader worker failed:\n%s" % a)
                if kind != _DATA or (e, sq) != (epoch, seq):
                    raise MXNetError(
                        "reader %d restore desync at (epoch %d, seq %d): "
                        "got kind %d (epoch %d, seq %d)"
                        % (w, epoch, seq, kind, e, sq))
                if (w, seq) in resume["window_set"]:
                    payloads[(w, seq)] = (a, b)
            if w in resume["finished"]:
                item = self._pull(w, epoch, resume["pulled"][w])
                if item[0] != _EPOCH_END:
                    raise MXNetError(
                        "reader %d restore desync: expected epoch-end "
                        "marker, got kind %d" % (w, item[0]))
                self._observed_end[w] = item[2]
        return payloads

    # -- shutdown ----------------------------------------------------------
    def stop(self):
        self._stopping = True
        self._stop_evt.set()
        self._gate.set()          # unblock a held run() thread
        deadline = time.monotonic() + 2.0
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=1.0)
