"""DecodeEngine: continuous batching for stateful autoregressive decode
on the card (counterpart of ``mxnet_tpu/serve/decode.py``).

One request is a whole token stream, each step consuming the previous
step's hidden state.  The engine owns ``num_slots`` decode slots, the
batch axis of one bound decode-step executor (fixed slot count, fixed
shapes):

* per-slot recurrent state (hidden and cell vectors) lives on the device
  across steps: each step's state outputs are copied into the state
  input buffers on the decode thread's stream, so the next step reads
  them in order; the host ships one int token per slot per step and
  reads one back (the device argmax, in one synchronizing copy);
* new requests join freed slots between steps: the slot's state rows are
  zeroed on the device and its first prompt token staged;
* a finished stream resolves its future at the step its stop condition
  hits; it never waits for the rest of the batch.

The decode-step symbol contract::

    tok  = mx.sym.Variable("data")        # (S,) int32 token ids
    h    = mx.sym.Variable("h")           # (S, H) per-slot state
    ...                                   # one RNN/attention cell
    out  = mx.sym.Group([logits, h_next]) # output 0: (S, V) logits
                                          # output 1: next value of "h"

    eng = mx.serve.DecodeEngine(
        out, params, state_shapes={"h": (H,)})  # state_outputs={"h": 1}
    fut = eng.submit([1, 5, 3], max_new_tokens=32, eos_id=0)
    tokens = fut.result(timeout=30)       # np.int32 array of new tokens

Prompt tokens are teacher-forced through the same step (the stream emits
nothing while its prompt drains); after the prompt, each step's greedy
token feeds back as the next input.  Hot weight reload uses a drain
barrier: admissions pause, in-flight streams finish under the weights
they started with, then the swap lands and admission resumes, so a
stream's tokens never mix weight versions.  Steps run eagerly, one
executor forward each (the JAX package runs one compiled step program);
each passes the ``decode.step`` fault point.

It runs on ``gpu(dev_id)`` unless ``dev_type="cpu"`` is asked for.
Knobs: ``MXNET_SERVE_SLOTS`` (8), ``MXNET_SERVE_DECODE_QUEUE`` (4x
slots), ``MXNET_SERVE_MAX_TOKENS`` (128).  Each stream is one
``serve:decode_request`` async span (begin at submit, an instant at
admission, one end at whichever outcome closes it); each step is a
``serve:decode_step`` span and a ``serve:decode_slots`` counter.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace as _trace
from ..base import get_env, make_condition, open_stream
from ..faults import point as _fault_point
from ..predictor import Predictor, load_checkpoint_pair
from ..symbol import load_json as _sym_load_json
from .batcher import _IDLE_POLL_S, _set_exception, _set_result
from .engine import exec_device_bytes
from .errors import (ServeClosedError, ServeDeadlineError, ServeError,
                     ServeOverloadError, ServeRequestError)
from .stats import DecodeStats

__all__ = ["DecodeEngine"]


def _trace_end(req: "_DecodeRequest", outcome: str) -> None:
    """Close a stream's async span with its outcome (once: every
    terminal path calls this exactly once)."""
    if req.trace_id is not None and _trace.enabled():
        _trace.async_end("serve:decode_request", req.trace_id, cat="serve",
                         outcome=outcome)


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


def validate_prompt(prompt) -> np.ndarray:
    """A prompt as a non-empty 1-D int64 array, or ServeRequestError."""
    arr = np.asarray(prompt)
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if arr.ndim != 1 or arr.size < 1:
        raise ServeRequestError(
            "prompt must be a non-empty 1-D token-id sequence, got "
            "shape %s" % (tuple(arr.shape),))
    if arr.dtype.kind not in "iu":
        if arr.dtype.kind == "f" and np.all(arr == np.floor(arr)):
            arr = arr.astype(np.int64)
        else:
            raise ServeRequestError(
                "prompt dtype %s is not integral token ids" % arr.dtype)
    return arr.astype(np.int64)


class _Slot:
    __slots__ = ("req", "pos", "emitted", "next_tok")

    def __init__(self, req: _DecodeRequest):
        self.req = req
        self.pos = 0                    # prompt cursor
        self.emitted: List[int] = []
        self.next_tok = int(req.prompt[0])


class DecodeEngine:
    """Slot-based continuous-batching server for a stateful decode-step
    symbol (see module docstring).

    Parameters
    ----------
    symbol : Symbol | str
        The per-step graph: inputs are the token ids (``data_name``,
        shape ``(num_slots,)`` int32) plus one variable per recurrent
        state; outputs are the step logits (``output_index``) plus the
        next value of every state.
    params : dict
        Parameter blob (``arg:``/``aux:`` prefixes accepted).
    state_shapes : dict name -> per-slot row shape
        Recurrent state variables and their per-slot shapes, e.g.
        ``{"h": (256,), "c": (256,)}``, bound at ``(num_slots,) + shape``.
    state_outputs : dict name -> output index, optional
        Which output carries each state's next value.  Default: outputs
        ``1..len(state_shapes)`` in ``state_shapes`` order.
    num_slots / max_new_tokens / queue_depth / deadline_ms / eos_id :
        Slots (``MXNET_SERVE_SLOTS``, 8), the per-request generation cap
        (``MXNET_SERVE_MAX_TOKENS``, 128), the admission-queue bound
        (``MXNET_SERVE_DECODE_QUEUE``, 4x slots), the default admission
        deadline in ms (0 = none: a request still queued past it fails
        with ServeDeadlineError) and the default stop token.
    sample : callable, optional
        ``f(logits: np.ndarray (S, V)) -> (S,) ints`` replacing the
        device argmax (greedy decode).
    dev_type / dev_id : where the engine runs (default ``gpu(0)``).
    moe_hits_state / moe_stats_every : a routed decode graph's per-slot
        expert-hit state (``moe.hit_symbols`` added onto it), sampled
        into ``mx.profiler.moe_report()`` every N steps
        (``MXNET_MOE_STATS_EVERY``, 16).
    """

    def __init__(self, symbol, params: Dict, *,
                 state_shapes: Dict[str, Tuple[int, ...]],
                 state_outputs: Optional[Dict[str, int]] = None,
                 num_slots: Optional[int] = None,
                 data_name: str = "data", output_index: int = 0,
                 max_new_tokens: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 sample=None,
                 dev_type: str = "gpu", dev_id: int = 0,
                 type_dict: Optional[Dict] = None,
                 name: str = "decode", warmup: bool = True,
                 pipeline=None,
                 moe_hits_state: Optional[str] = None,
                 moe_stats_every: Optional[int] = None):
        if num_slots is None:
            num_slots = get_env("MXNET_SERVE_SLOTS", 8, int)
        self.num_slots = int(num_slots)
        if self.num_slots < 1:
            raise ServeError("num_slots must be >= 1, got %d"
                             % self.num_slots)
        if max_new_tokens is None:
            max_new_tokens = get_env("MXNET_SERVE_MAX_TOKENS", 128, int)
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ServeError("max_new_tokens must be >= 1, got %d"
                             % self.max_new_tokens)
        if queue_depth is None:
            queue_depth = get_env("MXNET_SERVE_DECODE_QUEUE",
                                  4 * self.num_slots, int)
        self.queue_depth = int(queue_depth)
        if self.queue_depth < 1:
            raise ServeError("queue_depth must be >= 1, got %d"
                             % self.queue_depth)
        self.deadline_ms = float(deadline_ms) if deadline_ms else None
        self.eos_id = eos_id
        self.data_name = data_name
        self.name = name
        self.weights_version = 0
        self._output_index = int(output_index)
        self._state_shapes = {k: tuple(v) for k, v in state_shapes.items()}
        if state_outputs is None:
            state_outputs = {k: i + 1
                             for i, k in enumerate(self._state_shapes)}
        self._state_outputs = {k: int(v) for k, v in state_outputs.items()}
        if set(self._state_outputs) != set(self._state_shapes):
            raise ServeError(
                "state_outputs names %s must match state_shapes names %s"
                % (sorted(self._state_outputs), sorted(self._state_shapes)))
        idxs = list(self._state_outputs.values())
        if len(set(idxs)) != len(idxs) or self._output_index in idxs:
            raise ServeError(
                "state output indices must be distinct and differ from "
                "output_index %d, got %s" % (self._output_index, idxs))

        S = self.num_slots
        shapes = {data_name: (S,)}
        for k, row in self._state_shapes.items():
            shapes[k] = (S,) + row
        tdict = {data_name: np.int32}
        tdict.update(type_dict or {})
        sym_json = symbol.tojson() if hasattr(symbol, "tojson") else symbol
        if not sym_json.lstrip().startswith("{"):
            with open_stream(sym_json) as f:
                sym_json = f.read()
        # check the decode contract against the raw graph before the
        # bind: a bad state name fails naming this engine's contract
        raw_sym = _sym_load_json(sym_json)
        raw_args = set(raw_sym.list_arguments())
        if data_name not in raw_args:
            raise ServeError(
                "data_name %r is not an argument of the decode symbol "
                "(arguments: %s)" % (data_name, sorted(raw_args)))
        for k in self._state_shapes:
            if k not in raw_args:
                raise ServeError(
                    "state %r is not an argument of the decode symbol "
                    "(arguments: %s)" % (k, sorted(raw_args)))
        n_out = len(raw_sym.list_outputs())
        bad = [i for i in [self._output_index] + idxs if not 0 <= i < n_out]
        if bad:
            raise ServeError(
                "output indices %s out of range: symbol has %d outputs (%s)"
                % (bad, n_out, raw_sym.list_outputs()))
        self._predictor = Predictor(sym_json, params, shapes,
                                    dev_type, dev_id, type_dict=tdict,
                                    pipeline=pipeline)
        self._exec = self._predictor._exec
        self.device = self._predictor.ctx.torch_device()
        for k in self._state_shapes:
            if k in self._predictor._arg_params:
                raise ServeError(
                    "state %r collides with a checkpoint parameter — "
                    "per-slot state must be a free input variable" % k)

        self._tok_host = np.zeros(
            (S,), self._exec.arg_dict[data_name].dtype)
        self._user_sample = sample

        self.stats = DecodeStats(name, S)
        from .. import profiler
        profiler.register_serve_stats(self.stats)

        # a routed decode graph accumulates its per-slot (S, E) expert
        # hits as one more slot state; naming it samples it into
        # moe_report() every moe_stats_every steps, on the decode thread
        self.moe_stats = None
        self._moe_hits_state = moe_hits_state
        if moe_hits_state is not None:
            if moe_hits_state not in self._state_shapes:
                raise ServeError(
                    "moe_hits_state %r is not a declared state (states: "
                    "%s)" % (moe_hits_state, sorted(self._state_shapes)))
            from ..moe.stats import MoeStats
            self.moe_stats = MoeStats("serve:%s" % name)
            profiler.register_moe_stats(self.moe_stats)
        if moe_stats_every is None:
            moe_stats_every = get_env("MXNET_MOE_STATS_EVERY", 16, int)
        self._moe_stats_every = max(1, int(moe_stats_every))
        self._moe_stats_n = 0

        # queue / slots / reload barrier: the decode thread owns the
        # slots and every device buffer; the condition guards the
        # request queue, the reload queue and the lifecycle flags
        self._cv = make_condition("serve.decode")
        self._q: collections.deque = collections.deque()
        self._reload_q: collections.deque = collections.deque()
        self._slots: List[Optional[_Slot]] = [None] * S
        self._active = 0
        self._closed = False
        self._drain = True

        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(warmup,), name="%s-decode" % name,
            daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._start_error is not None:
            self._thread.join()
            raise self._start_error

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, prefix: str, epoch: int, **kwargs
                        ) -> "DecodeEngine":
        """Serve a ``save_checkpoint`` pair's decode-step symbol and
        params."""
        sym_json, params = load_checkpoint_pair(prefix, epoch)
        return cls(sym_json, params, **kwargs)

    @classmethod
    def from_checkpoint_dir(cls, directory: str, symbol,
                            step: Optional[int] = None, **kwargs
                            ) -> "DecodeEngine":
        """Serve a ``mx.checkpoint`` store: the newest committed step (or
        ``step``), params and aux.  The store holds arrays, not the
        graph: pass the decode-step symbol."""
        from .engine import load_checkpoint_dir_params
        params, _meta = load_checkpoint_dir_params(directory, step)
        return cls(symbol, params, **kwargs)

    # -- device helpers (decode thread) ------------------------------------
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """(S, V) device logits -> (S,) host ints: the device argmax read
        back in one synchronizing copy, unless a sampler was supplied."""
        if self._user_sample is not None:
            return np.asarray(self._user_sample(logits.cpu().numpy()))
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _zero_state_row(self, slot_idx: int) -> None:
        """Zero one slot's row of every state buffer, on the device: a
        fresh stream must not read the previous occupant's state."""
        for sname in self._state_shapes:
            self._exec.arg_dict[sname]._get()[slot_idx].zero_()

    def _zero_states(self) -> None:
        for sname in self._state_shapes:
            self._exec.arg_dict[sname]._get().zero_()

    def _forward(self, toks: np.ndarray) -> np.ndarray:
        """One step: forward, copy each state output into its input
        buffer (queued on this thread's stream, so the next step reads
        it in order), sample."""
        p = self._predictor
        p.set_input(self.data_name, toks)
        p.forward()
        outs = self._exec.outputs
        for sname, oidx in self._state_outputs.items():
            self._exec.arg_dict[sname]._get().copy_(outs[oidx]._get())
        return self._sample(outs[self._output_index]._get())

    def _warmup(self) -> None:
        """Run the step once on the decode thread: the allocator's pools
        and the thread's cuBLAS/cuDNN handles are ready before the first
        request."""
        try:
            self._zero_state_row(0)
            self._forward(self._tok_host)
        except Exception as e:
            raise ServeError(
                "decode warmup step failed (slots=%d, states %s): %s: %s"
                % (self.num_slots, sorted(self._state_shapes.items()),
                   type(e).__name__, e)) from e
        finally:
            self._zero_states()

    # -- client API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None):
        """Enqueue one decode stream; returns a Future resolving to the
        np.int32 array of newly generated tokens (the prompt is not
        echoed).  Raises ServeRequestError / ServeOverloadError /
        ServeClosedError immediately, in this thread."""
        arr = validate_prompt(prompt)
        mn = self.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if mn < 1:
            raise ServeRequestError(
                "max_new_tokens must be >= 1, got %d" % mn)
        eos = self.eos_id if eos_id is None else eos_id
        dl = self.deadline_ms if deadline_ms is None else \
            (float(deadline_ms) or None)
        now = time.perf_counter()
        traced = _trace.enabled()
        req = _DecodeRequest(arr, mn, eos, Future(), now,
                             now + dl / 1000.0 if dl else None,
                             trace_id=_trace.next_async_id() if traced
                             else None)
        if traced:
            _trace.async_begin("serve:decode_request", req.trace_id,
                               cat="serve", prompt_len=int(arr.size))
        with self._cv:
            if self._closed:
                _trace_end(req, "closed")
                raise ServeClosedError(
                    "decode engine %r is closed" % self.name)
            if len(self._q) >= self.queue_depth:
                self.stats.on_overload()
                _trace_end(req, "overloaded")
                raise ServeOverloadError(
                    "decode queue full (%d queued, depth %d): shed load "
                    "or retry with backoff"
                    % (len(self._q), self.queue_depth))
            self._q.append(req)
            # inside the cv: ordered against _claim_locked's depth write
            self.stats.on_submit(len(self._q))
            self._cv.notify_all()
        return req.future

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kwargs) -> np.ndarray:
        """Blocking one-shot: submit + result."""
        return self.submit(prompt, **kwargs).result(timeout=timeout)

    # -- hot weight reload (drain barrier) ---------------------------------
    def reload(self, arg_params: Dict,
               aux_params: Optional[Dict] = None,
               timeout: Optional[float] = None) -> int:
        """Swap weights behind a drain barrier: admission pauses,
        in-flight streams finish under the weights they started with,
        then the swap lands on the decode thread and admission resumes.
        Blocks until applied; ``timeout`` (seconds) raises ServeError
        instead of waiting forever.  Returns the new weights version."""
        if threading.current_thread() is self._thread:
            raise ServeError(
                "reload() from the decode thread (a future callback?) "
                "would deadlock: the decode loop applies reloads")
        ev = threading.Event()
        holder: Dict = {}
        with self._cv:
            if self._closed:
                raise ServeClosedError(
                    "decode engine %r is closed" % self.name)
            self._reload_q.append((arg_params, aux_params, ev, holder))
            self._cv.notify_all()
        if not ev.wait(timeout):
            raise ServeError(
                "reload did not complete within %.1fs (in-flight streams "
                "still draining; raise the timeout or lower "
                "max_new_tokens)" % timeout)
        err = holder.get("error")
        if err is not None:
            raise err
        return holder["version"]

    def reload_from_checkpoint(self, prefix: str, epoch: int,
                               timeout: Optional[float] = None) -> int:
        _sym_json, params = load_checkpoint_pair(prefix, epoch)
        return self.reload(params, timeout=timeout)

    def reload_from_checkpoint_dir(self, directory: str,
                                   step: Optional[int] = None,
                                   timeout: Optional[float] = None) -> int:
        from .engine import load_checkpoint_dir_params
        params, _meta = load_checkpoint_dir_params(directory, step)
        return self.reload(params, timeout=timeout)

    # -- decode loop (one owner thread) ------------------------------------
    def _claim_locked(self) -> Optional[List[_DecodeRequest]]:
        """Pop admissible requests for the free slots (cv held): client
        cancellations win here, queue-expired deadlines fail here."""
        free = self.num_slots - self._active
        if free <= 0 or not self._q:
            return None
        out: List[_DecodeRequest] = []
        now = time.perf_counter()
        while self._q and len(out) < free:
            req = self._q.popleft()
            if not req.future.set_running_or_notify_cancel():
                self.stats.on_cancelled(1)
                _trace_end(req, "cancelled")
            elif req.deadline_t is not None and now > req.deadline_t:
                self.stats.on_expired(1)
                _trace_end(req, "expired")
                _set_exception(req.future, ServeDeadlineError(
                    "admission deadline exceeded: %.1f ms queued against "
                    "a %.1f ms deadline"
                    % ((now - req.enqueue_t) * 1e3,
                       (req.deadline_t - req.enqueue_t) * 1e3)))
            else:
                out.append(req)
        self.stats.set_queue_depth(len(self._q))
        return out or None

    def _join(self, reqs: List[_DecodeRequest]) -> None:
        """Seat each claimed request in a free slot: zero its state rows
        on the device, stage its first prompt token."""
        for req in reqs:
            slot_idx = self._slots.index(None)
            self._zero_state_row(slot_idx)
            self._slots[slot_idx] = _Slot(req)
            self._active += 1
            if req.trace_id is not None and _trace.enabled():
                _trace.async_instant("serve:decode_request", req.trace_id,
                                     cat="serve", at="admit",
                                     slot=slot_idx)
        self.stats.on_admitted(len(reqs))

    def _step(self) -> None:
        """One decode step for every active slot, then advance each
        stream (prompt teacher-forcing / emit / finish)."""
        slots = self._slots
        toks = self._tok_host
        for i, slot in enumerate(slots):
            if slot is not None:
                toks[i] = slot.next_tok
        n_active = self._active
        # stateful-decode seam: `delay` stretches a step, `error` kills
        # the decode loop (the replica-crash shape)
        _fault_point("decode.step", active=n_active)
        with _trace.span("serve:decode_step", cat="serve",
                         active=n_active, slots=self.num_slots):
            sampled = self._forward(toks)
        _trace.counter("serve:decode_slots", cat="serve",
                       active=n_active)
        emitted = 0
        done_lat: List[float] = []
        for i, slot in enumerate(slots):
            if slot is None:
                continue
            req = slot.req
            if slot.pos + 1 < len(req.prompt):
                # prompt not yet consumed: teacher-force the next token
                slot.pos += 1
                slot.next_tok = int(req.prompt[slot.pos])
                continue
            tok = int(sampled[i])
            slot.emitted.append(tok)
            emitted += 1
            if len(slot.emitted) >= req.max_new or \
                    (req.eos_id is not None and tok == req.eos_id):
                if _set_result(req.future,
                               np.asarray(slot.emitted, np.int32)):
                    done_lat.append(
                        (time.perf_counter() - req.enqueue_t) * 1e3)
                _trace_end(req, "resolved")
                slots[i] = None
                self._active -= 1
            else:
                slot.next_tok = tok
        self.stats.on_step(n_active, emitted)
        if done_lat:
            self.stats.on_complete(done_lat)
        if self.moe_stats is not None:
            self._moe_stats_n += 1
            if self._moe_stats_n % self._moe_stats_every == 0:
                hits = self._exec.arg_dict[self._moe_hits_state]._get()
                hits = hits.sum(dim=0).double().cpu().numpy()
                self.moe_stats.set_hits(self._moe_hits_state, hits)
                _trace.counter(
                    "moe:expert_occupancy", cat="moe",
                    **{"e%d" % i: float(hits[i])
                       for i in range(hits.shape[0])})

    def _apply_reloads(self, pending) -> None:
        for arg_params, aux_params, ev, holder in pending:
            try:
                self._predictor.set_params(arg_params, aux_params)
                self.weights_version += 1
                holder["version"] = self.weights_version
                self.stats.on_reload()
            except Exception as e:
                holder["error"] = e
            ev.set()

    def _run(self, warmup: bool) -> None:
        """The decode thread: warm up on the engine's device, report
        readiness to the constructor, then serve."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            if warmup:
                self._warmup()
        except ServeError as e:
            self._start_error = e
            with self._cv:
                self._closed = True
            self._ready.set()
            return
        self._ready.set()
        self._loop()

    def _loop(self) -> None:
        try:
            while True:
                admitted = None
                pending = None
                with self._cv:
                    while (not self._closed and self._active == 0
                           and not self._q and not self._reload_q):
                        self._cv.wait(_IDLE_POLL_S)
                    if self._closed and not self._drain:
                        break
                    if self._reload_q:
                        # drain barrier: no admissions while a reload
                        # waits; pop it once the in-flight slots emptied
                        if self._active == 0:
                            pending = list(self._reload_q)
                            self._reload_q.clear()
                    else:
                        admitted = self._claim_locked()
                    if (self._closed and self._active == 0
                            and admitted is None and pending is None
                            and not self._q and not self._reload_q):
                        break
                if pending:
                    self._apply_reloads(pending)
                    continue
                if admitted:
                    self._join(admitted)
                if self._active:
                    self._step()
        finally:
            self._shutdown_tail()

    def _shutdown_tail(self) -> None:
        """Decode-thread epilogue: fail whatever remains (drain=False,
        or a step error) and release reload waiters — nothing may hang
        on a dead loop."""
        with self._cv:
            # the loop may be dying from an error (an injected
            # decode.step fault), not a close(): flip _closed so no new
            # submit can enqueue onto a dead loop
            self._closed = True
            leftovers = list(self._q)
            self._q.clear()
            reloads = list(self._reload_q)
            self._reload_q.clear()
            self.stats.set_queue_depth(0)
        exc = ServeClosedError(
            "decode engine %r closed before this stream finished"
            % self.name)
        failed = cancelled = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._slots[i] = None
            self._active -= 1
            _trace_end(slot.req, "closed")
            if _set_exception(slot.req.future, exc):
                failed += 1
        for req in leftovers:
            _trace_end(req, "closed")
            if _set_exception(req.future, exc):
                failed += 1
            else:
                cancelled += 1
        if failed:
            self.stats.on_failed(failed)
        if cancelled:
            self.stats.on_cancelled(cancelled)
        for _p, _a, ev, holder in reloads:
            holder["error"] = ServeClosedError(
                "decode engine %r closed before this reload applied"
                % self.name)
            ev.set()

    # -- introspection / lifecycle -----------------------------------------
    def pending_requests(self) -> int:
        with self._cv:
            return len(self._q)

    def outstanding(self) -> int:
        """Streams admitted or queued and not yet resolved."""
        return self.stats.outstanding()

    def device_bytes(self) -> int:
        """Device footprint: parameters, state and input buffers of the
        decode-step executor (transient step outputs excluded), the
        multiplexer's admission currency."""
        return exec_device_bytes([self._exec])

    def close(self, drain: bool = True) -> None:
        """Stop admissions; ``drain=True`` (default) finishes every
        queued and in-flight stream first, ``drain=False`` fails them
        with ServeClosedError.  Thread-safe and idempotent; from the
        decode thread itself (a future done-callback) this degrades to
        a non-joining shutdown request."""
        with self._cv:
            self._closed = True
            if not drain:
                self._drain = False
            self._cv.notify_all()
        if threading.current_thread() is self._thread:
            return
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
