"""PagedDecodeEngine: continuous batching over a paged KV cache (counterpart
of ``mxnet_tpu/serve/paged/engine.py``).

The engine keeps the slot/queue/drain discipline of the JAX package's
decode engines and serves a transformer LM whose per-slot state is a KV
cache that grows with context:

* **paged KV cache** (pool.py) — K/V live in a shared pool of fixed-size
  blocks on the engine's device; each slot maps logical context onto
  physical blocks through a page table.  Admission reserves a stream's
  exact worst-case block count, so an admitted stream is never dropped:
  ``dropped_streams`` is 0 by design;
* **one step, two widths** — a step consumes a ``(num_slots, C)`` token
  window with a per-slot valid count; C = 1 is pure decode, C =
  ``chunk_tokens`` serves prefill chunks and speculative verification.
  Both widths run once on the decode thread before the loop starts, so
  the thread's cuBLAS handles, the allocator's pools and the kernel's
  library are ready before the first request;
* **chunked prefill** — a long prompt enters the batch ``chunk_tokens``
  tokens at a time beside in-flight decode slots, which keep emitting one
  token per step;
* **speculative decode** (spec.py) — a draft model sharing the pool's
  page table proposes K tokens per round, the target verifies K+1
  positions in ONE chunk-width step; greedy acceptance keeps the emitted
  stream token-identical to plain target decode;
* **attention** — on a CUDA device always the hand-written kernel
  (``ops.cuda_kernels.paged_attention``, csrc/paged_attention.cu); on the
  CPU its plain version.  Both reduce in an order fixed by logical
  position, so dense-stripe (``paged=False``) and scattered page tables
  produce bitwise-identical tokens — the parity baseline the tests pin.

KV appends are in-place ``index_put_`` writes into the pool's tensors;
invalid window positions write to the sentinel scratch row, a positive
index.  Each step copies its int32 inputs to the device in one transfer
and its (S, C) int32 argmax tokens back: one host sync per step.

Knobs: ``MXNET_KVPOOL_BLOCKS``, ``MXNET_KVPOOL_BLOCK_TOKENS``,
``MXNET_PAGED_CHUNK``, ``MXNET_SPEC_DECODE_K``, ``MXNET_SERVE_SLOTS``,
``MXNET_SERVE_DECODE_QUEUE``, ``MXNET_SERVE_MAX_TOKENS``.  There is no
knob that turns the kernel off.  Each step passes the ``paged.step``
fault point, and the engine's stats are a row of
``mx.profiler.serve_report()``.  Each stream is one
``serve:decode_request`` async span, each step a ``serve:paged_step``
span and a ``serve:paged_kv_blocks`` counter.  Under
``MXNET_COMPILE_CACHE`` the kernel's library comes from the persistent
store.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import trace as _trace
from ...base import get_env, make_condition
from ...context import Context, current_context
from ...convert import convert_lm_params
from ...faults import point as _fault_point
from ...ops import cuda_kernels as ck
from ..batcher import _IDLE_POLL_S, _set_exception, _set_result
from ..decode import _DecodeRequest, _trace_end, validate_prompt
from ..errors import (ServeClosedError, ServeDeadlineError, ServeError,
                      ServeOverloadError, ServeRequestError)
from ..stats import PagedStats
from .model import LMConfig, lm_forward, param_bytes
from .pool import KVBlockPool

__all__ = ["PagedDecodeEngine", "paged_step", "paged_forward"]


def paged_forward(params, kv_k, kv_v, tokens, pages, positions, n_valid,
                  lengths, *, cfg: LMConfig, use_kernel: bool
                  ) -> torch.Tensor:
    """One step over a (S, C) token window; returns (S, C, vocab) logits.

    tokens/positions (S, C) int32; pages (S, B) int32; n_valid (S,)
    int32 tokens valid per slot; lengths (S,) int32 context size AFTER
    this step's appends; kv_k/kv_v the pool view (layers, N + 1, bt, H,
    D), updated in place.  Appends each valid token's K/V through the
    page table, then attends causally over the paged context with the
    kernel (``use_kernel``) or its plain version.  Invalid window
    positions write to the sentinel scratch row ``N``, a positive index,
    so nothing wraps to block -1."""
    c = tokens.shape[1]
    bt = kv_k.shape[2]
    sentinel_row = kv_k.shape[1] - 1
    valid = torch.arange(c, dtype=torch.int32,
                         device=tokens.device)[None, :] < n_valid[:, None]
    logical = torch.clamp(torch.div(positions, bt, rounding_mode="floor"),
                          0, pages.shape[1] - 1)
    phys = torch.gather(pages, 1, logical.long())
    dest_blk = torch.where(valid, phys, sentinel_row).long()
    off = torch.remainder(positions, bt).long()
    attention = ck.paged_attention if use_kernel else \
        ck.paged_attention_reference

    def attend(layer, q, k_new, v_new):
        kp, vp = kv_k[layer], kv_v[layer]
        kp.index_put_((dest_blk, off), k_new)
        vp.index_put_((dest_blk, off), v_new)
        return attention(q, kp, vp, pages, lengths, positions, True)

    return lm_forward(params, tokens, positions, attend, cfg)


def paged_step(params, kv_k, kv_v, tokens, pages, positions, n_valid,
               lengths, *, cfg: LMConfig, use_kernel: bool) -> torch.Tensor:
    """:func:`paged_forward` and the greedy choice: (S, C) int32 argmax
    tokens on the device."""
    logits = paged_forward(params, kv_k, kv_v, tokens, pages, positions,
                           n_valid, lengths, cfg=cfg, use_kernel=use_kernel)
    return torch.argmax(logits, dim=-1).to(torch.int32)


class _PagedSlot:
    __slots__ = ("req", "pos", "cache_len", "emitted", "next_tok",
                 "draft_len", "last_emit_t")

    def __init__(self, req: _DecodeRequest):
        self.req = req
        self.pos = 0                    # prompt tokens consumed
        self.cache_len = 0              # target KV length (tokens)
        self.emitted: List[int] = []
        self.next_tok: Optional[int] = None
        self.draft_len = 0              # draft KV length (tokens)
        self.last_emit_t = time.perf_counter()

    def prefilling(self) -> bool:
        return self.pos < self.req.prompt.size

    def committed(self, idx: int) -> int:
        """Token at committed-sequence index (prompt then emitted)."""
        p = self.req.prompt.size
        return int(self.req.prompt[idx]) if idx < p \
            else int(self.emitted[idx - p])


class PagedDecodeEngine:
    """Continuous batching for a paged-KV transformer LM (see module
    docstring).

    Parameters
    ----------
    params : dict name -> array
        :func:`~.model.init_lm_params` blob for ``cfg`` (numpy arrays or
        tensors; moved to the engine's device).
    cfg : LMConfig
        Model geometry; ``cfg.max_context`` bounds
        ``prompt + max_new_tokens`` per stream.
    num_slots / max_new_tokens / queue_depth / deadline_ms / eos_id :
        Decode slots, per-stream defaults and admission bounds
        (``MXNET_SERVE_SLOTS`` 8, ``MXNET_SERVE_MAX_TOKENS`` 128,
        ``MXNET_SERVE_DECODE_QUEUE`` 4x slots).
    num_blocks / block_tokens : int, optional
        KV pool geometry (``MXNET_KVPOOL_BLOCKS`` — default
        dense-equivalent — / ``MXNET_KVPOOL_BLOCK_TOKENS``, 16).
    paged : bool
        False = dense baseline: every slot statically owns a full
        max-context block stripe, same step — the bitwise token-parity
        reference.
    chunk_tokens : int, optional
        Prefill chunk / verify width (``MXNET_PAGED_CHUNK``, 32); raised
        to ``spec_k + 1`` when speculative decode is on.
    draft_params / draft_cfg / spec_k :
        Speculative decode: draft blob + geometry and the proposal depth
        K (``MXNET_SPEC_DECODE_K``, 0 = off).
    ctx : Context, optional
        Where the engine runs; default :func:`current_context`, which is
        ``gpu(0)``.  Raises when that card is not there.
    use_kernel : bool, optional
        Whether attention runs the hand-written kernel.  It does on a
        CUDA device and cannot be turned off there; on the CPU the plain
        version runs.  Passing the other value raises.
    """

    def __init__(self, params: Dict, cfg: LMConfig, *,
                 num_slots: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 block_tokens: Optional[int] = None,
                 paged: bool = True,
                 chunk_tokens: Optional[int] = None,
                 draft_params: Optional[Dict] = None,
                 draft_cfg: Optional[LMConfig] = None,
                 spec_k: Optional[int] = None,
                 max_new_tokens: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 ctx: Optional[Context] = None,
                 use_kernel: Optional[bool] = None,
                 name: str = "paged", warmup: bool = True):
        self.device = (ctx if ctx is not None
                       else current_context()).torch_device()
        on_card = self.device.type == "cuda"
        if use_kernel is not None and bool(use_kernel) != on_card:
            raise ServeError(
                "use_kernel=%s on %s: the paged-attention kernel always "
                "runs on a CUDA device and only there" % (use_kernel,
                                                          self.device))
        self._use_kernel = on_card

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
        self.name = name
        self.cfg = cfg
        self.max_context = int(cfg.max_context)
        self.paged = bool(paged)

        if spec_k is None:
            spec_k = get_env("MXNET_SPEC_DECODE_K", 0, int)
        self.spec_k = int(spec_k) if draft_params is not None else 0
        if self.spec_k and draft_cfg is None:
            raise ServeError("spec_k > 0 needs draft_cfg with "
                             "draft_params")
        if chunk_tokens is None:
            chunk_tokens = get_env("MXNET_PAGED_CHUNK", 32, int)
        self.chunk = max(2, min(int(chunk_tokens), self.max_context))
        if self.spec_k:
            if self.spec_k + 1 > self.chunk:
                # the verify window must fit the chunk width
                self.chunk = self.spec_k + 1
            if draft_cfg.max_context < cfg.max_context:
                raise ServeError(
                    "draft max_context %d < target max_context %d"
                    % (draft_cfg.max_context, cfg.max_context))

        if block_tokens is None:
            block_tokens = get_env("MXNET_KVPOOL_BLOCK_TOKENS", 16, int)
        bt = int(block_tokens)
        max_blocks = -(-self.max_context // bt)
        if not self.paged:
            num_blocks = self.num_slots * max_blocks
        self._pool = KVBlockPool(self.num_slots, max_blocks,
                                 num_blocks=num_blocks, block_tokens=bt,
                                 dense=not self.paged, device=self.device)
        self._pool.add_view("target", cfg.layers, cfg.heads, cfg.head_dim)
        self._params = convert_lm_params(params, self.device)
        # forward passes run, by model: each runs the attention once per
        # layer (written by the decode thread only)
        self.forward_counts = {"target": 0, "draft": 0}

        self.stats = PagedStats(name, self.num_slots,
                                self._pool.num_blocks)
        from ... import profiler
        profiler.register_serve_stats(self.stats)

        self._spec = None
        if self.spec_k:
            from .spec import SpecDecoder
            self._spec = SpecDecoder(self, draft_params, draft_cfg)

        self._cv = make_condition("serve.paged")
        self._q: collections.deque = collections.deque()
        self._slots: List[Optional[_PagedSlot]] = [None] * self.num_slots
        self._active = 0
        self._closed = False
        self._drain = True

        self._ready = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(warmup,), name="%s-paged" % name,
            daemon=True)
        self._thread.start()
        self._ready.wait()
        if self._start_error is not None:
            self._thread.join()
            raise self._start_error

    # -- step plumbing -----------------------------------------------------
    def _to_device(self, tokens, positions, n_valid, lengths):
        """The step's int32 inputs and a snapshot of the page table, in
        one host-to-device copy."""
        s, c = tokens.shape
        pages = self._pool.page_table()
        host = np.concatenate([tokens.ravel(), positions.ravel(), n_valid,
                               lengths, pages.ravel()]).astype(np.int32)
        dev = torch.from_numpy(host).to(self.device)
        n = s * c
        return (dev[:n].view(s, c), dev[2 * n + 2 * s:].view(pages.shape),
                dev[n:2 * n].view(s, c), dev[2 * n:2 * n + s],
                dev[2 * n + s:2 * n + 2 * s])

    def _run_target(self, tokens, positions, n_valid, lengths) -> np.ndarray:
        kv_k, kv_v = self._pool.view("target")
        toks = paged_step(self._params, kv_k, kv_v,
                          *self._to_device(tokens, positions, n_valid,
                                           lengths),
                          cfg=self.cfg, use_kernel=self._use_kernel)
        self._pool.set_view("target", kv_k, kv_v)
        self.forward_counts["target"] += 1
        return toks.cpu().numpy()       # the step's ONE host sync

    def _staging(self, c: int):
        s = self.num_slots
        return (np.zeros((s, c), np.int32), np.zeros((s, c), np.int32),
                np.zeros((s,), np.int32), np.zeros((s,), np.int32))

    def _warmup(self) -> None:
        """Run every step width (C = 1 and C = chunk, target and draft)
        once, on the decode thread.  Zero-valid windows write only to the
        sentinel scratch row, so the logical cache stays untouched."""
        try:
            for c in (1, self.chunk):
                self._run_target(*self._staging(c))
            if self._spec is not None:
                for c in (1, self.chunk):
                    self._spec.run(*self._staging(c))
        except Exception as e:
            raise ServeError(
                "paged step warmup failed (slots=%d, chunk=%d, cfg=%s, "
                "device=%s): %s: %s" % (self.num_slots, self.chunk,
                                        (self.cfg,), self.device,
                                        type(e).__name__, e)) from e

    # -- client API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one decode stream; the Future resolves to the np.int32
        array of newly generated tokens (prompt not echoed).  Raises
        ServeRequestError / ServeOverloadError / ServeClosedError
        immediately, in this thread."""
        arr = validate_prompt(prompt)
        if int(arr.min()) < 0 or int(arr.max()) >= self.cfg.vocab:
            raise ServeRequestError(
                "prompt token ids must be in [0, %d)" % self.cfg.vocab)
        mn = self.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if mn < 1:
            raise ServeRequestError(
                "max_new_tokens must be >= 1, got %d" % mn)
        if arr.size + mn > self.max_context:
            raise ServeRequestError(
                "prompt (%d) + max_new_tokens (%d) exceeds max_context "
                "%d" % (arr.size, mn, self.max_context))
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
                    "paged engine %r is closed" % self.name)
            if len(self._q) >= self.queue_depth:
                self.stats.on_overload()
                _trace_end(req, "overloaded")
                raise ServeOverloadError(
                    "paged decode queue full (%d queued, depth %d): "
                    "shed load or retry with backoff"
                    % (len(self._q), self.queue_depth))
            self._q.append(req)
            self.stats.on_submit(len(self._q))
            self._cv.notify_all()
        return req.future

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kwargs) -> np.ndarray:
        """Blocking one-shot: submit + result."""
        return self.submit(prompt, **kwargs).result(timeout=timeout)

    # -- decode loop (one owner thread) ------------------------------------
    def _blocks_for(self, req: _DecodeRequest) -> int:
        return self._pool.blocks_for(req.prompt.size + req.max_new)

    def _claim_locked(self) -> Optional[List[_DecodeRequest]]:
        """Pop admissible requests for the free slots (cv held).
        Admission is FIFO with exact block reservation: when the head
        stream's worst-case blocks do not fit the pool, nothing behind it
        is admitted either (no head-of-line skipping)."""
        free = self.num_slots - self._active
        if free <= 0 or not self._q:
            return None
        out: List[_DecodeRequest] = []
        budget = self._pool.available_blocks()
        now = time.perf_counter()
        while self._q and len(out) < free:
            head = self._q[0]
            need = self._blocks_for(head)
            if need > budget and not head.future.cancelled() and not (
                    head.deadline_t is not None and now > head.deadline_t):
                break                   # pool full: head waits, FIFO
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
                budget -= need
        self.stats.set_queue_depth(len(self._q))
        return out or None

    def _join(self, reqs: List[_DecodeRequest]) -> None:
        for req in reqs:
            slot_idx = self._slots.index(None)
            if not self._pool.reserve(slot_idx, self._blocks_for(req)):
                # _claim_locked checked the budget and only this thread
                # touches the pool — reaching here is an accounting bug
                raise ServeError(
                    "pool reservation failed after admission check "
                    "(slot %d)" % slot_idx)
            self._slots[slot_idx] = _PagedSlot(req)
            self._active += 1
            if req.trace_id is not None and _trace.enabled():
                _trace.async_instant("serve:decode_request", req.trace_id,
                                     cat="serve", at="admit",
                                     slot=slot_idx)
        self.stats.on_admitted(len(reqs))

    def _k_eff(self, sl: _PagedSlot) -> int:
        """Speculation depth for this slot this round: never propose past
        max_new (the bonus token always lands) or the verify window."""
        return max(0, min(self.spec_k,
                          sl.req.max_new - len(sl.emitted) - 1,
                          self.chunk - 1))

    def _emit(self, i: int, sl: _PagedSlot, toks: List[int]) -> int:
        """Append generated tokens to slot ``i``'s stream, stopping at
        eos / max_new; resolves and frees the slot when the stream
        finishes.  Returns the number of tokens emitted."""
        req = sl.req
        now = time.perf_counter()
        gaps: List[float] = []
        count = 0
        finished = False
        for t in toks:
            sl.emitted.append(t)
            sl.next_tok = t
            count += 1
            gaps.append((now - sl.last_emit_t) * 1e3 if count == 1
                        else 0.0)
            if len(sl.emitted) >= req.max_new or \
                    (req.eos_id is not None and t == req.eos_id):
                finished = True
                break
        sl.last_emit_t = now
        self.stats.on_inter_token(gaps)
        if finished:
            if _set_result(req.future, np.asarray(sl.emitted, np.int32)):
                self.stats.on_complete([(now - req.enqueue_t) * 1e3])
            _trace_end(req, "resolved")
            self._pool.release(i)
            self._slots[i] = None
            self._active -= 1
        return count

    def _mixed_step(self, active) -> int:
        """One chunk-width step: prefilling slots consume up to
        ``chunk`` prompt tokens, decoding slots one token."""
        tokens, positions, n_valid, lengths = self._staging(self.chunk)
        plan: Dict[int, int] = {}
        for i, sl in active:
            if sl.prefilling():
                c = min(self.chunk, sl.req.prompt.size - sl.pos)
                tokens[i, :c] = sl.req.prompt[sl.pos:sl.pos + c]
                plan[i] = c
            else:
                c = 1
                tokens[i, 0] = sl.next_tok
                plan[i] = 0
            n_valid[i] = c
            positions[i, :c] = sl.cache_len + np.arange(c)
            lengths[i] = sl.cache_len + c
            self._pool.ensure(i, sl.cache_len + c)
        toks = self._run_target(tokens, positions, n_valid, lengths)
        emitted = 0
        prefill_tokens = 0
        for i, sl in active:
            c = plan[i]
            if c:                       # prefill slot
                sl.pos += c
                sl.cache_len += c
                prefill_tokens += c
                if not sl.prefilling():
                    # final chunk: its last logit is the first token
                    emitted += self._emit(i, sl, [int(toks[i, c - 1])])
            else:
                sl.cache_len += 1
                emitted += self._emit(i, sl, [int(toks[i, 0])])
        if prefill_tokens:
            self.stats.on_prefill(prefill_tokens)
        return emitted

    def _plain_step(self, active) -> int:
        """One pure-decode step: every slot consumes its last token."""
        tokens, positions, n_valid, lengths = self._staging(1)
        for i, sl in active:
            tokens[i, 0] = sl.next_tok
            n_valid[i] = 1
            positions[i, 0] = sl.cache_len
            lengths[i] = sl.cache_len + 1
            self._pool.ensure(i, sl.cache_len + 1)
        toks = self._run_target(tokens, positions, n_valid, lengths)
        emitted = 0
        for i, sl in active:
            sl.cache_len += 1
            emitted += self._emit(i, sl, [int(toks[i, 0])])
        return emitted

    def _spec_round(self, active) -> int:
        """One speculative round: the draft proposes up to K tokens per
        slot, the target verifies every slot's window in ONE chunk-width
        step, greedy acceptance commits the longest agreeing prefix plus
        the target's own next token.  Rejected positions roll back by
        not advancing the length counters; their stale KV rows are
        overwritten when those positions refill."""
        k_eff = {i: self._k_eff(sl) for i, sl in active}
        props = self._spec.propose(active, k_eff)
        tokens, positions, n_valid, lengths = self._staging(self.chunk)
        for i, sl in active:
            window = [sl.next_tok] + props.get(i, [])
            nv = len(window)
            tokens[i, :nv] = window
            n_valid[i] = nv
            positions[i, :nv] = sl.cache_len + np.arange(nv)
            lengths[i] = sl.cache_len + nv
            self._pool.ensure(i, sl.cache_len + nv)
        toks = self._run_target(tokens, positions, n_valid, lengths)
        emitted = 0
        for i, sl in active:
            prop = props.get(i, [])
            a = [int(x) for x in toks[i, :len(prop) + 1]]
            j = 0
            while j < len(prop) and prop[j] == a[j]:
                j += 1
            base = sl.cache_len
            sl.cache_len = base + j + 1
            sl.draft_len = base + min(j + 1, len(prop))
            self.stats.on_spec_round(len(prop), j)
            emitted += self._emit(i, sl, a[:j + 1])
        return emitted

    def _step(self) -> None:
        active = [(i, sl) for i, sl in enumerate(self._slots)
                  if sl is not None]
        # same seam as decode.step: `delay` stretches a step, `error`
        # kills the loop (the replica-crash shape)
        n_active = len(active)
        _fault_point("paged.step", active=n_active)
        with _trace.span("serve:paged_step", cat="serve",
                         active=n_active, slots=self.num_slots):
            if any(sl.prefilling() for _, sl in active):
                emitted = self._mixed_step(active)
            elif self._spec is not None and \
                    any(self._k_eff(sl) > 0 for _, sl in active):
                emitted = self._spec_round(active)
            else:
                emitted = self._plain_step(active)
        self.stats.on_step(n_active, emitted)
        self.stats.set_pool(self._pool.used_blocks(),
                            self._pool.reserved_blocks())
        _trace.counter("serve:paged_kv_blocks", cat="serve",
                       used=self._pool.used_blocks(),
                       reserved=self._pool.reserved_blocks())

    def _run(self, warmup: bool) -> None:
        """The decode thread: warm up, report readiness to the
        constructor, then serve."""
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
                with self._cv:
                    while (not self._closed and self._active == 0
                           and not self._q):
                        self._cv.wait(_IDLE_POLL_S)
                    if self._closed and not self._drain:
                        break
                    admitted = self._claim_locked()
                    if (self._closed and self._active == 0
                            and admitted is None and not self._q):
                        break
                if admitted:
                    self._join(admitted)
                if self._active:
                    self._step()
        finally:
            self._shutdown_tail()

    def _shutdown_tail(self) -> None:
        """Loop epilogue: fail whatever remains (drain=False, or a step
        error) and flip _closed so no new submit can enqueue onto a dead
        loop."""
        with self._cv:
            self._closed = True
            leftovers = list(self._q)
            self._q.clear()
            self.stats.set_queue_depth(0)
        exc = ServeClosedError(
            "paged engine %r closed before this stream finished"
            % self.name)
        failed = cancelled = 0
        for i, sl in enumerate(self._slots):
            if sl is None:
                continue
            self._slots[i] = None
            self._active -= 1
            self._pool.release(i)
            _trace_end(sl.req, "closed")
            if _set_exception(sl.req.future, exc):
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

    # -- introspection / lifecycle -----------------------------------------
    def pending_requests(self) -> int:
        with self._cv:
            return len(self._q)

    def outstanding(self) -> int:
        return self.stats.outstanding()

    @property
    def pool(self) -> KVBlockPool:
        return self._pool

    @property
    def use_kernel(self) -> bool:
        return self._use_kernel

    def device_bytes(self) -> int:
        """Device footprint: target params + draft params + the full KV
        block pool (every view)."""
        total = param_bytes(self._params) + self._pool.device_bytes()
        if self._spec is not None:
            total += param_bytes(self._spec.params)
        return total

    def close(self, drain: bool = True) -> None:
        """Stop admissions; drain=True finishes queued + in-flight
        streams first, drain=False fails them with ServeClosedError.
        Thread-safe, idempotent; from the decode thread itself this
        degrades to a non-joining shutdown request."""
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
