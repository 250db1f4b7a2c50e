"""KVBlockPool: a device-resident pool of fixed-size KV-cache blocks
(counterpart of ``mxnet_tpu/serve/paged/pool.py``).

K/V live in ``num_blocks`` blocks of ``block_tokens`` tokens each
(``MXNET_KVPOOL_BLOCKS`` / ``MXNET_KVPOOL_BLOCK_TOKENS``); each slot maps
its logical context onto physical blocks through a row of the host page
table, so memory scales with the live token count, not with
``num_slots * max_context``.

Allocation — exact reservation, lazy assignment: admission reserves a
stream's worst-case block count (prompt + max_new are known at submit),
so an admitted stream can never wait for blocks mid-generation;
physical blocks are assigned as tokens land; ``release`` returns a
finished slot's blocks and the rest of its reservation at once.

Unassigned page-table entries hold the **sentinel** ``num_blocks``, a
*positive* index: it names the scratch row at the end of every view,
which takes the writes of invalid window positions and is never read
inside a slot's length.  Nothing can wrap to block -1, as a negative
index would under torch indexing.

Views: the target and draft models share ONE allocator and ONE page table
(a stream's logical block i is the same physical block in both), each
with its own K/V tensors, ``(layers, num_blocks + 1, block_tokens, heads,
head_dim)`` on the engine's device.  The page table stays a host numpy
int32 array; the engine ships it with each step.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...base import get_env, make_lock
from ...context import current_context
from ..errors import ServeError

__all__ = ["KVBlockPool"]


class _View:
    """One model's K/V tensors over the shared block space; the last of
    the ``num_blocks + 1`` rows is the sentinel scratch block."""

    __slots__ = ("name", "kv_k", "kv_v")

    def __init__(self, name, kv_k, kv_v):
        self.name = name
        self.kv_k = kv_k
        self.kv_v = kv_v


class KVBlockPool:
    """Block allocator + page tables for ``num_slots`` decode slots.

    Parameters
    ----------
    num_slots : int
        Page-table rows (one per engine slot).
    max_blocks_per_slot : int
        Page-table row width: ``ceil(max_context / block_tokens)``.
    num_blocks / block_tokens : int, optional
        Pool geometry (``MXNET_KVPOOL_BLOCKS`` — default
        ``num_slots * max_blocks_per_slot``, dense-equivalent — and
        ``MXNET_KVPOOL_BLOCK_TOKENS``, default 16).
    dense : bool
        Every slot statically owns its own full stripe (needs the
        dense-equivalent pool): the dense decode layout through the same
        page-table code path, the bitwise parity baseline.
    device : torch.device or str, optional
        Where the K/V views live (default the current context's device,
        ``gpu(0)`` unless a context scope says otherwise; raises
        ``MXNetError`` when that card is not there).
    """

    def __init__(self, num_slots: int, max_blocks_per_slot: int,
                 num_blocks=None, block_tokens=None, dense: bool = False,
                 device=None):
        if block_tokens is None:
            block_tokens = get_env("MXNET_KVPOOL_BLOCK_TOKENS", 16, int)
        self.block_tokens = int(block_tokens)
        if self.block_tokens < 1:
            raise ServeError("block_tokens must be >= 1, got %d"
                             % self.block_tokens)
        self.num_slots = int(num_slots)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        dense_blocks = self.num_slots * self.max_blocks_per_slot
        if num_blocks is None:
            num_blocks = get_env("MXNET_KVPOOL_BLOCKS", dense_blocks, int)
        self.num_blocks = int(num_blocks)
        if self.num_blocks < self.max_blocks_per_slot:
            raise ServeError(
                "num_blocks %d cannot hold even one max-context stream "
                "(%d blocks)" % (self.num_blocks, self.max_blocks_per_slot))
        self.dense = bool(dense)
        if self.dense and self.num_blocks < dense_blocks:
            raise ServeError(
                "dense mode needs num_blocks >= num_slots * "
                "max_blocks_per_slot (%d), got %d"
                % (dense_blocks, self.num_blocks))
        self.device = current_context().torch_device() if device is None \
            else torch.device(device)
        self.sentinel = self.num_blocks
        self._lock = make_lock("serve.kvpool")
        self._views: Dict[str, _View] = {}
        self._pages = np.full((self.num_slots, self.max_blocks_per_slot),
                              self.sentinel, np.int32)
        self._free: List[int] = list(range(self.num_blocks))
        self._avail = self.num_blocks      # blocks not reserved
        self._reserved = [0] * self.num_slots
        self._assigned = [0] * self.num_slots
        if self.dense:
            # static full-stripe ownership: the page table is fixed for
            # the life of the pool, reservations always succeed
            for s in range(self.num_slots):
                lo = s * self.max_blocks_per_slot
                self._pages[s] = np.arange(
                    lo, lo + self.max_blocks_per_slot, dtype=np.int32)
            self._free = []
            self._avail = 0

    # -- device tensors ----------------------------------------------------
    def add_view(self, name: str, layers: int, heads: int, head_dim: int,
                 dtype=torch.float32) -> None:
        """Allocate one model's K/V tensors over the block space (the +1
        sentinel block absorbs the writes of invalid positions)."""
        if name in self._views:
            raise ServeError("kv view %r already exists" % name)
        shape = (int(layers), self.num_blocks + 1, self.block_tokens,
                 int(heads), int(head_dim))
        self._views[name] = _View(
            name, torch.zeros(shape, dtype=dtype, device=self.device),
            torch.zeros(shape, dtype=dtype, device=self.device))

    def view(self, name: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The view's (kv_k, kv_v); the engine updates them in place."""
        v = self._views[name]
        return v.kv_k, v.kv_v

    def set_view(self, name: str, kv_k: torch.Tensor,
                 kv_v: torch.Tensor) -> None:
        """Publish a step's (kv_k, kv_v) as the view's tensors.  The
        port's steps append in place, so they hand back the view's own
        tensors; any others must match their shape, dtype and device."""
        v = self._views[name]
        for new, old in ((kv_k, v.kv_k), (kv_v, v.kv_v)):
            if (new.shape, new.dtype, new.device) != \
                    (old.shape, old.dtype, old.device):
                raise ServeError(
                    "set_view(%r): %s %s on %s does not match the view's "
                    "%s %s on %s" % (name, tuple(new.shape), new.dtype,
                                     new.device, tuple(old.shape),
                                     old.dtype, old.device))
        v.kv_k, v.kv_v = kv_k, kv_v

    def device_bytes(self) -> int:
        return sum(int(v.kv_k.numel() * v.kv_k.element_size()
                       + v.kv_v.numel() * v.kv_v.element_size())
                   for v in self._views.values())

    # -- allocation --------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.block_tokens)

    def can_reserve(self, n_blocks: int) -> bool:
        if self.dense:
            return n_blocks <= self.max_blocks_per_slot
        with self._lock:
            return n_blocks <= self._avail

    def reserve(self, slot: int, n_blocks: int) -> bool:
        """Reserve a stream's worst-case blocks for ``slot``; False when
        the pool cannot hold them (the caller keeps the request
        queued)."""
        if n_blocks > self.max_blocks_per_slot:
            raise ServeError(
                "reservation %d exceeds max_blocks_per_slot %d"
                % (n_blocks, self.max_blocks_per_slot))
        if self.dense:
            return True
        with self._lock:
            if self._reserved[slot]:
                raise ServeError("slot %d already holds a reservation"
                                 % slot)
            if n_blocks > self._avail:
                return False
            self._avail -= n_blocks
            self._reserved[slot] = n_blocks
            return True

    def ensure(self, slot: int, tokens: int) -> None:
        """Assign physical blocks so ``slot`` can hold ``tokens`` tokens.
        Always within the reservation — a failure here is an engine
        accounting bug, not load."""
        need = self.blocks_for(tokens)
        if self.dense:
            if need > self.max_blocks_per_slot:
                raise ServeError(
                    "slot %d needs %d blocks > stripe %d"
                    % (slot, need, self.max_blocks_per_slot))
            return
        with self._lock:
            if need > self._reserved[slot]:
                raise ServeError(
                    "slot %d needs %d blocks but reserved only %d"
                    % (slot, need, self._reserved[slot]))
            while self._assigned[slot] < need:
                blk = self._free.pop()
                self._pages[slot, self._assigned[slot]] = blk
                self._assigned[slot] += 1

    def release(self, slot: int) -> None:
        """Return ``slot``'s assigned blocks and drop its remaining
        reservation (stream finished or failed)."""
        if self.dense:
            return
        with self._lock:
            n = self._assigned[slot]
            for i in range(n):
                self._free.append(int(self._pages[slot, i]))
            self._pages[slot, :] = self.sentinel
            self._avail += self._reserved[slot]
            self._reserved[slot] = 0
            self._assigned[slot] = 0

    def available_blocks(self) -> int:
        """Blocks not yet reserved — the admission budget.  Dense mode
        returns the pool size: every slot owns a stripe, so any
        per-stream reservation fits."""
        if self.dense:
            return self.num_blocks
        with self._lock:
            return self._avail

    # -- introspection -----------------------------------------------------
    def page_table(self) -> np.ndarray:
        """The live (num_slots, max_blocks_per_slot) int32 page table."""
        return self._pages

    def used_blocks(self) -> int:
        with self._lock:
            if self.dense:
                return self.num_blocks
            return self.num_blocks - len(self._free)

    def reserved_blocks(self) -> int:
        with self._lock:
            if self.dense:
                return self.num_blocks
            return self.num_blocks - self._avail

    def utilization(self) -> float:
        return self.used_blocks() / float(self.num_blocks)
