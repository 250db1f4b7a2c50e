"""Collectives over one mesh axis: the port's stand-in for the ones XLA
inserts under ``shard_map``/GSPMD in the JAX package (``lax.psum``,
``all_gather``, ``psum_scatter``, ``all_to_all``, ``ppermute``).

Each function takes an :class:`Axis` (``Mesh.axis(name)``).  The
transport is the axis group's backend (``dist.boot``):

* on an NCCL group CUDA tensors go to NCCL directly, and the calls can
  be issued inside a captured CUDA graph;
* on a gloo group CUDA tensors are staged through pinned host memory,
  the op runs on the host copy, and the result is copied back: gloo has
  no CUDA path there.  The compute around the call stays on the card.
  This is the transport rule of a gloo group, not a fallback.

An axis of size 1 still runs its collective (a copy), so a world-1 NCCL
group puts the same calls into a captured graph as a larger one.

Autograd: ``ring_shift``'s backward shifts the gradient the other way;
``all_to_all``'s is the inverse all-to-all.  ``all_reduce`` and
``all_gather`` follow the replicated-loss convention of the port's
pipeline and data-parallel code: every rank computes the same loss
from the replicated result and seeds its own backward with it, so the
gradient of ``all_reduce`` passes through unchanged and that of
``all_gather`` is this rank's slice.

``STATS`` counts calls, bytes and the host seconds spent inside them
(the blocking time on a gloo group; on NCCL the calls are asynchronous
and the seconds read only the launch), and under ``"by_op"`` the
redistributions the sharded graph walk makes at each op's entry, per
op name and kind (``note_redistribution``).

Tensor parallelism adds three boundaries between a replicated value and
work that differs by rank, each with the backward that makes every
rank's gradient of the replicated value the whole gradient:
``narrow`` (this rank's slice; backward all-gathers the slices'
gradients), ``enter_parallel`` (the identity; backward sums over the
axis: the input of a column-parallel product) and ``gather_param`` (a
parameter cut over an axis whose ranks see different data; backward
reduce-scatters, so the shard's gradient is summed over that axis).
"""
from __future__ import annotations

import time
from typing import List

import torch

__all__ = ["Axis", "all_reduce", "all_reduce_", "all_gather",
           "reduce_scatter", "all_to_all", "ring_shift", "broadcast_",
           "barrier", "all_reduce_coalesced_", "shard_rows", "dp_update",
           "narrow", "enter_parallel", "gather_param",
           "note_redistribution", "STATS", "reset_stats"]

STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "by_op": {}}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, seconds=0.0, by_op={})


def note_redistribution(op: str, kind: str) -> None:
    """Count one redistribution of kind ``kind`` at op ``op``'s entry."""
    per = STATS["by_op"].setdefault(op, {})
    per[kind] = per.get(kind, 0) + 1


class Axis:
    """One mesh axis as this rank sees it: ``size``, this rank's
    ``index`` along it, the global ``ranks`` of its line in axis order
    and their ``group``."""

    def __init__(self, name, size, index, ranks, group):
        self.name = name
        self.size = int(size)
        self.index = int(index)
        self.ranks = tuple(ranks)
        self.group = group

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors go through host memory (a gloo group)."""
        from ..dist import boot
        return boot.backend() != "nccl"

    def __repr__(self):
        return "Axis(%r, size=%d, index=%d, ranks=%s)" % (
            self.name, self.size, self.index, list(self.ranks))


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


class _Timed:
    def __init__(self, *tensors):
        self.nbytes = sum(t.numel() * t.element_size() for t in tensors)

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        STATS["calls"] += 1
        STATS["bytes"] += self.nbytes
        STATS["seconds"] += time.perf_counter() - self.t0


def _run(axis: Axis, fn, outs: List[torch.Tensor], ins: List[torch.Tensor]):
    """``fn(outs, ins)`` on the axis's transport; outs are written in
    place (staged back from the host on a gloo group)."""
    cuda = any(t.is_cuda for t in outs + ins)
    with _Timed(*ins):
        if not (cuda and axis.staged):
            fn(outs, ins)
            return
        h_ins = [_host(t) for t in ins]
        h_outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                  for t in outs]
        # outs that alias ins (in-place ops) must see the op's input
        for i, o in enumerate(outs):
            for j, t in enumerate(ins):
                if o is t:
                    h_outs[i] = h_ins[j]
        fn(h_outs, h_ins)
        for o, h in zip(outs, h_outs):
            o.copy_(h)


def all_reduce_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over the axis, in place; -> x."""
    import torch.distributed as dist
    _run(axis, lambda o, i: dist.all_reduce(o[0], group=axis.group),
         [x], [x])
    return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.detach().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the axis (a new tensor; differentiable under
    the replicated-loss convention)."""
    return _AllReduce.apply(x, axis)


def _gather_raw(x, axis, dim):
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    _run(axis, lambda o, i: dist.all_gather(o, i[0], group=axis.group),
         parts, [x])
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return _gather_raw(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order."""
    return _AllGather.apply(x, axis, dim)


class _Narrow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        n = x.shape[dim] // axis.size
        return x.narrow(dim, axis.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.axis, ctx.dim), None, None


def narrow(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's slice of the replicated ``x`` along ``dim``; the
    backward all-gathers the slices' gradients (each rank computed its
    slice's)."""
    return _Narrow.apply(x, axis, dim)


class _EnterParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def enter_parallel(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The identity on a replicated input of per-rank work whose
    gradients are summands (a column-parallel product's input): the
    backward sums them over the axis."""
    return _EnterParallel.apply(x, axis)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_raw(x.detach(), axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim), None, None


def gather_param(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The whole of a parameter cut over an axis whose ranks compute on
    different data (``dp``): all-gathered forward, the gradient
    reduce-scattered back, so each rank's shard gets the sum over the
    axis."""
    return _GatherParam.apply(x, axis, dim)


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The sum over the axis of ``x``, of which this rank keeps chunk
    ``index`` along ``dim`` (``x.shape[dim]`` divisible by the size):
    an all-reduce that keeps this rank's chunk, on either backend."""
    summed = all_reduce_(x.detach().clone(), axis)
    return summed.chunk(axis.size, dim=dim)[axis.index].contiguous()


def _a2a_raw(x, axis, split_dim, concat_dim):
    """All-to-all as paired sends and receives (gloo lacks ``alltoall``
    in some releases; NCCL groups the pairs)."""
    import torch.distributed as dist
    ins = [c.contiguous() for c in x.chunk(axis.size, dim=split_dim)]
    outs = [torch.empty_like(ins[0]) for _ in range(axis.size)]

    def fn(o, i):
        me = axis.index
        o[me].copy_(i[me])
        ops = []
        for j, peer in enumerate(axis.ranks):
            if j != me:
                ops.append(dist.P2POp(dist.isend, i[j], peer, axis.group))
                ops.append(dist.P2POp(dist.irecv, o[j], peer, axis.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    _run(axis, fn, outs, ins)
    return torch.cat(outs, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _a2a_raw(x.detach(), axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _a2a_raw(g, axis, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all``: chunk ``split_dim`` into ``size`` parts, send
    part j to the axis's rank j, concatenate the received parts along
    ``concat_dim`` in axis order."""
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def _shift_raw(x, axis, shift):
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = axis.ranks[(axis.index + shift) % axis.size]
    src = axis.ranks[(axis.index - shift) % axis.size]

    def fn(o, i):
        if dst == src == axis.ranks[axis.index]:
            o[0].copy_(i[0])
            return
        ops = [dist.P2POp(dist.isend, i[0], dst, axis.group),
               dist.P2POp(dist.irecv, o[0], src, axis.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _run(axis, fn, [out], [x])
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _shift_raw(x.detach(), axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift_raw(g, ctx.axis, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` around the ring: the axis's rank i sends ``x`` to
    rank ``i + shift`` and returns what rank ``i - shift`` sent."""
    return _RingShift.apply(x, axis, shift)


def broadcast_(x: torch.Tensor, axis: Axis, src: int = 0) -> torch.Tensor:
    """Overwrite ``x`` with the axis's rank ``src``'s value; -> x."""
    import torch.distributed as dist
    root = axis.ranks[src]
    _run(axis, lambda o, i: dist.broadcast(o[0], root, group=axis.group),
         [x], [x])
    return x


def barrier(axis: Axis) -> None:
    """Wait for every rank of the axis (a host all-reduce of one int)."""
    all_reduce_(torch.zeros(1, dtype=torch.int32), axis)


def all_reduce_coalesced_(tensors: List[torch.Tensor], axis: Axis) -> None:
    """Sum each tensor over the axis, in place, through one flat buffer
    per dtype (one collective instead of one a tensor)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce_(flat, axis)
        off = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def shard_rows(axis: Axis, shape, shard: bool):
    """The rows ``(lo, hi)`` of a parameter this rank updates under the
    sharded weight update (its leading dim divisible by the axis size),
    or None: the whole parameter, replicated."""
    if not shard or axis.size < 2 or not shape or shape[0] % axis.size:
        return None
    r = shape[0] // axis.size
    return axis.index * r, (axis.index + 1) * r


def dp_update(axis: Axis, params, grads, rows, update) -> None:
    """The data-parallel update of ``params`` (in place) from this rank's
    ``grads``: gradients of replicated params are summed over the axis
    (one coalesced all-reduce) and ``update(i, p, g)`` runs on the whole
    param; a param with ``rows[i] = (lo, hi)`` has its gradient
    reduce-scattered, ``update(i, p[lo:hi], g_rows)`` updates this
    rank's rows, and the rows are all-gathered back (the sharded weight
    update, ``MXNET_SHARD_WEIGHT_UPDATE``).  ``rows[i] = "summed"``: the
    gradient is already the sum over the axis (a parameter cut over it,
    ``gather_param``), and the update runs on it as it is."""
    whole = [i for i, r in enumerate(rows) if r is None]
    all_reduce_coalesced_([grads[i] for i in whole], axis)
    for i in whole:
        update(i, params[i], grads[i])
    for i, r in enumerate(rows):
        if r == "summed":
            update(i, params[i], grads[i])
        if r is None or r == "summed":
            continue
        lo, hi = r
        g = reduce_scatter(grads[i], axis, dim=0)
        update(i, params[i][lo:hi], g)
        params[i].copy_(_gather_raw(params[i][lo:hi], axis, 0))
