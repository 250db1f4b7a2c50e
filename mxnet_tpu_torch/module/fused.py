"""Fused train step: forward, backward, the optimizer and the BatchNorm
aux updates of one batch as one captured CUDA graph.

The counterpart of ``mxnet_tpu/module/fused.py``, whose one donated XLA
program per step (``fused.py:57-70, 604-738``) becomes, on the card:

* **state**: persistent device tensors laid out like the reference's,
  ``{"params", "opt", "aux", "fixed"}``, plus the step ``t`` and the
  learning rate ``lr`` as device scalars, and static input buffers per
  batch shape that ``make_batch`` copies each batch into;
* **capture**: the first steps of a batch shape run eagerly on a side
  stream (the warm-up ``torch.cuda.graph`` needs); the next is captured
  (forward, ``torch.autograd.grad`` over the params, the optimizer's
  fused update written in place, the aux states copied back) and every
  later step is one ``replay()``.  A capture that fails raises: no path
  runs the eager step in its place;
* **lr and t**: written into their device scalars before each replay, so
  an lr-scheduler change costs no recapture, as the reference feeds lr
  into its program as a scalar.  A change to ``hparam_signature`` (the
  values the graph baked in) takes the module's ``_disable_fused`` path;
* **outputs**: static buffers the next replay overwrites; the module
  hands out copies.

On a CPU context the same step function runs eagerly, every step.
``stats`` counts captures, replays and eager steps, the port's
counterpart of the reference's compile guard: a steady fit makes one
capture per (shapes, dtypes) and one replay per batch.

**superstep** (reference ``build_superstep``, ``fused.py:810-862``): K
batches staged on the device once as a megabatch (``make_megabatch``),
then K replays of the step's graph, each after device-to-device copies
into its static inputs and a write of that position's learning rate;
the metric's device reducer runs between replays as a second small
captured graph over the step's static labels and outputs, into static
accumulators the host drains once per K.  K replays of the one step are
the K sequential steps, so the superstep equals them bit for bit.

**speculation** (``snapshot_state``/``restore_state``): outputs asked
for between a train forward and ``update()`` run the pending step early;
the module keeps a device copy of the state from before it, to put back
if the step is discarded.

**sparse embeddings** (reference ``fused.py:174-199, 641-706``): an
``Embedding`` whose ids are a data input and whose table feeds nothing
else trains with the deduped lazy row update (``embed/``;
``MXNET_EMBED_SPARSE=0`` keeps it dense).  The step dedups the batch's
ids at a fixed shape, gathers each unique row once (out-of-range ids
read zero), and hands the Embedding op ``(rows, inv)`` in place of
``(table, ids)``: ``rows[inv]`` is ``table[ids]`` bit for bit, and the
gradient lands on the unique rows only.  The optimizer then updates
those rows and their slots in place; untouched rows keep both bit for
bit.  Such a table is stored with one scratch row past its vocab (the
state's parameter and slots are views of the first ``vocab`` rows), so
the sentinel rows of the dedup write there and never onto a real row.
The ids are sampled into ``embed_stats`` every
``MXNET_EMBED_STATS_EVERY`` batches, host ids before their copy and ids
already on the card through a non-blocking copy read a batch later: the
sample adds no host sync.  A graph with
``_moe_dispatch`` nodes registers ``moe_stats`` (``moe_report()``); its
routing rides the step unchanged.

**device augmentation** (reference ``fused.py:247-315``): with a
``feed.AugmentSpec`` installed (``set_device_augment``), a 4-D uint8
first data input (the compact HWC wire of
``record_pipeline(device_augment=True)``) is cropped, flipped, cast and
normalized at the head of the step (``feed.augment.augment_batch``),
inside its graph; its draws come from the device's generator, which
speculation's snapshot and the checkpoints save.  A float32 batch (a
host-augmented eval iterator) passes through, and the batch key holds the
dtype, so each wire format has its own graph.  Batches already staged on
the step's device (``batched_sharding()``, the feed's prefetcher) are
copied device to device into the static buffers.

**data parallel over a dp axis** (reference ``fused.py:74-133, 236-246,
310-364``): with a named mesh (``mesh=``, its ``dp`` axis) every rank
is fed the GLOBAL batch and ``make_batch`` keeps this rank's rows; with
``global_dp`` (a ``dist_sync`` kvstore, the implicit ``dp`` axis over
every rank) each rank feeds its own batch.  The ops see the global
batch (``OpContext.dp``: BatchNorm's statistics, the loss layers'
normalizations), the gradients are summed over ``dp`` inside the step
(one coalesced all-reduce), and under a named mesh the outputs come back
all-gathered.  ``MXNET_SHARD_WEIGHT_UPDATE=1`` reduce-scatters the
gradients of params whose leading dim the dp size divides, updates this
rank's rows and their optimizer slots only, and all-gathers the rows.
The params are broadcast from the axis's rank 0 at ``init_state``.
Under an NCCL group of several ranks the step runs on this rank's card
(``dist.boot.rank_card``: the default ``gpu(0)`` names it).  On an NCCL
group the collectives are issued inside the captured graph
(``scaleout_check.py nccl`` holds this on four cards).  On a gloo group
(ranks sharing a card) they are host-staged and cannot be captured, so
the step runs eagerly on the card (``eager_steps``).
Under dp > 1 embedding tables train dense (the row-sharded table is
ROADMAP.md queue 1 item 10b) and ``_moe_dispatch`` blocks raise (the
expert axis is item 10b).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

from ..base import MXNetError, get_env
from ..checkpoint.snapshot import map_structure
from ..embed.sparse import (_mask_oov_rows, dedup_ids, map_slots,
                            resolve_cap, slot_leaves_row_shaped,
                            sparse_apply_rows)
from ..executor import _GraphProgram
from ..ndarray import NDArray
from ..ops.registry import OpContext
from .. import random as _random

__all__ = ["FusedTrainStep", "GraphStats", "flatten_tensors",
           "unflatten_tensors"]

# eager steps of a batch shape before its capture: the side-stream
# warm-up CUDA graph capture needs (cuBLAS/cuDNN handles, workspaces)
WARMUP_STEPS = 3


class GraphStats:
    """Counts of the fused step's executions: graph captures, replays,
    and eager steps (the warm-up steps on the card, every step on the
    CPU)."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0

    def report(self) -> Dict[str, int]:
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps}


def flatten_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nested tuple/list tree, in order."""
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in flatten_tensors(x)]
    return [tree]


def unflatten_tensors(tree, flat):
    """``flat`` in the structure of ``tree`` (see flatten_tensors)."""
    it = iter(flat)

    def build(node):
        if isinstance(node, (tuple, list)):
            return tuple(build(x) for x in node)
        return next(it)
    return build(tree)


class _Captured:
    __slots__ = ("graph", "outputs")

    def __init__(self, graph, outputs):
        self.graph = graph
        self.outputs = outputs


class FusedTrainStep:
    """One batch body (forward + backward + update) per call, captured as
    a CUDA graph per (shapes, dtypes) on the card."""

    def __init__(self, symbol, context, data_names: Sequence[str],
                 label_names: Sequence[str], param_names: Sequence[str],
                 fixed_param_names: Sequence[str], optimizer,
                 mesh=None, global_dp: bool = False):
        # the dp axis: a named mesh's, or every rank's under dist_sync
        self.axis = None
        self.slice_batch = False
        if mesh is not None:
            if "dp" not in mesh.axis_names:
                raise MXNetError(
                    "mesh %s has no 'dp' axis; the batch shards over "
                    "'dp' — use dp=1 for one rank" % (dict(mesh.shape),))
            self.axis = mesh.axis("dp")
            self.slice_batch = not global_dp
        elif global_dp:
            from ..parallel.mesh import make_mesh
            self.axis = make_mesh([("dp", -1)]).axis("dp")
        dp = self.axis.size if self.axis is not None else 1
        # resolved once the group is up: this rank's card under NCCL
        self.device = context.torch_device()
        self.shard_update = self.axis is not None and dp > 1 and get_env(
            "MXNET_SHARD_WEIGHT_UPDATE", False, bool)
        self._rows = {}
        self.data_names = tuple(data_names)
        self.label_names = tuple(label_names)
        fixed = set(fixed_param_names or ())
        self.train_names = [n for n in param_names if n not in fixed]
        self.fixed_names = [n for n in param_names if n in fixed]
        self.aux_names = symbol.list_auxiliary_states()
        self.optimizer = optimizer
        fused = optimizer.fused_update_fn()
        if fused is None:
            raise MXNetError("optimizer has no fused form")
        self._opt_init, self._opt_update = fused
        self._lr_mult = {n: optimizer._name_lr_mult(n)
                         for n in self.train_names}
        self._wd = {n: optimizer._name_wd(n) for n in self.train_names}
        self._rescale = optimizer.rescale_grad
        self._clip = optimizer.clip_gradient
        # tables trained with the lazy row update: row-shaped optimizer
        # state only (SGD, NAG, AdaGrad, Adam); any other keeps its table
        # dense
        from ..embed.detect import find_sparse_embeds
        self.sparse_embeds = {
            n: sp for n, sp in find_sparse_embeds(
                symbol, self.data_names, self.train_names).items()
            if slot_leaves_row_shaped(self._opt_init, sp.vocab, sp.dim)
            and dp == 1}
        # name -> (table storage with its scratch row, its slots)
        self._sparse_store = {}
        self.embed_stats = None
        if self.sparse_embeds:
            from ..embed.stats import EmbedStats
            from .. import profiler
            self.embed_stats = EmbedStats("fused")
            profiler.register_embed_stats(self.embed_stats)
        self._embed_stats_every = max(
            1, get_env("MXNET_EMBED_STATS_EVERY", 1, int))
        self._embed_stats_n = 0
        # name -> (pinned host ids, the event of their copy)
        self._ids_in_flight = {}
        from ..moe.detect import find_moe_blocks
        self.moe_blocks = find_moe_blocks(symbol)
        if self.moe_blocks and dp > 1:
            raise NotImplementedError(
                "routed MoE over a dp axis of %d: the expert axis is not in "
                "the port yet (ROADMAP.md, queue 1 item 10b)" % dp)
        self.moe_stats = None
        if self.moe_blocks:
            from ..moe.stats import MoeStats
            from .. import profiler
            self.moe_stats = MoeStats("fused")
            profiler.register_moe_stats(self.moe_stats)
        self._prog = _GraphProgram(symbol)
        self.stats = GraphStats()
        self.state = None
        self._buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._graphs: Dict[tuple, _Captured] = {}
        self._warm: Dict[tuple, int] = {}
        self._side = None
        self._lr_host = None
        # the metric reducer's captured update per (batch key, reducer
        # signature): (graph or None while warming, static accumulators)
        self._metric_graphs: Dict[tuple, list] = {}
        # feed.AugmentSpec of the uint8 wire, or None
        self.device_augment = None
        # a list to append (uint8 input, draws, augmented batch) of each
        # eager step to, or None (a check's probe)
        self.augment_probe = None

    @property
    def captured(self) -> bool:
        """Whether steps are captured CUDA graphs: on the card, unless
        the dp axis's collectives are host-staged (a gloo group)."""
        if self.axis is not None and self.axis.staged:
            return False
        return self.device.type == "cuda"

    def _local_rows(self, t: torch.Tensor, dim: int,
                    batch: int) -> torch.Tensor:
        """This rank's rows of a global-batch input under a named mesh
        (inputs whose ``dim`` is not the batch pass whole)."""
        if not self.slice_batch or t.dim() <= dim or t.shape[dim] != batch:
            return t
        if batch % self.axis.size:
            raise MXNetError("batch %d is not divisible by the mesh's dp "
                             "axis (%d)" % (batch, self.axis.size))
        b = batch // self.axis.size
        return t.narrow(dim, self.axis.index * b, b)

    def _batch_of(self, src: Dict[str, torch.Tensor], dim: int) -> int:
        return int(src[self.data_names[0]].shape[dim]) \
            if self.data_names and self.data_names[0] in src else 0

    def batched_sharding(self) -> torch.device:
        """Where input pipelines stage batches (feed.device_feed,
        DevicePutStage): the step's device.  ``make_batch`` copies them
        device to device into its static buffers."""
        return self.device

    def megabatched_sharding(self) -> torch.device:
        """Where a K-step megabatch is staged: the step's device."""
        return self.device

    # -- on-device augmentation ---------------------------------------------
    def set_device_augment(self, spec) -> None:
        """Install (or clear) the augmentation prologue.  A real change
        drops the captured graphs (the prologue is part of them); a
        no-op set (the same spec, or None over None) keeps them."""
        def sig(s):
            return s.signature() if s is not None else None
        if sig(spec) == sig(self.device_augment):
            return
        self.device_augment = spec
        self._graphs.clear()
        self._warm.clear()
        self._metric_graphs.clear()

    def _maybe_augment(self, batch: Dict[str, torch.Tensor], train: bool):
        """The prologue: applies ONLY when the first data input is a 4-D
        uint8 tensor (the compact HWC wire) -- a float32 batch from a
        host-augmented eval iterator passes through untouched."""
        spec = self.device_augment
        if spec is None or not self.data_names:
            return batch
        name = self.data_names[0]
        x = batch.get(name)
        if x is None or x.dtype != torch.uint8 or x.dim() != 4:
            return batch
        from ..feed.augment import augment_batch
        out = dict(batch)
        draws = []
        out[name] = augment_batch(x, _random.generator(self.device), spec,
                                  train, out_draws=draws)
        if self.augment_probe is not None and not (
                x.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.augment_probe.append((x.clone(), draws[0], out[name]))
        return out

    # -- state ---------------------------------------------------------------
    def init_state(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]) -> None:
        """Copy the params onto the device as the persistent state (the
        params are autograd leaves, updated in place); drops every
        captured graph, which read the old state."""
        def put(v):
            t = v._get().detach().to(self.device, copy=True)
            if self.axis is not None and self.axis.size > 1:
                # rank 0's values win on every rank of the axis
                from ..parallel.collectives import broadcast_
                broadcast_(t, self.axis)
            return t
        from ..parallel.collectives import shard_rows
        params, opt = {}, {}
        self._sparse_store = {}
        self._rows = {}
        for n in self.train_names:
            w = put(arg_params[n])
            if n not in self.sparse_embeds:
                params[n] = w.requires_grad_(True)
                rows = self._rows[n] = shard_rows(
                    self.axis, tuple(w.shape), self.shard_update) \
                    if self.axis is not None else None
                opt[n] = self._opt_init(w.detach() if rows is None
                                        else w.detach()[rows[0]:rows[1]])
                continue
            vocab = w.shape[0]
            store = torch.zeros((vocab + 1,) + tuple(w.shape[1:]),
                                dtype=w.dtype, device=self.device)
            store[:vocab] = w
            slots = self._opt_init(store)
            self._sparse_store[n] = (store, slots)
            params[n] = store[:vocab]
            opt[n] = map_slots(lambda t, _v=vocab: t[:_v], slots)
        self.state = {
            "params": params,
            "fixed": {n: put(arg_params[n]) for n in self.fixed_names},
            "aux": {n: put(aux_params[n]) for n in self.aux_names},
            "opt": opt,
            "t": torch.zeros((), dtype=torch.float32, device=self.device),
            "lr": torch.zeros((), dtype=torch.float32, device=self.device)}
        self._buffers.clear()
        self._graphs.clear()
        self._warm.clear()
        self._metric_graphs.clear()
        self._lr_host = None

    def hparam_signature(self):
        """The optimizer values baked into the step (everything except
        lr and t, which are device scalars); the module compares it
        before every step."""
        opt = self.optimizer
        baked = tuple((k, getattr(opt, k, None))
                      for k in sorted(opt.fused_hparams))
        return (tuple(sorted(opt.lr_mult.items())),
                tuple(sorted(opt.wd_mult.items())),
                opt.wd, opt.rescale_grad, opt.clip_gradient, baked)

    @staticmethod
    def _key(batch: Dict[str, torch.Tensor]) -> tuple:
        return tuple(sorted((n, tuple(t.shape), t.dtype)
                            for n, t in batch.items()))

    def make_batch(self, data_batch) -> Dict[str, torch.Tensor]:
        """Copy one DataBatch into the step's static input buffers of its
        shapes (allocated on first sight); -> {name: buffer}."""
        src = {}
        for names, arrs in ((self.data_names, data_batch.data),
                            (self.label_names, data_batch.label or [])):
            for name, arr in zip(names, arrs):
                src[name] = arr._get() if isinstance(arr, NDArray) \
                    else torch.as_tensor(arr)
        missing = [n for n in self.data_names + self.label_names
                   if n not in src]
        if missing:
            raise MXNetError("the batch lacks inputs %s" % missing)
        if self.slice_batch:
            b = self._batch_of(src, 0)
            src = {n: self._local_rows(t, 0, b) for n, t in src.items()}
        self._note_ids(src)
        key = self._key(src)
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = {n: torch.empty(t.shape, dtype=t.dtype,
                                   device=self.device)
                    for n, t in src.items()}
            self._buffers[key] = bufs
        for n, t in src.items():
            bufs[n].copy_(t, non_blocking=True)
        return bufs

    def _note_ids(self, src: Dict[str, torch.Tensor]) -> None:
        """Sample a batch's ids of every sparse table into
        ``embed_stats`` (every ``MXNET_EMBED_STATS_EVERY`` batches).  Host
        ids are read before their copy to the device; ids already on the
        card go to pinned host memory without blocking and are read at a
        later batch, once their copy has landed (a sample is skipped
        while the last one is in flight)."""
        if self.embed_stats is None:
            return
        self._note_landed_ids()
        self._embed_stats_n += 1
        if self._embed_stats_n % self._embed_stats_every:
            return
        for n, sp in self.sparse_embeds.items():
            ids = src.get(sp.ids_name)
            if ids is None:
                continue
            if ids.device.type == "cpu":
                self._note_host_ids(n, ids.detach().numpy())
            elif n not in self._ids_in_flight:
                host = torch.empty(ids.shape, dtype=ids.dtype,
                                   pin_memory=True)
                host.copy_(ids.detach(), non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(ids.device))
                self._ids_in_flight[n] = (host, done)

    def _note_landed_ids(self) -> None:
        for n, (host, done) in list(self._ids_in_flight.items()):
            if done.query():
                del self._ids_in_flight[n]
                self._note_host_ids(n, host.numpy())

    def _note_host_ids(self, n: str, host) -> None:
        sp = self.sparse_embeds[n]
        self.embed_stats.note_ids(n, host)
        self.embed_stats.note_update(n, resolve_cap(sp.cap, host.size,
                                                    sp.vocab))

    # -- the step -------------------------------------------------------------
    def _sparse_prologue(self, args: Dict[str, torch.Tensor]):
        """Put each sparse table's ``(rows, inv)`` in ``args`` in place of
        ``(table, ids)``; -> {name: (uniq, rows)}, the rows being the
        autograd leaves of the tables."""
        ctx = {}
        for n, sp in self.sparse_embeds.items():
            ids = args[sp.ids_name]
            flat = ids.reshape(-1)
            cap = resolve_cap(sp.cap, flat.numel(), sp.vocab)
            uniq, inv = dedup_ids(flat, cap, sp.vocab)
            store = self._sparse_store[n][0]
            rows = _mask_oov_rows(store[uniq.long()], uniq, sp.vocab)
            rows.requires_grad_(True)
            args[n] = rows
            args[sp.ids_name] = inv.reshape(ids.shape)
            ctx[n] = (uniq, rows)
        return ctx

    def _grad(self, g, like):
        if g is None:
            g = torch.zeros_like(like)
        if self._rescale != 1.0:
            g = g * self._rescale
        if self._clip is not None:
            g = torch.clamp(g, -self._clip, self._clip)
        return g

    def _body(self, batch: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The batch body, in place on the state; -> outputs.  Its three
        parts are profiler ranges (``fused:forward``, ``fused:backward``,
        ``fused:update``) for a profile of an eager step."""
        st = self.state
        params = st["params"]
        names = [n for n in params if n not in self.sparse_embeds]
        st["t"].add_(1.0)
        args = dict(params)
        args.update(st["fixed"])
        args.update(self._maybe_augment(batch, True))
        opctx = OpContext(is_train=True,
                          generator=_random.generator(self.device),
                          dp=self.axis)
        with torch.enable_grad():
            with record_function("fused:forward"):
                sparse = self._sparse_prologue(args)
                outs, new_aux = self._prog.eval(args, st["aux"], opctx)
            heads = [o for o in outs if o.requires_grad]
            leaves = [params[n] for n in names] \
                + [rows for _uniq, rows in sparse.values()]
            with record_function("fused:backward"):
                grads = torch.autograd.grad(
                    heads, leaves,
                    grad_outputs=[torch.ones_like(o) for o in heads],
                    allow_unused=True) if heads else [None] * len(leaves)
        with torch.no_grad(), record_function("fused:update"):
            if self.axis is not None:
                self._dp_update(names, grads)
            else:
                for n, g in zip(names, grads):
                    w = params[n]
                    self._opt_update(w, self._grad(g, w), st["opt"][n],
                                     st["lr"] * self._lr_mult[n],
                                     self._wd[n], st["t"])
            for (n, (uniq, rows)), g in zip(sparse.items(),
                                            grads[len(names):]):
                store, slots = self._sparse_store[n]
                sparse_apply_rows(store, slots, uniq, self._grad(g, rows),
                                  self._opt_update,
                                  st["lr"] * self._lr_mult[n], self._wd[n],
                                  st["t"])
            for k, v in new_aux.items():
                st["aux"][k].copy_(v)
        outs = [o.detach() for o in outs]
        if self.slice_batch:
            from ..parallel.data_parallel import gather_outputs
            outs = gather_outputs(outs, self.axis,
                                  self._batch_of(batch, 0))
        return outs

    def _dp_update(self, names, grads) -> None:
        """The gradients summed over the dp axis (or reduce-scattered
        under the sharded update), then the optimizer on each param or
        on this rank's rows of it."""
        from ..parallel.collectives import dp_update
        st = self.state
        params = [st["params"][n] for n in names]
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(params, grads)]

        def update(i, w, g):
            n = names[i]
            self._opt_update(w, self._grad(g, w), st["opt"][n],
                             st["lr"] * self._lr_mult[n], self._wd[n],
                             st["t"])
        dp_update(self.axis, [p.detach() for p in params], gs,
                  [self._rows.get(n) for n in names], update)

    def step(self, batch: Dict[str, torch.Tensor],
             lr: float = None) -> List[torch.Tensor]:
        """Advance one batch (``batch`` from :meth:`make_batch`) at ``lr``
        (default: the optimizer's current one); -> the outputs (on the
        card: the graph's static buffers)."""
        if lr is None:
            lr = float(self.optimizer.base_lr())
        if lr != self._lr_host:
            self.state["lr"].fill_(lr)
            self._lr_host = lr
        if not self.captured:
            self.stats.eager_steps += 1
            return self._body(batch)
        key = self._key(batch)
        cap = self._graphs.get(key)
        if cap is None:
            done = self._warm.get(key, 0)
            if done < WARMUP_STEPS:
                if self._side is None:
                    self._side = torch.cuda.Stream(device=self.device)
                main = torch.cuda.current_stream(self.device)
                self._side.wait_stream(main)
                with torch.cuda.stream(self._side):
                    outs = self._body(batch)
                main.wait_stream(self._side)
                for o in outs:
                    o.record_stream(main)
                self._warm[key] = done + 1
                self.stats.eager_steps += 1
                return outs
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self._body(batch)
            self.stats.captures += 1
            cap = self._graphs[key] = _Captured(graph, outs)
        cap.graph.replay()
        self.stats.replays += 1
        return cap.outputs

    # -- superstep ------------------------------------------------------------
    def make_megabatch(self, batches):
        """Stage K batches on the device at once: ``{name: (K, B, ...)
        tensor}``.  ``batches`` is a list of K DataBatch, stacked on the
        host and sent in one copy per input (through pinned memory on the
        card), or a pre-staged ``feed.MegaBatch`` whose stacked arrays
        already on the device are used as they are.  -> (K, megabatch)."""
        from ..feed.staging import stack_batch_arrays
        if hasattr(batches, "megabatch"):
            k = int(batches.megabatch)
            out = {}
            for names, arrs in ((self.data_names, batches.data or []),
                                (self.label_names, batches.label or [])):
                for i, name in enumerate(names):
                    if i >= len(arrs) or arrs[i] is None:
                        raise MXNetError("superstep training needs input %r"
                                         % name)
                    a = arrs[i]
                    t = a._get() if isinstance(a, NDArray) \
                        else torch.as_tensor(a)
                    out[name] = t.to(self.device)
            out = self._local_mega(out)
            for i in range(k):
                self._note_ids({n: t[i] for n, t in out.items()})
            return k, out
        k = len(batches)
        out = {}
        for b in batches:
            self._note_ids({n: a._get() if isinstance(a, NDArray)
                            else torch.as_tensor(a)
                            for n, a in zip(self.data_names, b.data or [])
                            if a is not None})
        for names, field in ((self.data_names, "data"),
                             (self.label_names, "label")):
            for i, name in enumerate(names):
                col = []
                for b in batches:
                    arrs = getattr(b, field) or []
                    if i >= len(arrs) or arrs[i] is None:
                        raise MXNetError("superstep training needs input %r"
                                         % name)
                    col.append(arrs[i])
                out[name] = stack_batch_arrays(col, self.device)
        return k, self._local_mega(out)

    def _local_mega(self, mega: Dict[str, torch.Tensor]):
        """This rank's rows (dim 1) of a megabatch under a named mesh."""
        if not self.slice_batch:
            return mega
        b = self._batch_of(mega, 1)
        return {n: self._local_rows(t, 1, b) for n, t in mega.items()}

    def superstep(self, k: int, mega: Dict[str, torch.Tensor], lrs,
                  reducer=None, acc_tree=None):
        """Run K steps over the staged megabatch: per position, copy its
        slice into the step's static inputs, replay the step at that
        position's lr, and run the metric reducer on the step's labels
        and outputs.  ``acc_tree`` is the reducer's starting accumulator;
        -> the static accumulator tensors after the K steps (on the
        device; the caller drains them)."""
        acc_key = None
        for i in range(k):
            src = {n: t[i] for n, t in mega.items()}
            key = self._key(src)
            bufs = self._buffers.get(key)
            if bufs is None:
                bufs = {n: torch.empty(t.shape, dtype=t.dtype,
                                       device=self.device)
                        for n, t in src.items()}
                self._buffers[key] = bufs
            for n, t in src.items():
                bufs[n].copy_(t)
            outs = self.step(bufs, lr=lrs[i])
            if reducer is None:
                continue
            if acc_key is None:
                acc_key = (key, reducer.signature)
                entry = self._metric_graphs.get(acc_key)
                flat0 = flatten_tensors(acc_tree)
                if entry is None:
                    entry = [None, [t.clone() for t in flat0], 0]
                    self._metric_graphs[acc_key] = entry
                else:
                    for b, t in zip(entry[1], flat0):
                        b.copy_(t)
            self._reduce(key, entry, reducer, acc_tree, bufs, outs)
        return None if acc_key is None else entry[1]

    def _reduce(self, key, entry, reducer, acc_tree, bufs, outs):
        """acc <- reducer.update(acc, labels, outs) in place on the
        static accumulators: eagerly on the host, and on the card while
        the step is not captured yet; then one eager warm-up on a side
        stream, then a captured graph replayed after each step."""
        def body():
            labels = [bufs[n] for n in self.label_names]
            if self.slice_batch:
                # the outputs are the global batch's: so are the labels
                from ..parallel.data_parallel import gather_outputs
                labels = gather_outputs(labels, self.axis,
                                        self._batch_of(bufs, 0))
            new = reducer.update(unflatten_tensors(acc_tree, entry[1]),
                                 labels, list(outs))
            for b, v in zip(entry[1], flatten_tensors(new)):
                b.copy_(v)
        if not self.captured or key not in self._graphs:
            body()
            return
        if entry[0] is not None:
            entry[0].replay()
            return
        if entry[2] == 0:
            main = torch.cuda.current_stream(self.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                body()
            main.wait_stream(self._side)
            entry[2] = 1
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        entry[0] = graph
        graph.replay()

    # -- speculation ----------------------------------------------------------
    def snapshot_state(self):
        """A device copy of the train state (params, fixed, aux, optimizer
        slots, the step count), enqueued on the current stream; the
        device generator's state rides along."""
        with torch.no_grad():
            snap = {g: map_structure(lambda t: t.detach().clone(),
                                     self.state[g])
                    for g in ("params", "fixed", "aux", "opt", "t")}
        # the generator's state (on the card its seed and offset, kept on
        # the host): a discarded step drawn again draws the same numbers
        snap["rng"] = _random.generator(self.device).get_state()
        return snap

    def restore_state(self, snap) -> None:
        """Write a :meth:`snapshot_state` copy back into the live state
        buffers (which the captured graphs read)."""
        def put(group_live, group_snap):
            if isinstance(group_live, dict):
                for n in group_live:
                    put(group_live[n], group_snap[n])
            elif isinstance(group_live, (tuple, list)):
                for a, b in zip(group_live, group_snap):
                    put(a, b)
            elif group_live is not None:
                group_live.detach().copy_(group_snap)
        with torch.no_grad():
            for g in ("params", "fixed", "aux", "opt", "t"):
                put(self.state[g], snap[g])
        if "rng" in snap:
            _random.generator(self.device).set_state(snap["rng"])

    def forward_only(self, batch: Dict[str, torch.Tensor],
                     is_train: bool = False, state=None) -> List[torch.Tensor]:
        """A forward on the live params (or those of ``state``, a
        :meth:`snapshot_state` copy) that changes no state (eval, or a
        train-mode forward whose aux updates are dropped)."""
        st = self.state if state is None else state
        args = dict(st["params"])
        args.update(st["fixed"])
        args.update(self._maybe_augment(batch, is_train))
        opctx = OpContext(is_train=is_train,
                          generator=_random.generator(self.device))
        with torch.no_grad():
            outs, _ = self._prog.eval(args, st["aux"], opctx)
        return outs

    def read_params(self, arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray], state=None) -> None:
        """Copy the live state (or ``state``, a :meth:`snapshot_state`
        copy) into the given dicts' arrays."""
        st = self.state if state is None else state
        with torch.no_grad():
            for group, names, out in (("params", self.train_names,
                                       arg_params),
                                      ("fixed", self.fixed_names,
                                       arg_params),
                                      ("aux", self.aux_names, aux_params)):
                for n in names:
                    out[n][:] = st[group][n].detach()
