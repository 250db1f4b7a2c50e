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

**rematerialization** (reference ``fused.py:220-224, 678-685``): with
``remat`` (``MXNET_BACKWARD_DO_MIRROR=1``, or a joint-autotune winner
through ``Module.apply_joint_config``) the whole loss -- the graph walk
after the sparse prologue -- runs under ``torch.utils.checkpoint``
(``executor.checkpointed``): the backward recomputes the forward, the
draws of the first run are replayed (Dropout's mask is the same), and
BatchNorm's new moving statistics leave the region as values, so the
recompute writes them no second time.  The trajectory is bitwise that
of a run without it.

**programs** (reference ``fused.py:740-773``): each batch shape's
capture goes through a ``compile_cache.cached_program`` (``fused:step``;
the superstep's metric reducer graph, ``fused:metric``), so
``compile_report()`` counts and times it (the eager warm-up included)
and a capture for a new shape of a step that already captured one is a
steady-state rebuild.  :meth:`prepare` warms and captures a batch shape
ahead of the loop without advancing training.

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
all-gathered.  The inputs cut on the batch are handed to the graph walk
as this rank's rows (``eval(rows=)``), so an op that draws (Dropout,
rrelu, the RNN's inter-layer dropout) draws the global batch's numbers
and keeps its rows: the ranks draw one device's mask.  Under a named
mesh ``batched_sharding()`` is a ``feed.RowShard``: the feed stages only
this rank's rows, and ``make_batch`` takes such a batch as it is.
``MXNET_SHARD_WEIGHT_UPDATE=1`` reduce-scatters the
gradients of params whose leading dim the dp size divides, updates this
rank's rows and their optimizer slots only, and all-gathers the rows.
The params are broadcast from the axis's rank 0 at ``init_state``.
Under an NCCL group of several ranks the step runs on this rank's card
(``dist.boot.rank_card``: the default ``gpu(0)`` names it).  On an NCCL
group the collectives are issued inside the captured graph
(``scaleout_check.py nccl`` holds this on four cards).  On a gloo group
(ranks sharing a card) they are host-staged and cannot be captured, so
the step runs eagerly on the card (``eager_steps``).
A sparse table keeps the lazy row update over ``dp`` (reference
``fused.py:183-193``): the ranks' ids are all-gathered and the global
batch deduped alike on every rank (the unique cap resolved against it,
as on one device), each rank's gradients of the unique rows are summed
over ``dp``, and every rank applies the same row update, so rows no
rank's batch touched keep their weights and slots.  A table given the
spec ``(axis, None)`` is row-sharded (reference ``table.py:79-146``):
each rank stores its block of ``vocab / n`` rows, with a scratch row of
its own, and its slots; the unique rows are gathered by their owners
(zero elsewhere) and summed over the axis, and each owner updates its
rows only.  A ``_moe_dispatch`` block routes the global batch
(``moe.router.route(dp=)``).

**sharded state** (reference ``fused.py:141-160, 338-440``): with a
named mesh, ``sharding=`` merged over the graph's ``__sharding__``
attributes (the map wins) gives per-parameter specs.  Each rank holds
its shard of such a parameter, and of its aux state, at rest; the
optimizer slots take the shard's shape.  The graph walk runs over
layouts (``executor._GraphProgram.eval(shards=)``), so the values are
the single-device values up to the summing order.  A shard's local
gradient is its shard's, summed over ``dp``; a parameter cut over
``dp`` itself comes out of its gather already summed (``"summed"`` in
``dp_update``).  ``MXNET_SHARD_WEIGHT_UPDATE`` cuts dim 0 of a slot over
``dp`` where the spec leaves dim 0 uncut and spends no ``dp``.
``read_params`` gathers the whole values (a collective: every rank
calls it), ``gathered_state``/``shard_of`` move a train state between
layouts, and ``leaf_cuts`` names each leaf's cuts for the multi-process
checkpoint.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

from .. import trace as _trace
from ..base import MXNetError, get_env
from ..checkpoint.snapshot import map_structure
from ..embed.sparse import (_mask_oov_rows, block_rows, dedup_ids,
                            map_slots, resolve_cap, slot_leaves_row_shaped,
                            sparse_apply_rows)
from ..executor import _GraphProgram, checkpointed
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
                 mesh=None, global_dp: bool = False, sharding=None,
                 remat: bool = False):
        # the dp axis: a named mesh's, or every rank's under dist_sync
        self.axis = None
        self.slice_batch = False
        self.mesh = mesh
        self.param_specs = {}
        if mesh is not None:
            if "dp" not in mesh.axis_names:
                raise MXNetError(
                    "mesh %s has no 'dp' axis; the batch shards over "
                    "'dp' — use dp=1 for one rank" % (dict(mesh.shape),))
            self.axis = mesh.axis("dp")
            self.slice_batch = not global_dp
            self.param_specs = merged_specs(
                symbol, sharding, mesh,
                set(param_names) | set(symbol.list_auxiliary_states()))
        elif sharding:
            raise MXNetError("sharding= needs a named mesh (mesh=): specs "
                             "are PartitionSpecs over its axes")
        elif global_dp:
            from ..parallel.mesh import make_mesh
            self.axis = make_mesh([("dp", -1)]).axis("dp")
        # name -> its (dim, axis) cuts and its whole shape, set by
        # init_state
        self._cuts: Dict[str, list] = {}
        self._global: Dict[str, tuple] = {}
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
            and (n not in self.param_specs
                 or row_axis(self.param_specs[n]) is not None)}
        # name -> (table storage with its scratch row, its slots)
        self._sparse_store = {}
        # name -> (the axis owning its row blocks, first row of this
        # rank's block, block size) of a row-sharded table
        self._row_blocks = {}
        # batch key -> names of the inputs holding this rank's rows (and
        # those of the megabatch being stepped through)
        self._row_names: Dict[tuple, tuple] = {}
        self._mega_rows = ()
        # whether the last batch came from the feed already cut to this
        # rank's rows (its labels then are this rank's rows only)
        self.fed_rows = False
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
        self.moe_stats = None
        if self.moe_blocks:
            from ..moe.stats import MoeStats
            from .. import profiler
            self.moe_stats = MoeStats("fused")
            profiler.register_moe_stats(self.moe_stats)
        self._prog = _GraphProgram(symbol)
        # the whole loss under torch.utils.checkpoint (see the docstring)
        self._remat = bool(remat)
        self.global_dp = bool(global_dp)
        # the captures' CachedFunctions, made on first use
        self._step_prog = None
        self._metric_prog = None
        self._pending_reduce = None
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
        # over a mesh of more than one rank: dispatch time every step,
        # the step's device wall on a sampled subset (one drain every
        # sample_every steps), and the step's cost and collective census
        # (reference fused.py:256-268)
        self.multichip_stats = None
        if mesh is not None and mesh.size > 1:
            from .. import profiler as _prof
            from ..parallel.mesh import mesh_axes, spec_axes
            self.multichip_stats = _prof.MultichipStats(
                "fused", axes=mesh_axes(mesh),
                spec_axes=sorted({a for sp in self.param_specs.values()
                                  for a in spec_axes(sp)}))
            _prof.register_multichip_stats(self.multichip_stats)

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

    def _cut_rows(self, src: Dict[str, torch.Tensor], dim: int,
                  rows_cut) -> tuple:
        """Cut ``src`` (in place) to this rank's rows along ``dim``; ->
        the names of the inputs that hold them.  ``rows_cut``: the flags
        of a batch the feed already cut (``feed.RowShard``), data then
        labels.  Under ``dist_sync`` each rank's own batch is its rows:
        the inputs whose ``dim`` has the first data input's size."""
        if self.axis is None or self.axis.size < 2:
            return ()
        names = [n for n in self.data_names + self.label_names if n in src]
        if rows_cut is not None:
            return tuple(n for n, c in zip(names, rows_cut) if c)
        b = self._batch_of(src, dim)
        hit = tuple(n for n in names if src[n].dim() > dim
                    and src[n].shape[dim] == b)
        if self.slice_batch:
            for n in hit:
                src[n] = self._local_rows(src[n], dim, b)
        return hit

    def global_labels(self, labels):
        """``labels`` of the last batch as the outputs are: the global
        batch's (all-gathered over ``dp``, a collective every rank
        calls) when the feed staged this rank's rows only."""
        if not self.fed_rows:
            return labels
        from ..parallel.data_parallel import gather_outputs
        ts = [a._get() if isinstance(a, NDArray) else torch.as_tensor(a)
              for a in labels]
        return [NDArray(t) for t in gather_outputs(
            ts, self.axis, int(ts[0].shape[0]) if ts else 0)]

    def _batch_of(self, src: Dict[str, torch.Tensor], dim: int) -> int:
        return int(src[self.data_names[0]].shape[dim]) \
            if self.data_names and self.data_names[0] in src else 0

    def batched_sharding(self):
        """Where input pipelines stage batches (feed.device_feed,
        DevicePutStage): the step's device, or under a named mesh a
        ``feed.RowShard`` naming it and this rank's rows of ``dp``, so
        only those rows cross to the card.  ``make_batch`` copies them
        device to device into its static buffers."""
        if self.slice_batch and self.axis.size > 1:
            from ..feed.stages import RowShard
            return RowShard(self.device, self.axis.index, self.axis.size)
        return self.device

    def megabatched_sharding(self):
        """Where a K-step megabatch is staged: as
        :meth:`batched_sharding` (each of the K batches cut alike)."""
        return self.batched_sharding()

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
        self.drop_graphs()

    def _maybe_augment(self, batch: Dict[str, torch.Tensor], train: bool,
                       rows=()):
        """The prologue: applies ONLY when the first data input is a 4-D
        uint8 tensor (the compact HWC wire) -- a float32 batch from a
        host-augmented eval iterator passes through untouched.  On this
        rank's rows of a batch cut over ``dp`` (``rows``) the global
        batch's draws are made and this rank's kept, so the ranks crop
        and flip as one device does."""
        spec = self.device_augment
        if spec is None or not self.data_names:
            return batch
        name = self.data_names[0]
        x = batch.get(name)
        if x is None or x.dtype != torch.uint8 or x.dim() != 4:
            return batch
        from ..feed.augment import augment_batch, draw
        out = dict(batch)
        draws = []
        rng = _random.generator(self.device)
        if name in rows:
            n, ax = x.shape[0], self.axis
            rng = tuple(d.narrow(0, ax.index * n, n)
                        for d in draw(n * ax.size, spec, train, rng,
                                      x.device))
        out[name] = augment_batch(x, rng, spec, train, out_draws=draws)
        if self.augment_probe is not None and not (
                x.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.augment_probe.append((x.clone(), draws[0], out[name]))
        return out

    # -- state ---------------------------------------------------------------
    @property
    def sharded(self) -> bool:
        """Whether any state lives cut across ranks (specs, or the
        sharded weight update's slots)."""
        return bool(self.param_specs) or any(
            isinstance(r, tuple) for r in self._rows.values())

    def _walk_mesh(self):
        return self.mesh if self.param_specs else None

    def init_state(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]) -> None:
        """Copy the params onto the device as the persistent state (the
        params are autograd leaves, updated in place; a parameter with a
        spec as this rank's shard); drops every captured graph, which
        read the old state."""
        from ..parallel.mesh import spec_pairs, shard_tensor, validate_spec

        # rank 0's values win on every rank
        axes = [self.mesh.axis(a) for a in self.mesh.axis_names] \
            if self.mesh is not None else \
            [self.axis] if self.axis is not None else []

        def put(v, n):
            t = _broadcast_mesh(v._get().detach().to(self.device, copy=True),
                                axes)
            spec = self.param_specs.get(n)
            if spec is None:
                return t
            validate_spec(n, spec, self.mesh, shape=tuple(t.shape))
            self._cuts[n] = spec_pairs(spec, t.dim())
            self._global[n] = tuple(t.shape)
            return shard_tensor(t, self._cuts[n], self.mesh)
        from ..parallel.collectives import shard_rows
        from ..parallel.mesh import spec_axes
        params, opt = {}, {}
        self._sparse_store = {}
        self._rows = {}
        self._cuts = {}
        self._global = {n: tuple(v.shape) for n, v in arg_params.items()}
        self._global.update((n, tuple(v.shape))
                            for n, v in aux_params.items())
        self._row_blocks = {}
        for n in self.train_names:
            w = put(arg_params[n], n)
            if n not in self.sparse_embeds:
                params[n] = w.requires_grad_(True)
                spec = tuple(self.param_specs.get(n) or ())
                if "dp" in spec_axes(spec):
                    rows = "summed"
                elif self.axis is None or (spec and spec[0] is not None):
                    rows = None
                else:
                    rows = shard_rows(self.axis, tuple(w.shape),
                                      self.shard_update)
                self._rows[n] = rows
                opt[n] = self._opt_init(w.detach()
                                        if not isinstance(rows, tuple)
                                        else w.detach()[rows[0]:rows[1]])
                continue
            # the rows this rank stores: the whole table, or its block
            # of a row-sharded one, and one scratch row
            vocab = w.shape[0]
            if n in self._cuts:
                ax = self.mesh.axis(self._cuts[n][0][1])
                self._row_blocks[n] = (ax, ax.index * vocab, vocab)
            store = torch.zeros((vocab + 1,) + tuple(w.shape[1:]),
                                dtype=w.dtype, device=self.device)
            store[:vocab] = w
            slots = self._opt_init(store)
            self._sparse_store[n] = (store, slots)
            params[n] = store[:vocab]
            opt[n] = map_slots(lambda t, _v=vocab: t[:_v], slots)
        self.state = {
            "params": params,
            "fixed": {n: put(arg_params[n], n) for n in self.fixed_names},
            "aux": {n: put(aux_params[n], n) for n in self.aux_names},
            "opt": opt,
            "t": torch.zeros((), dtype=torch.float32, device=self.device),
            "lr": torch.zeros((), dtype=torch.float32, device=self.device)}
        self._buffers.clear()
        self.drop_graphs()
        self._lr_host = None

    def drop_graphs(self) -> None:
        """Forget every captured graph (they read the old state, or an
        old prologue or remat setting): the next capture is a new
        program, not a rebuild."""
        self._graphs.clear()
        self._warm.clear()
        self._metric_graphs.clear()
        self._step_prog = None
        self._metric_prog = None

    def set_remat(self, remat: bool) -> bool:
        """Turn rematerialization on or off; a real change drops the
        captured graphs (the checkpoint is part of them).  -> whether it
        changed."""
        if bool(remat) == self._remat:
            return False
        self._remat = bool(remat)
        self.drop_graphs()
        return True

    def _program_desc(self, tag: str) -> str:
        """The description of this step's programs (their
        ``compile_report()`` fast key): the symbol graph plus everything
        the capture closes over -- optimizer class and baked values,
        per-name factors, remat, the augmentation prologue, the sharded
        update, dp, the mesh and its specs, the sparse-embed and MoE
        geometry, and the train/fixed/label split (reference
        fused.py:740-773)."""
        import hashlib
        h = hashlib.sha256()
        h.update(self._prog.symbol.tojson().encode())
        mesh = self.mesh
        for part in (tag, type(self.optimizer).__name__,
                     repr(self.hparam_signature()),
                     repr(sorted(self._lr_mult.items())),
                     repr(sorted(self._wd.items())), str(self._remat),
                     repr(self.device_augment.signature()
                          if self.device_augment is not None else None),
                     str(self.shard_update), str(self.global_dp),
                     repr(None if mesh is None
                          else tuple(mesh.shape.items())),
                     repr(sorted((n, tuple(sp)) for n, sp in
                                 self.param_specs.items())),
                     repr(sorted((n, sp.describe())
                                 for n, sp in self.sparse_embeds.items())),
                     repr(sorted((n, sp.describe())
                                 for n, sp in self.moe_blocks.items())),
                     str(self.device), repr(self.train_names),
                     repr(self.fixed_names), repr(self.label_names)):
            h.update(str(part).encode())
            h.update(b"\x00")
        return "fused|%s" % h.hexdigest()

    def _captures(self):
        """The step's capture program (``fused:step``): one CUDA graph
        per batch signature."""
        if self._step_prog is None:
            from ..compile_cache import cached_program
            self._step_prog = cached_program(
                self._capture_step, name="fused:step",
                fast_key=self._program_desc("step"))
        return self._step_prog

    def _capture_step(self, batch):
        from ..compile_cache import capture
        graph, outs = capture(self.device, lambda: self._body(batch))
        self.stats.captures += 1
        return _Captured(graph, outs)

    def _capture_metric(self, key, signature):
        from ..compile_cache import capture
        graph, _ = capture(self.device, self._pending_reduce)
        return graph

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

    def make_batch(self, data_batch,
                   note_ids: bool = True) -> Dict[str, torch.Tensor]:
        """Copy one DataBatch into the step's static input buffers of its
        shapes (allocated on first sight); -> {name: buffer}.
        ``note_ids=False`` leaves the embedding statistics alone (a
        warm-up's zero batch)."""
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
        rows_cut = getattr(data_batch, "rows_cut", None)
        self.fed_rows = rows_cut is not None
        if rows_cut is None and note_ids:
            # the global batch's ids (one device's statistics)
            self._note_ids(src)
        rows = self._cut_rows(src, 0, rows_cut)
        if rows_cut is not None and note_ids:
            self._note_ids(src)
        key = self._key(src)
        self._row_names[key] = rows
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
        autograd leaves of the tables.  Over ``dp`` the dedup is the
        global batch's (the ranks' ids all-gathered, deduped alike on
        every rank) and ``inv`` this rank's part of it."""
        from ..parallel.collectives import _gather_raw
        ctx = {}
        dp = self.axis if self.axis is not None and self.axis.size > 1 \
            else None
        for n, sp in self.sparse_embeds.items():
            ids = args[sp.ids_name]
            flat = ids.reshape(-1).to(torch.int32)
            every = _gather_raw(flat, dp, 0) if dp is not None else flat
            cap = resolve_cap(sp.cap, every.numel(), sp.vocab)
            uniq, inv = dedup_ids(every, cap, sp.vocab)
            if dp is not None:
                inv = inv.narrow(0, dp.index * flat.numel(), flat.numel())
            rows = self._table_rows(n, sp, uniq)
            rows.requires_grad_(True)
            args[n] = rows
            args[sp.ids_name] = inv.reshape(ids.shape)
            ctx[n] = (uniq, rows)
        return ctx

    def _owned(self, n: str, uniq: torch.Tensor):
        """-> (index of each unique id in this rank's storage, owned
        mask): a row-sharded table's non-owned (and sentinel) ids index
        its scratch row; a whole table owns every real id."""
        blk = self._row_blocks.get(n)
        if blk is None:
            return uniq.long(), None
        return block_rows(uniq, blk[1], blk[2])

    def _table_rows(self, n: str, sp, uniq: torch.Tensor) -> torch.Tensor:
        """The unique rows of table ``n`` (out-of-range ids zero): from
        this rank's storage, or a row-sharded table's owners' rows summed
        over its axis (every other rank gives zeros)."""
        from ..parallel.collectives import all_reduce_
        store = self._sparse_store[n][0]
        idx, own = self._owned(n, uniq)
        rows = _mask_oov_rows(store[idx], uniq, sp.vocab)
        if own is None:
            return rows
        rows = torch.where(own.unsqueeze(-1), rows, torch.zeros_like(rows))
        return all_reduce_(rows, self._row_blocks[n][0])

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
        cut = {k: 0 for k in self._row_names.get(self._key(batch), ())}
        args = dict(params)
        args.update(st["fixed"])
        args.update(self._maybe_augment(batch, True, cut))
        opctx = OpContext(is_train=True,
                          generator=_random.generator(self.device),
                          dp=self.axis, mesh=self._walk_mesh())
        with torch.enable_grad():
            with record_function("fused:forward"):
                sparse = self._sparse_prologue(args)

                def walk():
                    return self._prog.eval(args, st["aux"], opctx,
                                           shards=self._walk_cuts(),
                                           rows=cut)
                if self._remat:
                    outs, new_aux = checkpointed(walk, opctx)
                else:
                    outs, new_aux = walk()
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
                g = torch.zeros_like(rows) if g is None else g
                if self.axis is not None and self.axis.size > 1:
                    from ..parallel.collectives import all_reduce_
                    all_reduce_(g, self.axis)
                idx, _own = self._owned(n, uniq)
                sparse_apply_rows(store, slots, idx, self._grad(g, rows),
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

    def _walk_cuts(self) -> Dict[str, list]:
        """The cuts the graph walk enters: a sparse table's rows reach it
        whole (the prologue's unique rows)."""
        return {n: c for n, c in self._cuts.items()
                if n not in self.sparse_embeds}

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
        card: the graph's static buffers).

        The spans (reference fused.py:879-926) stay on the host, around
        the call: ``fused:first_step(compile)`` around a step that builds
        the batch shape's program (the eager warm-ups and the capturing
        step on the card, the first eager step on the CPU) and
        ``fused:dispatch`` around every other (a replay on the card).
        Over a mesh of more than one rank a sampled step also drains the
        stream before and after (``fused:device_wait(sampled)``); with no
        such mesh the step reads nothing back."""
        if lr is None:
            lr = float(self.optimizer.base_lr())
        if lr != self._lr_host:
            self.state["lr"].fill_(lr)
            self._lr_host = lr
        stats = self.multichip_stats
        if stats is None and not _trace.enabled():
            return self._run(batch)
        import time
        key = self._key(batch)
        build = key not in self._graphs if self.captured \
            else self._warm.get(key, 0) == 0
        sample = first = False
        if stats is not None:
            first = stats.steps == 0
            sample = not first and stats.should_sample()
            if sample:
                # drain the queue first, or the sampled wait charges
                # the steps still queued to this one
                self._sync()
            if first:
                from ..parallel import collectives
                census0 = (collectives.STATS["calls"],
                           collectives.STATS["bytes"],
                           {k: dict(v) for k, v in
                            collectives.STATS["by_op"].items()})
        t0 = time.perf_counter()
        outs = self._run(batch)
        dt = time.perf_counter() - t0
        if not self.captured and build:
            self._warm[key] = 1
        _trace.complete("fused:first_step(compile)" if build
                        else "fused:dispatch", t0, dt, cat="train")
        if stats is not None:
            if first:
                stats.note_first(dt)
                # the first step runs eagerly: what the collectives
                # module counted in it is one step's census
                stats.set_cost(stats.flops_per_step, stats.bytes_per_step,
                               collectives=_census(census0))
            else:
                stats.add_step(dt)
            if sample:
                t1 = time.perf_counter()
                self._sync()
                wait = time.perf_counter() - t1
                stats.add_wait(wait)
                _trace.complete("fused:device_wait(sampled)", t1, wait,
                                cat="train")
        return outs

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, batch: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        if not self.captured:
            self.stats.eager_steps += 1
            return self._body(batch)
        key = self._key(batch)
        cap = self._graphs.get(key)
        if cap is None:
            done = self._warm.get(key, 0)
            if done < WARMUP_STEPS:
                import time
                from ..compile_cache import get_stats
                t0 = time.perf_counter()
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
                get_stats().note_build_time("fused:step",
                                            time.perf_counter() - t0)
                return outs
            cap = self._graphs[key] = self._captures().compile_for(batch)
        cap.graph.replay()
        self.stats.replays += 1
        return cap.outputs

    def prepare(self, batch: Dict[str, torch.Tensor]) -> str:
        """Warm and capture the step of this batch's shapes (a
        :meth:`make_batch` result) ahead of the loop without advancing
        training: the train state (with the generator's) is copied aside,
        the eager warm-up steps run, the copy is written back into the
        same tensors (the addresses the graph reads do not change), and
        the graph is captured, which runs nothing.  The first real step
        then replays, and the trajectory is bitwise that of a run without
        this call.  On the CPU (or a host-staged dp group) there is no
        graph: one eager step checks the walk, and is undone the same
        way.  -> ``"present"`` or ``"compiled"``."""
        key = self._key(batch)
        if key in self._graphs:
            return "present"
        n = WARMUP_STEPS - self._warm.get(key, 0) if self.captured else 1
        if n > 0:
            snap = self.snapshot_state()
            try:
                for _ in range(n):
                    self.step(batch)
            finally:
                self.restore_state(snap)
        if self.captured:
            self._graphs[key] = self._captures().compile_for(batch)
        return "compiled"

    # -- superstep ------------------------------------------------------------
    def make_megabatch(self, batches, note_ids: bool = True):
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
            out = self._local_mega(out, getattr(batches, "rows_cut", None))
            for i in range(k if note_ids else 0):
                self._note_ids({n: t[i] for n, t in out.items()})
            return k, out
        k = len(batches)
        out = {}
        for b in (batches if note_ids else ()):
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
        return k, self._local_mega(out, getattr(batches[0], "rows_cut",
                                                None))

    def _local_mega(self, mega: Dict[str, torch.Tensor], rows_cut=None):
        """This rank's rows (dim 1) of a megabatch under a named mesh
        (``rows_cut``: the flags of one the feed already cut)."""
        mega = dict(mega)
        self._mega_rows = self._cut_rows(mega, 1, rows_cut)
        return mega

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
            self._row_names[key] = self._mega_rows
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
        if self._metric_prog is None:
            from ..compile_cache import cached_program
            self._metric_prog = cached_program(
                self._capture_metric, name="fused:metric",
                fast_key=self._program_desc("metric"))
        self._pending_reduce = body
        try:
            graph = self._metric_prog.compile_for(key, reducer.signature)
        finally:
            self._pending_reduce = None
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
                          generator=_random.generator(self.device),
                          mesh=self._walk_mesh())
        with torch.no_grad():
            outs, _ = self._prog.eval(args, st["aux"], opctx,
                                      shards=self._cuts)
        return outs

    def read_params(self, arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray], state=None) -> None:
        """Copy the live state (or ``state``, a :meth:`snapshot_state`
        copy) into the given dicts' arrays, sharded values gathered
        whole (a collective under a mesh: every rank calls it)."""
        from ..parallel.mesh import gather_tensor
        st = self.state if state is None else state
        with torch.no_grad():
            for group, names, out in (("params", self.train_names,
                                       arg_params),
                                      ("fixed", self.fixed_names,
                                       arg_params),
                                      ("aux", self.aux_names, aux_params)):
                for n in names:
                    t = st[group][n].detach()
                    if self._cuts.get(n):
                        t = gather_tensor(t, self._cuts[n], self.mesh)
                    out[n][:] = t

    # -- layouts of the train state -------------------------------------------
    def leaf_cuts(self, group: str, name: str) -> list:
        """The (dim, axis) cuts of a state leaf: a parameter's or aux
        state's spec; an optimizer slot's adds the sharded update's dim-0
        cut over ``dp``."""
        cuts = list(self._cuts.get(name) or ())
        if group == "opt" and isinstance(self._rows.get(name), tuple):
            cuts.append((0, "dp"))
        return cuts

    def gathered_state(self, state=None):
        """``{"params", "fixed", "aux", "opt"}`` of the live state (or
        ``state``) with every sharded leaf gathered whole."""
        from ..parallel.mesh import gather_tensor
        st = self.state if state is None else state

        def whole(g, n, t):
            t = t.detach()
            return gather_tensor(t, self.leaf_cuts(g, n), self.mesh) \
                if self._is_cut(g, n, t) else t
        with torch.no_grad():
            return {g: {n: map_structure(
                lambda t, _g=g, _n=n: whole(_g, _n, t), v)
                for n, v in st[g].items()}
                for g in ("params", "fixed", "aux", "opt")}

    def shard_of(self, group: str, name: str, value):
        """This rank's shard of a whole leaf ``value`` (as it is when
        the leaf is not cut, or ``value`` already has the shard's
        shape)."""
        from ..parallel.mesh import shard_tensor
        cuts = self.leaf_cuts(group, name)
        if not cuts or value is None or \
                tuple(value.shape) != self._global.get(name):
            return value
        return shard_tensor(value, cuts, self.mesh)

    def _is_cut(self, group: str, name: str, t) -> bool:
        """Whether leaf ``t`` is cut: a value of the parameter's shard
        shape (an optimizer's scalar slot is not)."""
        from ..parallel.mesh import local_shape
        cuts = self.leaf_cuts(group, name)
        return bool(cuts) and name in self._global and tuple(t.shape) == \
            local_shape(self._global[name], cuts, self.mesh)


def _census(before) -> Dict:
    """The collectives module's calls, bytes and redistributions since
    ``before`` (its counters then)."""
    from ..parallel import collectives
    st = collectives.STATS
    by_op = {}
    for op, kinds in st["by_op"].items():
        old = before[2].get(op, {})
        delta = {k: n - old.get(k, 0) for k, n in kinds.items()
                 if n - old.get(k, 0)}
        if delta:
            by_op[op] = delta
    return {"total_count": st["calls"] - before[0],
            "total_bytes": st["bytes"] - before[1],
            "redistributions": by_op}


def row_axis(spec):
    """The axis of a table spec that cuts its rows only (``(axis,
    None)``), else None."""
    from ..parallel.mesh import spec_pairs
    pairs = spec_pairs(spec, 2)
    return pairs[0][1] if len(pairs) == 1 and pairs[0][0] == 0 else None


def merged_specs(symbol, sharding, mesh, known) -> Dict:
    """The spec map of a named mesh: ``__sharding__`` symbol attributes
    with ``sharding`` over them, each normalized and checked against the
    mesh's axes (reference fused.py:141-160)."""
    from ..parallel.mesh import normalize_spec, sharding_attrs, validate_spec
    specs = sharding_attrs(symbol)
    specs.update(sharding or {})
    unknown = sorted(set(specs) - set(known))
    if unknown:
        raise MXNetError(
            "sharding specs name no bound parameter: %s (params: %s)"
            % (unknown, sorted(known)))
    out = {}
    for n, sp in specs.items():
        sp = normalize_spec(sp)
        validate_spec(n, sp, mesh)
        if any(e is not None for e in sp):
            out[n] = sp
    return out


def _broadcast_mesh(t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` with the value of the rank at index 0 of every axis in
    ``axes`` (the broadcast init: rank 0's values win)."""
    from ..parallel.collectives import broadcast_
    for ax in axes:
        if ax.size > 1:
            broadcast_(t, ax)
    return t
