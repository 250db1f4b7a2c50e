"""Module: the intermediate-level API over one symbol (counterpart of
``mxnet_tpu/module/module.py``).

Two paths, as in the reference:

* **fused** (the default when the configuration allows it, ``_fusable``):
  ``forward(is_train=True)`` stores the batch in the fused step's static
  buffers, ``backward()`` does nothing, and ``update()`` runs the whole
  batch body, one CUDA graph replay on the card (``module/fused.py``).
  An eval forward runs on the live params.  Explicit head gradients or a
  change to the optimizer values the step baked in leave the fused path
  for the classic one (``_disable_fused``), with the params, the
  optimizer state and the step count carried over.  Several distinct
  devices of one type in one process run the fused step on the first of
  them over the whole batch.  Over several processes, one rank per
  device: ``set_mesh``/``fit(mesh=)`` (every rank fed the global batch,
  keeping its rows) and a ``dist_sync`` kvstore (each rank its own
  batch, ``rescale_grad`` = 1 / (batch * num_workers)) run the fused
  step over the ``dp`` axis, gradients summed inside it, and
  ``sharding=`` holds each parameter with a spec as this rank's shard;
  a module over a mesh never leaves the fused path;
* **classic**: one executor per context over its slice of the batch
  (``work_load_list``), then the gradients summed through the kvstore
  and the updater per parameter and device, or the kvstore's own update
  (``model._update_params`` / ``_update_params_on_kvstore``).

``superstep_train`` runs K batches (a list, or a ``feed.MegaBatch``
staged by ``prefetch_to_device(megabatch=K)``) as K replays of the
captured step with the metric reduced on the device and drained once
(``fit``'s ``superstep=``).  ``apply_augment_spec`` installs a uint8
feed's augmentation prologue on the fused step; the classic path cannot
take that wire, so leaving the fused path with one installed raises.
Outputs asked for between a train forward and ``update()`` run the
pending step early (``_fused_commit_early``); a new forward puts the
state from before it back (``_discard_speculation``).

A monitor (``install_monitor``), duplicate contexts (``[gpu(0),
gpu(0)]``, how several devices run on one card), mixed device types and
``ctx_group`` attributes keep a module on the classic path.  A module
bound with ``shared_module=`` (a bucket of ``BucketingModule``) shares
the parent's executor arrays and, once the parent has one, borrows its
optimizer and updater; lending the executor group or borrowing the
optimizer keeps a module on the classic path, as in the reference
(``mxnet_tpu/module/module.py:292-322``).

``MXNET_FUSED_TRAIN=0`` keeps the module on the classic path (the
fused-against-classic parity check).  The params the module hands out
(``get_params``) are host arrays.
"""
from __future__ import annotations

import logging
import time

import torch

from ..base import MXNetError, get_env
from ..context import Context, cpu, current_context
from ..initializer import Uniform
from ..ndarray import NDArray, zeros as nd_zeros
from .. import metric as metric_mod
from .. import optimizer as opt_mod
from ..model import (_create_kvstore, _initialize_kvstore, _param_idx2name,
                     _update_params, _update_params_on_kvstore)
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup
from .fused import FusedTrainStep, unflatten_tensors

__all__ = ["Module"]


class Module(BaseModule):
    """Module over a Symbol (reference module.py:18)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if context is None:
            context = [current_context()]
        if isinstance(context, Context):
            context = [context]
        self._context = context
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        assert len(work_load_list) == len(self._context)
        self._work_load_list = work_load_list
        self._symbol = symbol
        data_names = list(data_names) if data_names else []
        label_names = list(label_names) if label_names else []
        arg_names = symbol.list_arguments()
        input_names = data_names + label_names
        self._param_names = [x for x in arg_names if x not in input_names]
        self._fixed_param_names = list(fixed_param_names) \
            if fixed_param_names else []
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._updater = None
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None
        self._grad_req = "write"
        self._no_slice_names = ()
        # the fused step and its per-batch artifacts: the batch stored by
        # a train forward, the last step's outputs (copies, made lazily),
        # and the number of fused steps taken
        self._fused = None
        self._mesh = None
        self._sharding = None
        self._fused_hsig = None
        self._fused_pending = None
        self._fused_outputs = None
        self._fused_copies = None
        self._fused_t = 0
        # speculation: (device copy of the state before the early step,
        # that step's outputs), and the optimizer count to roll back to
        self._fused_next = None
        self._fused_prev_num_update = 0
        # superstep counters (profiler.SuperstepStats), made on first use
        self._superstep_stats = None
        self._superstep_runs = 0
        # bucketing: this module's executor arrays are shared by a
        # sibling bound on it, or its optimizer is a sibling's
        self._lent_exec_group = False
        self._borrowed_optimizer = False
        self._monitor_installed = False

    # -- properties -----------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        shapes = dict(self._data_shapes)
        shapes.update(dict(self._label_shapes or []))
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, [tuple(s) for s in out_shapes]))

    # -- params ---------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Initialize the host params (``initializer`` by name, or copies
        of ``arg_params``/``aux_params``) and write them to the device."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        if self._arg_params is None:
            self._arg_params = {
                name: nd_zeros(blk[0].shape, ctx=cpu(), dtype=blk[0].dtype)
                for name, blk in zip(self._param_names,
                                     self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: nd_zeros(blk[0].shape, ctx=cpu(), dtype=blk[0].dtype)
                for name, blk in zip(self._aux_names,
                                     self._exec_group.aux_arrays)}

        def _impl(name, arr, cache):
            if cache is not None:
                if name in cache:
                    if cache[name] is not arr:
                        cache[name].copyto(arr)
                else:
                    if not allow_missing:
                        raise RuntimeError("%s is not presented" % name)
                    if initializer is not None:
                        initializer(name, arr)
            else:
                initializer(name, arr)

        for name, arr in self._arg_params.items():
            _impl(name, arr, arg_params)
        for name, arr in self._aux_params.items():
            _impl(name, arr, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params)
        if self._fused is not None:
            # host params changed: an early step of the old state never
            # commits, and its optimizer count rolls back
            self._discard_speculation()
            self._fused_init_state()

    def _sync_params_from_devices(self):
        if self._fused is not None:
            # a pending speculation has not committed: its copy holds the
            # params of record
            self._fused.read_params(self._arg_params, self._aux_params,
                                    state=self._spec_state())
            self._exec_group.set_params(self._arg_params, self._aux_params)
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    # -- bind -----------------------------------------------------------------
    # -- mesh -----------------------------------------------------------------
    def set_mesh(self, mesh, sharding=None):
        """Train over a mesh (reference module.py:198-248): ``mesh`` is a
        ``parallel.Mesh``, an axes list, the ``"dp=2,tp=2"`` string form,
        or None to clear.  Every rank is fed the global batch and keeps
        its rows of ``dp``.  ``sharding``: ``{param name: PartitionSpec}``
        merged over the graph's ``__sharding__`` attributes; each rank
        holds its shard of those parameters (``"auto"``, the shard search,
        is ROADMAP.md queue 1 item 10c).  Call before ``init_optimizer``
        (fit does); afterwards the whole train state (params, optimizer
        slots, the step count, the random state) is carried onto the new
        layout: gathered whole and cut again."""
        from ..parallel.mesh import Mesh, make_mesh
        if isinstance(sharding, str):
            raise NotImplementedError(
                "sharding=%r: the shard search waits for the compile "
                "cache (ROADMAP.md, queue 1 item 10c, after item 11); pass "
                "a {name: PartitionSpec} map" % (sharding,))
        if mesh is not None and not isinstance(mesh, Mesh):
            mesh = make_mesh(mesh)
        specs = dict(sharding) if sharding else None
        if mesh == self._mesh and specs == self._sharding:
            return
        carried = None
        if self.optimizer_initialized and self._fused is not None and \
                self._fused.state is not None:
            # a re-mesh mid-training keeps the train state: dropping it
            # would zero every optimizer slot and the step count
            from ..checkpoint.module_state import capture_train_state
            carried = capture_train_state(self, gather=True)
        self._mesh = mesh
        self._sharding = specs
        if self.optimizer_initialized:
            self._setup_fused()
            if carried is not None and self._fused is not None:
                from ..checkpoint.module_state import restore_train_state
                restore_train_state(self, *carried)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write", no_slice_names=None, mesh=None,
             sharding=None):
        """``no_slice_names``: input/label names that must not be sliced
        along the batch even when their leading dim equals the batch
        size (Fast R-CNN's rois when num_rois == batch_size); they are
        copied whole.  ``mesh``/``sharding``: see ``set_mesh``."""
        if mesh is not None or sharding is not None:
            self.set_mesh(mesh, sharding)
        if force_rebind:
            self.binded = False
            self._exec_group = None
            self._lent_exec_group = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if no_slice_names:
            # a typo would silently re-enable the slicing the caller
            # asked to prevent: check before any state changes
            known = {n for n, _ in data_shapes}
            known |= {n for n, _ in (label_shapes or [])}
            unknown = sorted(set(no_slice_names) - known)
            if unknown:
                raise MXNetError("no_slice_names %s match no bound data/"
                                 "label input (have: %s)"
                                 % (unknown, sorted(known)))
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        if not for_training:
            assert not inputs_need_grad
        self._data_shapes = [tuple(x) for x in data_shapes]
        self._label_shapes = [tuple(x) for x in label_shapes] \
            if label_shapes else None
        self._grad_req = grad_req
        self._no_slice_names = tuple(no_slice_names or ())
        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            # the parent's executor arrays become the one copy every
            # sibling trains; a fused state of its own would drift from
            # them, and the flag keeps a later init_optimizer off the
            # fused path too
            shared_module._lent_exec_group = True
            shared_module._disable_fused("executor shared with %r"
                                         % getattr(self._symbol, "name", ""))
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            no_slice_names=self._no_slice_names)
        if shared_module is not None:
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)
        if shared_module is not None and shared_module.optimizer_initialized:
            self.borrow_optimizer(shared_module)

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind to new input shapes (a different batch size), keeping
        the trained parameters, the optimizer state, ``grad_req`` and the
        no-slice marks (reference module.py reshape).  The fused step
        keys its captures by batch shape and carries over."""
        assert self.binded
        if self.params_initialized and self._params_dirty:
            # the updated params live only on the device: pull them back
            # before the old executor group goes, or training reverts
            self._sync_params_from_devices()
        self._discard_speculation()
        self._fused_pending = None
        self._fused_outputs = None
        self._fused_copies = None
        self._data_shapes = [tuple(x) for x in data_shapes]
        self._label_shapes = [tuple(x) for x in label_shapes] \
            if label_shapes else None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            self.for_training, self.inputs_need_grad, None,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=self._grad_req, no_slice_names=self._no_slice_names)
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    # -- optimizer ------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """reference module.py:358-409: the kvstore by ``_create_kvstore``
        (none on one device), seeded with the params; then the store
        runs the optimizer, or the updater does."""
        assert self.binded and self.params_initialized
        if optimizer_params is None:
            optimizer_params = (("learning_rate", 0.01),)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        if isinstance(optimizer, str):
            batch_size = self._exec_group.batch_size
            if kvstore and kvstore.type == "dist_sync":
                # each rank feeds its own batch: the mean is over all
                batch_size *= kvstore.num_workers
            idx2name = _param_idx2name(self._param_names, len(self._context),
                                       update_on_kvstore)
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=idx2name,
                                       **optimizer_params)
        elif not isinstance(optimizer, opt_mod.Optimizer):
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        self._setup_fused()

    def _fusable(self):
        """Whether the batch body can run as the fused step with the
        reference's semantics (reference module.py:411-446); anything
        else takes the classic path."""
        if not get_env("MXNET_FUSED_TRAIN", True, bool):
            return False
        if not self.for_training or self.inputs_need_grad:
            return False
        if self._grad_req != "write":
            return False
        # a monitor reads every node's outputs: the classic path's walk
        if self._monitor_installed:
            return False
        # bucketing: the fused state is private, and siblings would train
        # on stale shared arrays or optimizer states
        if self._borrowed_optimizer or self._lent_exec_group:
            return False
        if self._exec_group.shared_group is not None:
            return False
        if self._optimizer.fused_update_fn() is None:
            return False
        kv = self._kvstore
        if kv is not None and "dist" in kv.type and \
                "dist_sync" not in kv.type:
            # dist_async is a host-side service with stale weights: only
            # the synchronous family fuses
            return False
        # ctx_group placement runs node by node across devices
        if any("ctx_group" in a for a in self._symbol.attr_dict().values()):
            return False
        cs = self._context
        if len({(c.device_type, c.device_id) for c in cs}) != len(cs):
            return False
        if len({c.device_type for c in cs}) != 1:
            return False
        return True

    def borrow_optimizer(self, shared_module):
        """Train with ``shared_module``'s optimizer and updater (one set of
        optimizer states for every bucket), on the classic path."""
        assert shared_module.optimizer_initialized
        self._disable_fused("optimizer borrowed")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        self._borrowed_optimizer = True

    def _setup_fused(self):
        if self._fused is not None and self._params_dirty:
            # never drop a live fused state that holds the only copy of
            # the trained params
            self._sync_params_from_devices()
        self._fused_next = None
        self._fused = None
        self._fused_pending = None
        self._fused_outputs = None
        self._fused_copies = None
        mesh = self._mesh
        if mesh is None and (get_env("MXNET_MESH", "") or "").strip():
            from ..parallel.mesh import mesh_from_env
            mesh = mesh_from_env()
        if not self._fusable():
            if mesh is not None:
                # a mesh asked for never degrades to one rank's loop
                raise MXNetError(
                    "Module mesh training needs the fused train step, "
                    "which this configuration disables (monitor / "
                    "grad_req != 'write' / borrowed optimizer / shared "
                    "executors / optimizer without a fused form / "
                    "MXNET_FUSED_TRAIN=0); remove the blocker or drop "
                    "mesh=")
            return
        global_dp = self._kvstore is not None and \
            "dist_sync" in self._kvstore.type
        if mesh is not None and "dp" in mesh.axis_names and not global_dp:
            bs, dp = self._exec_group.batch_size, int(mesh.shape["dp"])
            if bs % dp:
                raise MXNetError(
                    "bound batch size %d is not divisible by the mesh's "
                    "dp axis (%d); pick a batch the devices can slice "
                    "evenly" % (bs, dp))
        self._fused = FusedTrainStep(
            self._symbol, self._context[0], self._data_names,
            self._label_names, self._param_names, self._fixed_param_names,
            self._optimizer, mesh=mesh, global_dp=global_dp,
            sharding=self._sharding if mesh is not None else None)
        self._fused_hsig = self._fused.hparam_signature()
        self._fused_init_state()

    def _fused_init_state(self):
        self._fused_next = None
        self._fused.init_state(self._arg_params, self._aux_params)
        self._fused_t = 0
        self._fused_pending = None
        self._fused_outputs = None
        self._fused_copies = None

    def apply_augment_spec(self, spec):
        """Install a feed pipeline's on-device augmentation spec
        (``feed.AugmentSpec``, carried by ``record_pipeline(device_augment=
        True)`` iterators; None clears it) on the fused train step
        (reference module.py:542-560).  -> False when the fused path is
        not engaged: the classic path binds float32 CHW inputs and cannot
        take the uint8 HWC wire, so the caller must rebuild the pipeline
        host-side."""
        if self._fused is None or not self.optimizer_initialized:
            return False
        self._fused.set_device_augment(spec)
        return True

    def prefetch_to_device(self, data_iter, depth=2, megabatch=1):
        """Wrap ``data_iter`` so each batch's copy to the device is issued
        ``depth`` steps ahead of its use (``feed.device_feed``), onto the
        fused step's device, whose ``make_batch`` then copies it device
        to device.  ``megabatch=K`` stages K-batch megabatches (stacked
        leading axis, the superstep's input) instead, so the next
        megabatch's copy overlaps the current superstep.  Call after
        init_optimizer; fit(prefetch_to_device=True) does this
        (reference module.py:797-810)."""
        from .. import feed as _feed
        return _feed.device_feed(data_iter, module=self, depth=depth,
                                 megabatch=megabatch)

    def _disable_fused(self, reason, replay_backward=True):
        """Leave the fused path mid-training with consistent state: the
        live params back into the host dicts and the executor group, the
        optimizer state to the classic updater, the step count to the
        optimizer's per-index counts, and a pending batch replayed
        through the executor group."""
        if self._fused is None:
            return
        if self._fused.axis is not None and (
                self._fused.axis.size > 1 or self._mesh is not None):
            # the classic path runs one rank's executors: it cannot take
            # over a step summed over the dp axis
            raise MXNetError(
                "cannot leave the fused train step (%s) over the dp axis "
                "of %d rank(s)" % (reason, self._fused.axis.size))
        if self._fused.device_augment is not None:
            # the classic path binds float32 CHW inputs; a uint8 HWC feed
            # has no host fallback: fail with the cause
            raise MXNetError(
                "cannot leave the fused train step (%s): on-device "
                "augmentation is active and the classic path cannot "
                "consume the uint8 feed; rebuild the pipeline with "
                "device_augment=False to use the fallback" % reason)
        fused, pend = self._fused, self._fused_pending
        if self._fused_next is not None:
            # the early step of the pending batch has not committed: its
            # batch replays classically below (the optimizer count it
            # advanced stands, as in the reference)
            fused.restore_state(self._fused_next[0])
            self._fused_next = None
        fused.read_params(self._arg_params, self._aux_params)
        self._exec_group.set_params(self._arg_params, self._aux_params)
        self._params_dirty = False
        if self._update_on_kvstore and self._kvstore is not None:
            # the store still holds the weights from init time
            _initialize_kvstore(kvstore=self._kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=True)
        num_dev = len(self._context)
        if self._fused_t:
            counts = self._optimizer._index_update_count
            for i in range(len(self._param_names) * num_dev):
                counts.setdefault(i, self._fused_t)

        def _to_nd(x, like):
            if x is None:
                return None
            if isinstance(x, (tuple, list)):
                return tuple(_to_nd(e, like) for e in x)
            return NDArray(x.detach().to(like._get().device, copy=True))
        updater = self._updater
        if updater is None and self._kvstore is not None:
            updater = self._kvstore._updater
        for i, n in enumerate(self._param_names):
            if n not in fused.state["opt"]:
                continue
            st = fused.state["opt"][n]
            if self._update_on_kvstore:
                updater.states[i] = _to_nd(st, self._kvstore._store[i])
            else:
                # one copy per device replica, on its device
                for dev in range(num_dev):
                    updater.states[i * num_dev + dev] = _to_nd(
                        st, self._exec_group.param_arrays[i][dev])
        self._fused = None
        self._fused_pending = None
        self._fused_outputs = None
        self._fused_copies = None
        if pend is not None:
            from ..io import DataBatch
            eg = self._exec_group
            batch = DataBatch(data=[NDArray(pend[n]) for n in eg.data_names],
                              label=[NDArray(pend[n])
                                     for n in eg.label_names])
            eg.forward(batch, True)
            if replay_backward:
                eg.backward()
        self.logger.info("fused train step disabled: %s", reason)

    # -- speculation ----------------------------------------------------------
    def _spec_state(self):
        """The state of record while a speculation is pending (its copy
        from before the early step), else None (the live state)."""
        return self._fused_next[0] if self._fused_next is not None else None

    def _discard_speculation(self):
        """Drop an early step that was never committed: put the state
        from before it back and roll the optimizer's step count back
        (reference module.py:765-775).  ``_disable_fused``, whose batch
        still commits classically, keeps the advanced count."""
        if self._fused_next is None:
            return
        self._fused.restore_state(self._fused_next[0])
        self._optimizer.num_update = self._fused_prev_num_update
        self._fused_next = None

    def _fused_commit_early(self):
        """Run the pending batch's step now (reference module.py:777-796):
        the state from before it is copied aside on the step's stream
        first (about 205 MB at ResNet-50 with momentum), the outputs are
        copied out, and ``update()`` only installs them; a new forward
        puts the copy back."""
        self._fused_prev_num_update = self._optimizer.num_update
        self._optimizer.num_update = max(self._optimizer.num_update,
                                         self._fused_t + 1)
        before = self._fused.snapshot_state()
        outs = self._fused.step(self._fused_pending)
        copies = [NDArray(o.clone()) for o in outs]
        self._fused_next = (before, copies)
        self._fused_outputs = outs
        self._fused_copies = copies

    # -- superstep ------------------------------------------------------------
    def _superstep_blockers(self, eval_metric, k, monitor=None,
                            batch_end_callback=None, checkpoint_every=None):
        """Why superstep K must fall back to one step at a time, or None
        (reference module.py:813-838)."""
        if self._fused is None or not self.optimizer_initialized:
            return "fused train step not engaged"
        if monitor is not None or self._monitor_installed:
            return "monitor attached (needs per-step host visibility)"
        if eval_metric is not None and \
                getattr(eval_metric, "device_reducer", lambda: None)() is None:
            return "metric %r has no device form" % getattr(
                eval_metric, "name", eval_metric)
        if checkpoint_every and checkpoint_every % k != 0:
            return ("checkpoint_every=%d is not a multiple of K=%d"
                    % (checkpoint_every, k))
        cbs = batch_end_callback if isinstance(batch_end_callback, list) \
            else ([batch_end_callback] if batch_end_callback else [])
        for cb in cbs:
            if getattr(cb, "inspects_outputs", False):
                return "batch-end callback %r inspects per-step outputs" % cb
        return None

    def superstep_train(self, batches, eval_metric=None, before_drain=None):
        """Advance K training batches (a list of K DataBatch, or a
        pre-staged ``feed.MegaBatch``, K taken from it) as K replays of
        the captured step, the metric reduced on the device and drained
        once (reference module.py:840-946).  ``before_drain`` (no
        arguments) runs once the K steps are queued and before the
        drain waits for them: ``fit`` stages the next megabatch there.  -> True when the
        superstep ran; False when the caller must run these batches one
        at a time (the fused path is gone, or the optimizer values the
        step baked in changed)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        if self._fused is None:
            return False
        if self._fused_pending is not None:
            raise MXNetError(
                "superstep_train with an uncommitted forward pending; "
                "call update() to commit it first")
        if self._fused.hparam_signature() != self._fused_hsig:
            return False
        reducer = eval_metric.device_reducer() if eval_metric is not None \
            else None
        if eval_metric is not None and reducer is None:
            return False
        if self._superstep_stats is None:
            from .. import profiler as _prof
            self._superstep_stats = _prof.SuperstepStats()
            _prof.register_superstep_stats(self._superstep_stats)
        t0 = time.perf_counter()
        k, mega = self._fused.make_megabatch(batches)
        h2d_s = time.perf_counter() - t0
        # the step counters and the scheduler advance before the steps
        # run; they roll back if the dispatch fails
        prev_t = self._fused_t
        prev_num_update = self._optimizer.num_update
        sched = getattr(self._optimizer, "lr_scheduler", None)
        sched_state = sched.state_dict() if sched is not None else None
        try:
            lrs = []
            for _ in range(k):
                self._fused_t += 1
                self._optimizer.num_update = max(
                    self._optimizer.num_update, self._fused_t)
                lrs.append(float(self._optimizer.base_lr()))
            acc0 = reducer.init(self._fused.device) \
                if reducer is not None else None
            self._fused_outputs = None
            self._fused_copies = None
            t1 = time.perf_counter()
            acc = self._fused.superstep(k, mega, lrs, reducer, acc0)
            dispatch_s = time.perf_counter() - t1
        except Exception:
            self._fused_t = prev_t
            self._optimizer.num_update = prev_num_update
            if sched is not None:
                sched.load_state_dict(sched_state)
            raise
        self._params_dirty = True
        self._superstep_runs += 1
        if before_drain is not None:
            before_drain()
        wait_s = 0.0
        if reducer is not None:
            t2 = time.perf_counter()
            host = torch.stack(acc).cpu().tolist()
            metric_mod.note_host_sync()
            wait_s = time.perf_counter() - t2
            reducer.absorb(unflatten_tensors(acc0, host))
        self._superstep_stats.add(k, h2d_s, dispatch_s, wait_s)
        return True

    # -- computation ----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        if self._fused is not None:
            if is_train:
                # deferred: update() runs the whole batch body; an early
                # step of the previous batch never committed
                self._discard_speculation()
                self._fused_pending = self._fused.make_batch(data_batch)
                self._fused_outputs = None
                self._fused_copies = None
                return
            dev = self._fused.device
            batch = {n: a._get().to(dev) for n, a in
                     zip(self._data_names, data_batch.data)}
            batch.update({n: a._get().to(dev) for n, a in
                          zip(self._label_names, data_batch.label or [])})
            missing = [n for n in self._data_names + self._label_names
                       if n not in batch]
            for n in missing:
                shape = dict(self._data_shapes + (self._label_shapes or []))
                batch[n] = nd_zeros(shape[n], ctx=self._context[0])._get()
            self._fused_outputs = self._fused.forward_only(
                batch, False, state=self._spec_state())
            self._fused_copies = None
            return
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        if self._fused is not None and self._fused_pending is not None:
            if out_grads is None:
                return
            self._disable_fused("explicit head gradients",
                                replay_backward=False)
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """reference module.py:977-1033."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._fused is not None and self._fused_pending is not None:
            if self._fused.hparam_signature() != self._fused_hsig:
                self._disable_fused("optimizer hyperparameters changed")
                self._params_dirty = True
            else:
                self._fused_t += 1
                self._optimizer.num_update = max(self._optimizer.num_update,
                                                 self._fused_t)
                if self._fused.axis is not None:
                    from ..dist import boot
                    if boot.world_size() > 1:
                        # the fleet's chaos seam (reference module.py:
                        # 1040-1051): a rank dying mid-step, targeted per
                        # rank (points=dist.host@rank1)
                        from .. import faults
                        faults.point("dist.host",
                                     stage="rank%d" % boot.rank(),
                                     step=self._fused_t)
                if self._fused_next is not None:
                    # the step ran when its outputs were read: install
                    # its outputs (an eval forward since may have
                    # replaced the current ones)
                    self._fused_copies = self._fused_next[1]
                    self._fused_outputs = [c._get()
                                           for c in self._fused_copies]
                    self._fused_next = None
                else:
                    self._fused_outputs = self._fused.step(
                        self._fused_pending)
                    self._fused_copies = None
                self._fused_pending = None
                return
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore)

    def get_outputs(self, merge_multi_context=True):
        """The last forward's outputs.  On the fused path these are copies
        of the step's buffers (a later replay overwrites those); outputs
        asked for between a train forward and update() run the pending
        step early (``_fused_commit_early``), or, when the optimizer
        values the step baked in changed since, a train-mode forward of
        the pending batch that commits nothing."""
        assert self.binded and self.params_initialized
        if self._fused is not None and (self._fused_outputs is not None
                                        or self._fused_pending is not None):
            if self._fused_copies is None:
                if self._fused_outputs is None:
                    if self._fused.hparam_signature() == self._fused_hsig:
                        self._fused_commit_early()
                    else:
                        self._fused_outputs = self._fused.forward_only(
                            self._fused_pending, True)
                if self._fused_copies is None:
                    self._fused_copies = [NDArray(o.clone())
                                          for o in self._fused_outputs]
            if merge_multi_context:
                return list(self._fused_copies)
            return [[o] for o in self._fused_copies]
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        if self._fused is not None and (self._fused_outputs is not None
                                        or self._fused_pending is not None):
            eval_metric.update(self._fused.global_labels(labels),
                               self.get_outputs())
            return
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Install ``mon`` on the executors; the module leaves the fused
        step for the classic path, as the reference does."""
        assert self.binded
        self._monitor_installed = True
        self._disable_fused("monitor installed")
        self._exec_group.install_monitor(mon)
