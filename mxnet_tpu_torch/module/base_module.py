"""BaseModule: the abstract intermediate-level interface and the fit loop
(counterpart of ``mxnet_tpu/module/base_module.py``).

``fit`` keeps the reference's signature and its per-batch order (the
monitor's tic, forward_backward, update, update_metric, the monitor's
toc, the batch-end callbacks), then the epoch-end callbacks and the
validation score.  ``superstep=K`` (or ``MXNET_SUPERSTEP``) trains K
batches per ``superstep_train``, falling back to K=1 with the
reference's logged reasons; ``checkpoint=``/``checkpoint_every=``/
``resume=`` save the full train state through ``mx.checkpoint`` and
resume from the newest committed step by skipping the batches already
trained.  The device prefetcher, the mesh and autotune wait for their
slices (ROADMAP.md, queue 1 items 9, 10, 11) and raise when given.
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError, get_env
from .. import metric as metric_mod
from ..model import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]

_NOT_PORTED = {
    "prefetch_to_device": "queue 1 item 9", "mesh": "queue 1 item 10",
    "sharding": "queue 1 item 10", "autotune": "queue 1 item 11"}


def _fire_callbacks(callbacks, param):
    """Invoke a single callback or a list of them."""
    if callbacks is None:
        return
    for cb in (callbacks if isinstance(callbacks, list) else [callbacks]):
        cb(param)


class BaseModule:
    """Abstract module (reference base_module.py:41)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high level ---------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Evaluate ``eval_metric`` over ``eval_data``; -> [(name, value)]."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            loc = dict(locals())
            _fire_callbacks(batch_end_callback,
                            BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=loc))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad] for out in
                       self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Outputs over ``eval_data``, the pad rows of the last batch cut
        (reference base_module.py predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].copy()
                                for out in self.get_outputs()])
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, \
                    "Cannot merge batches, as num of outputs is not the " \
                    "same in mini-batches. Maybe bucketing is used?"
            from ..ndarray import concatenate
            merged = [concatenate([out[i] for out in output_list])
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd", optimizer_params=None,
            eval_batch_end_callback=None, initializer=Uniform(0.01),
            arg_params=None, aux_params=None, allow_missing=False,
            force_rebind=False, force_init=False, begin_epoch=0,
            num_epoch=None, validation_metric=None, monitor=None,
            work_load_list=None, prefetch_to_device=False,
            checkpoint=None, checkpoint_every=None, resume=False,
            superstep=None, mesh=None, sharding=None, autotune=None):
        """Train (reference base_module.py:206-655): bind, init_params,
        init_optimizer, then per epoch every batch's forward_backward,
        update and update_metric with the batch-end callbacks (or K
        batches per superstep, the callbacks once per K with ``nbatch``
        at the K-th), the epoch-end callbacks with the current params,
        and the validation score on ``eval_data``.

        ``checkpoint``: a ``mx.checkpoint.CheckpointManager`` or a
        directory; saves every ``checkpoint_every`` batches and at every
        epoch end.  ``resume=True`` restores the newest committed step
        and skips the batches it had trained.  A SIGTERM caught by the
        manager's ``install_preemption_handler`` snapshots at the next
        batch boundary and returns.  ``work_load_list`` is the
        constructor's (the reference's fit ignores it too)."""
        given = {"prefetch_to_device": prefetch_to_device, "mesh": mesh,
                 "sharding": sharding, "autotune": autotune}
        for name, value in given.items():
            if value not in (None, False):
                raise NotImplementedError(
                    "fit(%s=...) is not in the port yet (ROADMAP.md, %s)"
                    % (name, _NOT_PORTED[name]))
        assert num_epoch is not None, "please specify number of epochs"
        if optimizer_params is None:
            optimizer_params = (("learning_rate", 0.01),)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if checkpoint is None and resume:
            raise MXNetError(
                "fit(resume=True) needs checkpoint=<manager or directory>; "
                "without a store to restore from, training would silently "
                "restart from scratch")
        ckpt_mgr = None
        if checkpoint is not None:
            from ..checkpoint import CheckpointManager
            ckpt_mgr = checkpoint \
                if isinstance(checkpoint, CheckpointManager) \
                else CheckpointManager(str(checkpoint))
            if checkpoint_every is not None:
                ckpt_mgr.save_every_steps = int(checkpoint_every)
            # a preemption handled by an earlier fit does not stop this one
            ckpt_mgr.preempted = False
        # a manager made here from a path is fit's to close
        owns_mgr = ckpt_mgr is not None and \
            not isinstance(checkpoint, type(ckpt_mgr))
        try:
            self._fit_loop(train_data, eval_data, eval_metric,
                           epoch_end_callback, batch_end_callback,
                           eval_batch_end_callback, begin_epoch, num_epoch,
                           validation_metric, monitor, ckpt_mgr, resume,
                           superstep)
        finally:
            if owns_mgr:
                ckpt_mgr.close()

    def _fit_loop(self, train_data, eval_data, eval_metric,
                  epoch_end_callback, batch_end_callback,
                  eval_batch_end_callback, begin_epoch, num_epoch,
                  validation_metric, monitor, ckpt_mgr, resume, superstep):
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        k_env = get_env("MXNET_SUPERSTEP", None, int)
        k_super = max(1, int(superstep) if superstep is not None
                      else (k_env if k_env is not None else 1))
        use_super = k_super > 1 and callable(
            getattr(self, "superstep_train", None))
        if k_super > 1 and not use_super:
            self.logger.info("superstep disabled (K=%d -> 1): module has "
                             "no superstep support", k_super)
        if use_super:
            blocker = self._superstep_blockers(
                eval_metric, k_super, monitor=monitor,
                batch_end_callback=batch_end_callback,
                checkpoint_every=(ckpt_mgr.save_every_steps
                                  if ckpt_mgr is not None else None))
            if blocker is not None:
                self.logger.info("superstep disabled (K=%d -> 1): %s",
                                 k_super, blocker)
                use_super = False

        global_step = 0
        start_epoch, start_batch = begin_epoch, 0
        if ckpt_mgr is not None and resume:
            from ..checkpoint import restore_module
            meta = restore_module(ckpt_mgr, self)
            if meta is not None:
                global_step = int(meta.get("global_step", 0))
                start_epoch = int(meta.get("epoch", begin_epoch))
                start_batch = int(meta.get("nbatch", 0))
                # no feed cursor in the port's iterators: skip the
                # batches the checkpoint had trained
                skipped = 0
                while skipped < start_batch:
                    try:
                        train_data.next()
                    except StopIteration:
                        break
                    skipped += 1
                self.logger.info(
                    "resumed from checkpoint step %d: epoch %d, batch %d",
                    global_step, start_epoch, start_batch)
        last_saved_step = [-1]

        def ckpt_save(epoch_, nbatch_, blocking=False):
            from ..checkpoint import save_module
            save_module(ckpt_mgr, self, global_step,
                        meta={"global_step": global_step, "epoch": epoch_,
                              "nbatch": nbatch_}, blocking=blocking)
            last_saved_step[0] = global_step

        for epoch in range(start_epoch, num_epoch):
            tic = time.perf_counter()
            eval_metric.reset()
            nbatch = start_batch if epoch == start_epoch else 0
            preempted = False

            def fire_batch_end(nb, loc=None):
                loc = dict(loc or {})
                loc.setdefault("self", self)
                loc.setdefault("epoch", epoch)
                loc.setdefault("nbatch", nb)
                loc.setdefault("eval_metric", eval_metric)
                _fire_callbacks(batch_end_callback,
                                BatchEndParam(epoch=epoch, nbatch=nb,
                                              eval_metric=eval_metric,
                                              locals=loc))

            def advance(count, allow_ckpt=True, ckpt_from=None):
                """Counters and the save cadence after ``count`` trained
                batches; True means leave fit (preemption)."""
                nonlocal nbatch, global_step, preempted
                prev_step = global_step if ckpt_from is None else ckpt_from
                nbatch += count
                global_step += count
                if not allow_ckpt or ckpt_mgr is None:
                    return False
                if ckpt_mgr.preempted:
                    # SIGTERM: snapshot at this batch boundary and leave
                    ckpt_save(epoch, nbatch, blocking=True)
                    ckpt_mgr.wait()
                    self.logger.info(
                        "preempted: checkpoint committed at step %d "
                        "(epoch %d, batch %d); exiting fit",
                        global_step, epoch, nbatch)
                    preempted = True
                    return True
                # save when (prev_step, global_step] crosses a multiple of
                # save_every, so a K-step jump keeps the cadence
                every = ckpt_mgr.save_every_steps
                if every and global_step // every > prev_step // every:
                    ckpt_save(epoch, nbatch)
                return False

            def train_one(data_batch, allow_ckpt=True, ckpt_from=None):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                fire_batch_end(nbatch, {"data_batch": data_batch})
                return advance(1, allow_ckpt=allow_ckpt,
                               ckpt_from=ckpt_from)

            if use_super:
                data_iter = iter(train_data)
                while not preempted:
                    group = []
                    while len(group) < k_super:
                        try:
                            group.append(next(data_iter))
                        except StopIteration:
                            break
                    if not group:
                        break
                    if len(group) == k_super and \
                            self.superstep_train(group, eval_metric):
                        fire_batch_end(nbatch + k_super - 1,
                                       {"group": group})
                        if advance(k_super):
                            return
                        continue
                    # a partial tail, or a superstep refused: one batch
                    # at a time, saves deferred to the group's end
                    start_step = global_step
                    for i, b in enumerate(group):
                        last = i == len(group) - 1
                        if train_one(b, allow_ckpt=last,
                                     ckpt_from=start_step if last else None):
                            return
            else:
                for data_batch in train_data:
                    if train_one(data_batch):
                        return
            if preempted:
                return
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.perf_counter() - tic)
            if epoch_end_callback is not None:
                arg_params_, aux_params_ = self.get_params()
                for callback in (epoch_end_callback
                                 if isinstance(epoch_end_callback, list)
                                 else [epoch_end_callback]):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
            if ckpt_mgr is not None and last_saved_step[0] != global_step:
                # the epoch boundary: the cursor points at the next
                # epoch's start (skipped when this step just saved)
                ckpt_save(epoch + 1, 0)
        if ckpt_mgr is not None:
            ckpt_mgr.wait()

    # -- symbol -------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    # -- abstract interface --------------------------------------------------
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """Save the params as one NDArray file with ``arg:``/``aux:``
        keys."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        from ..ndarray import save as nd_save
        nd_save(fname, save_dict)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=True):
        """Write the ``prefix-symbol.json`` + ``prefix-%04d.params`` pair
        that both packages read and, with ``save_optimizer_states`` and
        an initialized optimizer, the full train state (optimizer slots,
        schedule position) as committed step ``epoch`` under
        ``prefix-ckpt/`` (reference base_module.py:707-727)."""
        from ..model import save_checkpoint as legacy_save
        arg_params, aux_params = self.get_params()
        legacy_save(prefix, epoch, self.symbol, arg_params, aux_params)
        if save_optimizer_states and self.optimizer_initialized:
            from ..checkpoint import CheckpointManager, save_module
            with CheckpointManager(prefix + "-ckpt", keep_last_n=None,
                                   async_save=False) as mgr:
                save_module(mgr, self, epoch,
                            meta={"epoch": epoch, "nbatch": 0},
                            blocking=True)

    def load_params(self, fname):
        from ..context import cpu
        from ..ndarray import load as nd_load
        save_dict = nd_load(fname, ctx=cpu())
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise MXNetError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()
