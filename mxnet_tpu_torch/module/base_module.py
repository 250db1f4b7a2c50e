"""BaseModule: the abstract intermediate-level interface and the fit loop
(counterpart of ``mxnet_tpu/module/base_module.py``).

``fit`` keeps the reference's signature and its per-batch order
(the monitor's tic, forward_backward, update, update_metric, the
monitor's toc, the batch-end callbacks), then the epoch-end callbacks
and the validation score.  The reference's superstep, device prefetch,
checkpoint manager, mesh, autotune and work-load-list arguments wait for
their slices (ROADMAP.md, queue 1 items 2, 7, 9, 10, 11) and raise when
given.
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError
from .. import metric as metric_mod
from ..model import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]

_NOT_PORTED = {
    "prefetch_to_device": "queue 1 item 9", "checkpoint": "queue 1 item 7",
    "checkpoint_every": "queue 1 item 7", "resume": "queue 1 item 7",
    "superstep": "queue 1 item 2", "mesh": "queue 1 item 10",
    "sharding": "queue 1 item 10", "autotune": "queue 1 item 11",
    "work_load_list": "queue 1 item 2"}


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
        """Train (reference base_module.py:273-393): bind, init_params,
        init_optimizer, then per epoch every batch's forward_backward,
        update and update_metric with the batch-end callbacks, the
        epoch-end callbacks with the current params, and the validation
        score on ``eval_data``."""
        given = {"prefetch_to_device": prefetch_to_device,
                 "checkpoint": checkpoint,
                 "checkpoint_every": checkpoint_every, "resume": resume,
                 "superstep": None if superstep in (None, 1) else superstep,
                 "mesh": mesh, "sharding": sharding, "autotune": autotune,
                 "work_load_list": work_load_list}
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
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.perf_counter()
            eval_metric.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                loc = dict(locals())
                loc.setdefault("self", self)
                _fire_callbacks(batch_end_callback,
                                BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric,
                                              locals=loc))
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
        that both packages read.  The optimizer state waits for the
        checkpoint subsystem (ROADMAP.md, queue 1 item 7): with an
        initialized optimizer, ``save_optimizer_states=True`` raises
        rather than drop it."""
        if save_optimizer_states and self.optimizer_initialized:
            raise NotImplementedError(
                "save_checkpoint(save_optimizer_states=True) waits for the "
                "checkpoint subsystem (ROADMAP.md, queue 1 item 7); pass "
                "save_optimizer_states=False to write the params pair")
        from ..model import save_checkpoint as legacy_save
        arg_params, aux_params = self.get_params()
        legacy_save(prefix, epoch, self.symbol, arg_params, aux_params)

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
