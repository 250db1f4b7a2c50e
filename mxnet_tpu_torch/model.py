"""The model-level API (counterpart of ``mxnet_tpu/model.py``): the
kvstore helpers the module's update runs through, ``FeedForward`` (v0.7's
estimator: ``fit``, ``predict``, ``score``, ``save``, ``load``,
``create``), the legacy checkpoint pair (``prefix-symbol.json`` plus
``prefix-%04d.params`` with ``arg:``/``aux:`` key prefixes, in the
formats both packages read and write) and ``BatchEndParam``, what the
fit loops hand their batch-end callbacks.

``FeedForward.fit`` trains through ``Module`` (``BucketingModule`` for a
``sym_gen``), so its batch body is ``Module.forward/backward/update`` and
rides the fused train step when the configuration allows.
"""
from __future__ import annotations

import glob
import itertools
import logging
import os
import pickle
import struct
import time
import zipfile
from collections import namedtuple
from typing import Dict, Optional, Tuple

import numpy as np

from .base import MXNetError, local_path, open_stream
from .context import Context, cpu, current_context
from .ndarray import NDArray, load as nd_load, save as nd_save, \
    zeros as nd_zeros
from . import io as mx_io
from . import kvstore as kvstore_mod
from . import metric as metric_mod
from . import optimizer as opt_mod
from .executor_manager import _check_arguments
from .initializer import Uniform
from .symbol import Symbol, load_json as sym_load_json

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

# the auto-select bound of kvstore 'local' (reference model.py:50): the
# largest parameter's element count below which the update runs on the
# host per key, at or above which the devices all-reduce the gradients
LOCAL_UPDATE_CPU_MAX = 1024 * 1024 * 16


def _create_kvstore(kvstore, num_device, arg_params):
    """-> (kvstore or None, update_on_kvstore) (reference
    model.py:37-64): one device and no dist mode take no store; 'local'
    becomes 'local_update_cpu' while the largest parameter has fewer
    than 16M elements, else 'local_allreduce_cpu'."""
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvstore_mod.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            if kvstore == "local":
                max_size = max(int(np.prod(param.shape))
                               for param in arg_params.values())
                kvstore = "local_update_cpu" \
                    if max_size < LOCAL_UPDATE_CPU_MAX \
                    else "local_allreduce_cpu"
                logging.info("Auto-select kvstore type = %s", kvstore)
            kv = kvstore_mod.create(kvstore)
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        return None, False
    return kv, "local_allreduce" not in kv.type


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Seed the store with the initial weights (reference
    model.py:67-73)."""
    for idx, weights_on_devs in enumerate(param_arrays):
        kvstore.init(idx, arg_params[param_names[idx]])
        if update_on_kvstore:
            kvstore.pull(idx, weights_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """The store updates: push the gradients, pull the new weights
    (reference model.py:76-83)."""
    for idx, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads[0] is None:
            continue
        kvstore.push(idx, grads, priority=-idx)
        kvstore.pull(idx, weights, priority=-idx)


def _param_idx2name(param_names, num_device, update_on_kvstore):
    """Updater index -> param name, in ``_update_params``' convention
    ``idx * num_device + dev`` (reference model.py:86-95)."""
    if update_on_kvstore:
        return dict(enumerate(param_names))
    return {i * num_device + k: n
            for i, n in enumerate(param_names)
            for k in range(num_device)}


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Sum the gradients through the store (when there is one), then run
    the updater on every device's copy (reference model.py:98-108)."""
    for idx, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads[0] is None:
            continue
        if kvstore:
            kvstore.push(idx, grads, priority=-idx)
            kvstore.pull(idx, grads, priority=-idx)
        for dev, (w, g) in enumerate(zip(weights, grads)):
            updater(idx * num_device + dev, g, w)


def _as_callbacks(cb):
    if cb is None:
        return []
    return cb if isinstance(cb, list) else [cb]


def _rolling_batches(train_data, logger):
    """Endless batches for ``epoch_size``: an epoch is cut across
    iterator passes, and the iterator resets only when it runs dry."""
    while True:
        produced = False
        for batch in train_data:
            produced = True
            yield batch
        if not produced:
            raise MXNetError("training data iterator produced no batches")
        logger.info("Resetting Data Iterator")
        train_data.reset()


def _train_multi_device(symbol, ctx, arg_params, aux_params, begin_epoch,
                        end_epoch, epoch_size, optimizer, kvstore,
                        train_data, eval_data=None, eval_metric=None,
                        epoch_end_callback=None, batch_end_callback=None,
                        logger=None, work_load_list=None, monitor=None,
                        eval_batch_end_callback=None, sym_gen=None):
    """FeedForward's training loop (reference model.py:130-222) over the
    Module API."""
    logger = logger or logging
    from .module import Module
    from .module.bucketing_module import BucketingModule

    data_names = [d[0] for d in train_data.provide_data]
    label_names = [l[0] for l in train_data.provide_label]
    if sym_gen is not None:
        mod = BucketingModule(
            lambda key: (sym_gen(key), data_names, label_names),
            default_bucket_key=train_data.default_bucket_key,
            context=ctx, work_load_list=work_load_list, logger=logger)
    else:
        mod = Module(symbol, data_names=data_names, label_names=label_names,
                     context=ctx, work_load_list=work_load_list,
                     logger=logger)
    mod.bind(train_data.provide_data, train_data.provide_label,
             for_training=True)
    if monitor is not None:
        mod.install_monitor(monitor)
    mod.init_params(initializer=None, arg_params=arg_params,
                    aux_params=aux_params, allow_missing=False)
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer)

    def pull_params():
        trained_arg, trained_aux = mod.get_params()
        for dst, src in ((arg_params, trained_arg), (aux_params, trained_aux)):
            for k, v in src.items():
                dst[k] = v.copy()

    train_data.reset()
    endless = _rolling_batches(train_data, logger) if epoch_size else None
    for epoch in range(begin_epoch, end_epoch):
        tic = time.perf_counter()
        eval_metric.reset()
        source = (itertools.islice(endless, epoch_size) if epoch_size
                  else train_data)
        nbatch = 0
        for data_batch in source:
            if monitor is not None:
                monitor.tic()
            mod.forward(data_batch, is_train=True)
            mod.backward()
            mod.update()
            if monitor is not None:
                monitor.toc_print()
            mod.update_metric(eval_metric, data_batch.label)
            nbatch += 1
            bep = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals())
            for cb in _as_callbacks(batch_end_callback):
                cb(bep)
        if not epoch_size:
            train_data.reset()
        logger.info("Epoch[%d] Time cost=%.3f", epoch,
                    time.perf_counter() - tic)
        if epoch_end_callback or epoch + 1 == end_epoch:
            pull_params()
        # the stable (default-bucket) symbol, not the last batch's bucket
        for cb in _as_callbacks(epoch_end_callback):
            cb(epoch, symbol, arg_params, aux_params)
        for name, value in eval_metric.get_name_value():
            logger.info("Epoch[%d] Train-%s=%f", epoch, name, value)
        if eval_data:
            eval_metric.reset()
            eval_data.reset()
            for i, eval_batch in enumerate(eval_data):
                mod.forward(eval_batch, is_train=False)
                mod.update_metric(eval_metric, eval_batch.label)
                bep = BatchEndParam(epoch=epoch, nbatch=i,
                                    eval_metric=eval_metric,
                                    locals=locals())
                for cb in _as_callbacks(eval_batch_end_callback):
                    cb(bep)
            for name, value in eval_metric.get_name_value():
                logger.info("Epoch[%d] Validation-%s=%f", epoch, name,
                            value)
            eval_data.reset()
    return mod


def save_checkpoint(prefix: str, epoch: int, symbol: Symbol,
                    arg_params: Dict[str, NDArray],
                    aux_params: Dict[str, NDArray]) -> None:
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``, each
    published atomically."""
    symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd_save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix: str, epoch: int, ctx: Optional[Context] = None
                    ) -> Tuple[Symbol, Dict[str, NDArray], Dict[str, NDArray]]:
    """-> (symbol, arg_params, aux_params), the arrays on ``ctx`` (default:
    the current context).  A missing file is named with the param files
    that do exist for the prefix; an unreadable one is reported corrupt
    (reference model.py load_checkpoint)."""
    sym_file = "%s-symbol.json" % prefix
    param_file = "%s-%04d.params" % (prefix, epoch)
    for fname, kind in ((sym_file, "symbol"), (param_file, "params")):
        if not os.path.exists(local_path(fname)):
            have = sorted(glob.glob("%s-*.params" % prefix))
            raise MXNetError(
                "checkpoint %s file missing: %r (existing param files for "
                "this prefix: %s)" % (kind, fname, have or "none"))
    try:
        with open_stream(sym_file) as f:
            symbol = sym_load_json(f.read())
    except (ValueError, KeyError, MXNetError) as e:
        raise MXNetError(
            "checkpoint symbol file corrupt: %r (%s: %s)"
            % (sym_file, type(e).__name__, e)) from e
    try:
        saved = nd_load(param_file, ctx=ctx)
    except (ValueError, EOFError, struct.error, pickle.UnpicklingError,
            zipfile.BadZipFile, MXNetError) as e:
        raise MXNetError(
            "checkpoint params file corrupt: %r (%s: %s) - a torn write?"
            % (param_file, type(e).__name__, e)) from e
    arg_params: Dict[str, NDArray] = {}
    aux_params: Dict[str, NDArray] = {}
    for k, v in saved.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The model estimator (reference model.py:302-576).  ``ctx``
    defaults to the current context (``gpu(0)``); the params it hands
    out are host arrays."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        if isinstance(symbol, Symbol):
            self.symbol = symbol
            self.sym_gen = None
        else:
            assert callable(symbol)
            self.symbol = None
            self.sym_gen = symbol
        if self.symbol is not None:
            _check_arguments(self.symbol)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.argument_checked = self.symbol is not None
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self._pred_exec = None
        self._module = None
        self.begin_epoch = begin_epoch

    def _check_arguments(self):
        if self.argument_checked:
            return
        assert self.symbol is not None
        self.argument_checked = True
        _check_arguments(self.symbol)

    def _init_params(self, input_shapes, overwrite=False):
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise ValueError("Incomplete input shapes")
        arg_names = self.symbol.list_arguments()
        param_names = [key for key in arg_names if key not in input_shapes]
        aux_names = self.symbol.list_auxiliary_states()
        param_name_shapes = [x for x in zip(arg_names, arg_shapes)
                             if x[0] in param_names]
        arg_params = {k: nd_zeros(sh, ctx=cpu()) for k, sh in
                      param_name_shapes}
        aux_params = {k: nd_zeros(sh, ctx=cpu()) for k, sh in
                      zip(aux_names, aux_shapes)}
        for k, v in arg_params.items():
            if self.arg_params and k in self.arg_params and not overwrite:
                v[:] = self.arg_params[k]
            else:
                self.initializer(k, v)
        for k, v in aux_params.items():
            if self.aux_params and k in self.aux_params and not overwrite:
                v[:] = self.aux_params[k]
            else:
                self.initializer(k, v)
        self.arg_params = arg_params
        self.aux_params = aux_params
        return arg_names, list(param_names), aux_names

    def __getstate__(self):
        this = self.__dict__.copy()
        this["_pred_exec"] = None
        this["_module"] = None
        return this

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _init_predictor(self, input_shapes):
        if self._pred_exec is not None:
            arg_shapes, _, _ = self.symbol.infer_shape(**dict(input_shapes))
            assert arg_shapes is not None, "Incomplete input shapes"
            if [tuple(s) for s in arg_shapes] == \
                    [x.shape for x in self._pred_exec.arg_arrays]:
                return
        pred_exec = self.symbol.simple_bind(self.ctx[0], grad_req="null",
                                            **dict(input_shapes))
        pred_exec.copy_params_from(self.arg_params, self.aux_params)
        self._pred_exec = pred_exec

    def _init_iter(self, X, y, is_train):
        if isinstance(X, (np.ndarray, NDArray)):
            if y is None:
                if is_train:
                    raise ValueError("y must be specified when X is "
                                     "numpy.ndarray")
                y = np.zeros(X.shape[0])
            if not isinstance(y, (np.ndarray, NDArray)):
                raise TypeError("y must be ndarray when X is numpy.ndarray")
            if X.shape[0] != y.shape[0]:
                raise ValueError("The numbers of data points and labels not "
                                 "equal")
            if y.ndim == 2 and y.shape[1] == 1:
                y = y.flatten()
            if y.ndim != 1:
                raise ValueError("Label must be 1D or 2D (with 2nd dimension "
                                 "being 1)")
            if is_train:
                return mx_io.NDArrayIter(
                    X, y, min(X.shape[0] // 2, self.numpy_batch_size),
                    shuffle=is_train, last_batch_handle="roll_over")
            return mx_io.NDArrayIter(X, y, self.numpy_batch_size,
                                     shuffle=False)
        if not isinstance(X, mx_io.DataIter):
            raise TypeError("X must be DataIter, NDArray or numpy.ndarray")
        return X

    def _init_eval_iter(self, eval_data):
        if eval_data is None:
            return eval_data
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            if eval_data[0] is not None:
                if eval_data[1] is None and \
                        isinstance(eval_data[0], mx_io.DataIter):
                    return eval_data[0]
                input_data = (np.array(eval_data[0])
                              if isinstance(eval_data[0], list)
                              else eval_data[0])
                input_label = (np.array(eval_data[1])
                               if isinstance(eval_data[1], list)
                               else eval_data[1])
                return self._init_iter(input_data, input_label,
                                       is_train=True)
            raise ValueError("Eval data is NONE")
        if not isinstance(eval_data, mx_io.DataIter):
            raise TypeError("Eval data must be DataIter, or NDArray/"
                            "numpy.ndarray pair")
        return eval_data

    def _feed_batch(self, batch):
        for src, (name, _) in zip(batch.data, self._pred_exec_data_shapes):
            src.copyto(self._pred_exec.arg_dict[name])
        self._pred_exec.forward(is_train=False)

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy arrays, the pad rows of the
        last batch cut (reference model.py predict)."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        self._init_predictor(X.provide_data)
        self._pred_exec_data_shapes = X.provide_data
        n_outputs = len(self.symbol.list_outputs())
        out_chunks = [[] for _ in range(n_outputs)]
        data_chunks = [[] for _ in X.provide_data]
        label_chunks = [[] for _ in X.provide_label]
        for nbatch, batch in enumerate(X):
            if num_batch is not None and nbatch == num_batch:
                break
            self._feed_batch(batch)
            keep = X.batch_size - batch.pad
            for chunk, out in zip(out_chunks, self._pred_exec.outputs):
                chunk.append(out[:keep].asnumpy())
            if return_data:
                for chunk, arr in zip(data_chunks, batch.data):
                    chunk.append(arr[:keep].asnumpy())
                for chunk, arr in zip(label_chunks, batch.label):
                    chunk.append(arr[:keep].asnumpy())

        def merge(chunks):
            whole = [np.concatenate(c) for c in chunks]
            return whole[0] if len(whole) == 1 else whole

        if return_data:
            return (merge(out_chunks), merge(data_chunks),
                    merge(label_chunks))
        return merge(out_chunks)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The metric's value over ``X`` (reference model.py score)."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        self._init_predictor(X.provide_data)
        self._pred_exec_data_shapes = X.provide_data
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        for nbatch, batch in enumerate(X):
            self._feed_batch(batch)
            eval_metric.update(batch.label, self._pred_exec.outputs)
            bep = BatchEndParam(epoch=0, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals())
            for cb in _as_callbacks(batch_end_callback):
                cb(bep)
            if num_batch is not None and nbatch == num_batch:
                break
        return eval_metric.get()[1]

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_batch_end_callback=None):
        """Train (reference model.py fit): the numpy ``X``/``y`` path
        batches through ``NDArrayIter`` with ``roll_over``."""
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)
        if self.sym_gen:
            self.symbol = self.sym_gen(data.default_bucket_key)
            self._check_arguments()
        self.kwargs["sym"] = self.symbol
        input_shapes = dict(data.provide_data + data.provide_label)
        _, param_names, _ = self._init_params(input_shapes)
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self.ctx), self.arg_params)
        if isinstance(self.optimizer, str):
            batch_size = data.batch_size
            if kvstore and kvstore.type == "dist_sync":
                batch_size *= kvstore.num_workers
            self.kwargs["param_idx2name"] = _param_idx2name(
                param_names, len(self.ctx), update_on_kvstore)
            optimizer = opt_mod.create(self.optimizer,
                                       rescale_grad=(1.0 / batch_size),
                                       **self.kwargs)
        elif isinstance(self.optimizer, opt_mod.Optimizer):
            optimizer = self.optimizer
        else:
            raise MXNetError("optimizer must be a name or an Optimizer")
        self._pred_exec = None
        # the training module, kept for inspection (its fused step's
        # counts); predict and score bind their own executor
        self._module = _train_multi_device(
            self.symbol, self.ctx, self.arg_params, self.aux_params,
            begin_epoch=self.begin_epoch, end_epoch=self.num_epoch,
            epoch_size=self.epoch_size, optimizer=optimizer,
            kvstore=kvstore, train_data=data, eval_data=eval_data,
            eval_metric=eval_metric, epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, logger=logger,
            work_load_list=work_load_list, monitor=monitor,
            eval_batch_end_callback=eval_batch_end_callback,
            sym_gen=self.sym_gen)

    def save(self, prefix, epoch=None):
        """Write the checkpoint pair (reference model.py save)."""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from a checkpoint pair, its params on the host."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=cpu())
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_batch_end_callback=None, **kwargs):
        """Construct and fit in one call (reference model.py:691)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
