"""Data-parallel executor manager (counterpart of
``mxnet_tpu/executor_manager.py``): the batch split by work load, the
argument checks, one executor per device over its slice of the batch,
and the manager that v0.7's ``FeedForward`` trained through.  Distinct
``cpu(i)`` contexts stand for several devices on one host, as in the
reference's tests."""
from __future__ import annotations

import logging
from typing import Dict, Sequence

from .context import Context, cpu
from .ndarray import NDArray
from .symbol import Symbol

__all__ = ["DataParallelExecutorManager", "DataParallelExecutorGroup",
           "_split_input_slice", "_check_arguments", "_load_data",
           "_load_label"]


def _split_input_slice(batch_size: int, work_load_list: Sequence[float]):
    """Split a batch into per-device slices (reference
    executor_manager.py:27)."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(batch_size * (float(work_load) / total_work_load))
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices such that some splits are "
                             "empty")
        slices.append(slice(begin, end))
    return slices


def _check_arguments(symbol: Symbol):
    """Reject duplicated argument or aux names (reference
    executor_manager.py:48)."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise ValueError("Find duplicated argument name, argument names: %s"
                         % str(arg_names))
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise ValueError("Find duplicated auxiliary param name, names: %s"
                         % str(aux_names))


def _load_general(data, targets):
    for d_src, d_targets in zip(data, targets):
        if isinstance(d_targets, NDArray):
            d_src.copyto(d_targets)
        else:
            for slice_idx, d_dst in d_targets:
                d_src[slice_idx.start:slice_idx.stop].copyto(d_dst)


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


def _bind_exec(sym: Symbol, ctx: Context, input_shapes: Dict[str, tuple],
               param_names: Sequence[str], need_grad=False, base_exec=None,
               input_types=None):
    """Bind one executor: gradients for the params only (reference
    executor_manager.py:94-178)."""
    grad_req = {name: "write" if need_grad and name in param_names
                else "null" for name in sym.list_arguments()}
    return sym.simple_bind(ctx, grad_req=grad_req, type_dict=input_types,
                           shared_exec=base_exec, **input_shapes)


class DataParallelExecutorGroup:
    """One executor per device over its batch slice (reference
    executor_manager.py ExecutorGroup)."""

    def __init__(self, sym: Symbol, arg_names, param_names, ctx, slices,
                 train_data, shared_group=None):
        _check_arguments(sym)
        self.arg_names = arg_names
        data_shapes = dict(train_data.provide_data
                           + train_data.provide_label)
        self.data_names = [x[0] for x in train_data.provide_data]
        self.label_names = [x[0] for x in train_data.provide_label]
        self.train_execs = []
        for i, ctxi in enumerate(ctx):
            n = slices[i].stop - slices[i].start
            shapes = {k: (n,) + tuple(v[1:]) for k, v in data_shapes.items()}
            base = shared_group.train_execs[i] if shared_group else None
            self.train_execs.append(_bind_exec(sym, ctxi, shapes, param_names,
                                               need_grad=True, base_exec=base))
        self.data_arrays = [[(slices[i], e.arg_dict[name])
                             for i, e in enumerate(self.train_execs)]
                            for name in self.data_names]
        self.label_arrays = [[(slices[i], e.arg_dict[name])
                              for i, e in enumerate(self.train_execs)]
                             for name in self.label_names]
        self.param_idx = [i for i in range(len(arg_names))
                          if arg_names[i] in param_names]
        self.param_names = [arg_names[i] for i in self.param_idx]
        self.param_arrays = [[e.arg_arrays[i] for e in self.train_execs]
                             for i in self.param_idx]
        self.grad_arrays = [[e.grad_arrays[i] for e in self.train_execs]
                            for i in self.param_idx]
        self.aux_arrays = [[e.aux_arrays[i] for e in self.train_execs]
                           for i in range(len(sym.list_auxiliary_states()))]
        self.slices = slices

    def load_data_batch(self, data_batch):
        _load_data(data_batch, self.data_arrays)
        _load_label(data_batch, self.label_arrays)

    def forward(self, is_train=False):
        for texec in self.train_execs:
            texec.forward(is_train=is_train)

    def backward(self):
        for texec in self.train_execs:
            texec.backward()

    def update_metric(self, metric, labels):
        for texec, islice in zip(self.train_execs, self.slices):
            metric.update([label[islice.start:islice.stop]
                           for label in labels], texec.outputs)


def _average_into(dst: Dict[str, NDArray], names, blocks):
    for name, block in zip(names, blocks):
        weight = sum(w.copyto(cpu())._get() for w in block) / len(block)
        dst[name][:] = weight.to(dst[name]._get().dtype)


class DataParallelExecutorManager:
    """Multi-device training helper (reference executor_manager.py:
    264-406): the executor group of the current bucket, and the
    device-averaged params."""

    def __init__(self, symbol, ctx, train_data, param_names, arg_names,
                 aux_names, work_load_list=None, logger=None, sym_gen=None):
        logger = logger or logging
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        assert isinstance(work_load_list, list) and \
            len(work_load_list) == num_device
        self.slices = _split_input_slice(train_data.batch_size,
                                         work_load_list)
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.curr_execgrp = None
        self.execgrp = DataParallelExecutorGroup(
            symbol, self.arg_names, self.param_names, self.ctx, self.slices,
            train_data)
        self.execgrp_bucket = {train_data.default_bucket_key: self.execgrp} \
            if sym_gen is not None else {}

    def install_monitor(self, monitor):
        if self.sym_gen is not None:
            raise NotImplementedError("Monitoring is not implemented for "
                                      "bucketing")
        for train_exec in self.execgrp.train_execs:
            monitor.install(train_exec)

    def set_params(self, arg_params, aux_params):
        for texec in self.execgrp.train_execs:
            texec.copy_params_from(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """Copy the params, averaged over the devices, into the dicts."""
        _average_into(arg_params, self.param_names, self.param_arrays)
        _average_into(aux_params, self.aux_names, self.aux_arrays)

    @property
    def param_arrays(self):
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        if self.sym_gen is not None:
            key = data_batch.bucket_key
            if key not in self.execgrp_bucket:
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    self.sym_gen(key), self.arg_names, self.param_names,
                    self.ctx, self.slices, data_batch,
                    shared_group=self.execgrp)
            self.curr_execgrp = self.execgrp_bucket[key]
        else:
            self.curr_execgrp = self.execgrp
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)
