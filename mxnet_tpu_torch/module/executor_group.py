"""The executor group of the Module API, on one context (counterpart of
``mxnet_tpu/module/executor_group.py``): binds the symbol with the batch
shapes, loads each batch into the bound arrays, and exposes the
parameter, gradient and aux arrays in the reference's per-device list
layout (one device per list here).  The batch-slicing helpers are copies
of ``mxnet_tpu/executor_manager.py``'s."""
from __future__ import annotations

import logging
from typing import List, Sequence

from ..base import MXNetError
from ..context import Context
from ..symbol import Symbol

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size: int, work_load_list: Sequence[float]):
    """Split a batch into per-device slices (reference
    executor_manager.py:13)."""
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


def _load_general(data, targets):
    for d_src, d_targets in zip(data, targets):
        for slice_idx, d_dst in d_targets:
            d_src[slice_idx.start:slice_idx.stop].copyto(d_dst)


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


class DataParallelExecutorGroup:
    """One executor for one symbol on one context (reference
    executor_group.py:15, with a single device)."""

    def __init__(self, symbol: Symbol, contexts: Sequence[Context],
                 workload, data_shapes, label_shapes, param_names,
                 for_training, inputs_need_grad, shared_group=None,
                 input_types=None, logger=logging, fixed_param_names=None,
                 grad_req="write", no_slice_names=None):
        self.no_slice = frozenset(no_slice_names or ())
        self.batch_size = data_shapes[0][1][0]
        if len(contexts) > 1 and any(
                not self._batch_major(name, s)
                for name, s in list(data_shapes) + list(label_shapes or [])):
            raise MXNetError(
                "inputs whose leading dim is not the batch size (or that "
                "bind() marked no-slice) cannot be split across devices "
                "(they are replicated whole); bind on a single context or "
                "restructure the input")
        if len(contexts) != 1:
            raise NotImplementedError(
                "the port's Module runs on one context; several devices "
                "wait for kvstore's local modes (ROADMAP.md, queue 1 "
                "item 2)")
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload if workload else [1] * len(contexts)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.input_types = input_types
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        self.shared_group = shared_group
        self.grad_req = grad_req
        self.execs: List = []
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def _batch_major(self, name, shape) -> bool:
        """Whether input ``name`` is sliced along the batch: its leading
        dim is the batch size and bind() did not mark it no-slice."""
        return (name not in self.no_slice and len(shape) >= 1
                and shape[0] == self.batch_size)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        self.batch_size = data_shapes[0][1][0]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.data_names = [x[0] for x in data_shapes]
        self.label_names = [x[0] for x in label_shapes] \
            if label_shapes else []
        grad_req = {}
        for name in self.arg_names:
            if self.for_training and name in self.param_names \
                    and name not in self.fixed_param_names:
                grad_req[name] = self.grad_req
            elif self.for_training and self.inputs_need_grad \
                    and name in self.data_names:
                grad_req[name] = self.grad_req
            else:
                grad_req[name] = "null"
        shapes = dict(data_shapes + (label_shapes or []))
        shared_exec = shared_group.execs[0] if shared_group else None
        self.execs = [self.symbol.simple_bind(
            self.contexts[0], grad_req=grad_req, type_dict=self.input_types,
            shared_exec=shared_exec, **shapes)]
        exe = self.execs[0]

        def target(name):
            # an input whose leading dim is not the batch size (Fast
            # R-CNN's rois and roi-level labels), or that bind() marked
            # no-slice, is copied whole, as the reference's executor
            # group copies it
            shape = shapes[name]
            if self._batch_major(name, shape):
                return [(self.slices[0], exe.arg_dict[name])]
            return [(slice(0, shape[0] if shape else 1), exe.arg_dict[name])]
        self.data_arrays = [target(name) for name in self.data_names]
        self.label_arrays = [target(name) for name in self.label_names]
        self.param_arrays = [[exe.arg_dict[name]]
                             for name in self.param_names]
        self.grad_arrays = [[exe.grad_dict.get(name)]
                            for name in self.param_names] \
            if self.for_training else []
        self.input_grad_arrays = [[exe.grad_dict.get(name)]
                                  for name in self.data_names] \
            if self.inputs_need_grad else []
        self.aux_arrays = [[exe.aux_dict[name]] for name in self.aux_names]

    def set_params(self, arg_params, aux_params):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters into the given dicts' arrays."""
        for name, block in zip(self.param_names, self.param_arrays):
            block[0].copyto(arg_params[name])
        for name, block in zip(self.aux_names, self.aux_arrays):
            block[0].copyto(aux_params[name])

    def forward(self, data_batch, is_train=None):
        _load_data(data_batch, self.data_arrays)
        if is_train is None:
            is_train = self.for_training
        if self.label_arrays and data_batch.label:
            _load_label(data_batch, self.label_arrays)
        for exe in self.execs:
            exe.forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        for exe in self.execs:
            exe.backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [x[0] for x in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return [x[0] for x in self.input_grad_arrays]
        return self.input_grad_arrays

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
