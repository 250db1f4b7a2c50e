"""The executor group of the Module API (counterpart of
``mxnet_tpu/module/executor_group.py``): one executor per context over
that context's slice of the batch (``work_load_list`` sizes the slices),
each batch loaded into the bound arrays, and the parameter, gradient and
aux arrays in the reference's per-device list layout.  Distinct
``cpu(i)`` contexts stand for several devices on one host, and
``[gpu(0), gpu(0)]`` runs two executors on one card."""
from __future__ import annotations

import logging
from typing import List, Sequence

from ..base import MXNetError
from ..context import Context, cpu
from ..executor_manager import _load_data, _load_label, _split_input_slice
from ..ndarray import concatenate as nd_concatenate
from ..symbol import Symbol

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    """Executors over devices for one symbol (reference
    executor_group.py:15)."""

    def __init__(self, symbol: Symbol, contexts: Sequence[Context],
                 workload, data_shapes, label_shapes, param_names,
                 for_training, inputs_need_grad, shared_group=None,
                 input_types=None, logger=logging, fixed_param_names=None,
                 grad_req="write", no_slice_names=None):
        self.no_slice = frozenset(no_slice_names or ())
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
        inputs = list(data_shapes) + list(label_shapes or [])
        if len(self.contexts) > 1 and any(
                not self._batch_major(name, s) for name, s in inputs):
            raise MXNetError(
                "inputs whose leading dim is not the batch size (or that "
                "bind() marked no-slice) cannot be split across devices "
                "(they are replicated whole); bind on a single context or "
                "restructure the input")
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
        self.execs = []
        for i, ctx in enumerate(self.contexts):
            n = self.slices[i].stop - self.slices[i].start
            shapes = {name: ((n,) + tuple(s[1:])
                             if self._batch_major(name, s) else tuple(s))
                      for name, s in inputs}
            shared_exec = shared_group.execs[i] if shared_group else None
            self.execs.append(self.symbol.simple_bind(
                ctx, grad_req=grad_req, type_dict=self.input_types,
                shared_exec=shared_exec, **shapes))

        def targets(name, shape):
            # an input whose leading dim is not the batch size (Fast
            # R-CNN's rois and roi-level labels), or that bind() marked
            # no-slice, is copied whole
            full = slice(0, shape[0] if shape else 1)
            return [((self.slices[i] if self._batch_major(name, shape)
                      else full), e.arg_dict[name])
                    for i, e in enumerate(self.execs)]
        shapes = dict(inputs)
        self.data_arrays = [targets(name, shapes[name])
                            for name in self.data_names]
        self.label_arrays = [targets(name, shapes[name])
                             for name in self.label_names]
        self.param_arrays = [[e.arg_dict[name] for e in self.execs]
                             for name in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(name) for e in self.execs]
                            for name in self.param_names] \
            if self.for_training else []
        self.input_grad_arrays = [[e.grad_dict.get(name)
                                   for e in self.execs]
                                  for name in self.data_names] \
            if self.inputs_need_grad else []
        self.aux_arrays = [[e.aux_dict[name] for e in self.execs]
                           for name in self.aux_names]

    def set_params(self, arg_params, aux_params):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters, averaged over the devices, into the
        given dicts' arrays (reference executor_group.py get_params)."""
        for names, blocks, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, blocks):
                if len(block) == 1:
                    block[0].copyto(out[name])
                    continue
                weight = sum(w.copyto(cpu())._get() for w in block) \
                    / len(block)
                out[name][:] = weight

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
        if len(self.execs) == 1:
            self.execs[0].backward(out_grads=out_grads)
            return
        for i, exe in enumerate(self.execs):
            sliced = None
            if out_grads is not None:
                # only batch-major heads are sliced; roi-level outputs
                # carry every row on every device
                sliced = [g[self.slices[i].start:self.slices[i].stop]
                          if g.shape[0] == self.batch_size else g
                          for g in out_grads]
            exe.backward(out_grads=sliced)

    def get_outputs(self, merge_multi_context=True):
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [nd_concatenate(x, axis=0) if len(x) > 1 else x[0]
                    for x in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if merge_multi_context:
            return [nd_concatenate(x, axis=0) if len(x) > 1 else x[0]
                    for x in self.input_grad_arrays]
        return self.input_grad_arrays

    def update_metric(self, eval_metric, labels):
        names = list(self.label_names or [])
        names += [None] * (len(labels) - len(names))
        for exe, islice in zip(self.execs, self.slices):
            labels_slice = [label[islice.start:islice.stop]
                            if (name not in self.no_slice
                                and label.shape[0] == self.batch_size)
                            else label
                            for name, label in zip(names, labels)]
            eval_metric.update(labels_slice, exe.outputs)

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
