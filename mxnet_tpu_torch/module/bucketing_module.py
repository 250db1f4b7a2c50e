"""BucketingModule: variable-length sequence training through one Module
per bucket, every bucket sharing the parameters (counterpart of
``mxnet_tpu/module/bucketing_module.py``).

The first bucket bound (the default one) owns the executor arrays; every
other bucket binds with ``shared_module=`` the default module, sharing
its parameter and gradient tensors, and borrows its optimizer and
updater, so every bucket trains one set of parameters and optimizer
states.  Bucket modules run the classic path (eager forward, backward,
then the updater), as in the reference.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Bucketing over a ``sym_gen(bucket_key)`` factory (reference
    bucketing_module.py:16); ``sym_gen`` returns a symbol, or (symbol,
    data_names, label_names)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._buckets = {}
        self._curr_module = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, bucket_key):
        res = self._sym_gen(bucket_key)
        if isinstance(res, tuple):
            return res
        return (res, ("data",), ("softmax_label",))

    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list)

    def get_params(self):
        """The shared parameters, read back from the shared arrays when
        any bucket has updated them since the last read."""
        assert self.binded and self.params_initialized
        mod = self._curr_module
        mod._params_dirty = any(m._params_dirty
                                for m in self._buckets.values())
        params = mod.get_params()
        for m in self._buckets.values():
            m._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket (reference bucketing_module.py:137)."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False, shared_module=None,
                    grad_req=grad_req)
        self._curr_module = module
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding it on the default bucket's
        arrays the first time (reference bucketing_module.py:189-213)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key],
                        grad_req=self._curr_module._exec_group.grad_req)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]

    def prepare(self, bucket_shapes):
        """Bind every listed bucket ahead of the training loop.

        ``bucket_shapes``: {bucket_key: (data_shapes, label_shapes)} or an
        iterable of (bucket_key, data_shapes, label_shapes).  To build
        each bucket's program as well, call :meth:`precompile`."""
        assert self.binded and self.params_initialized, \
            "call bind and init_params before prepare"
        if isinstance(bucket_shapes, dict):
            items = [(k, v[0], v[1]) for k, v in bucket_shapes.items()]
        else:
            items = [tuple(it) for it in bucket_shapes]
        keep = self._curr_module
        for key, data_shapes, label_shapes in items:
            self.switch_bucket(key, data_shapes, label_shapes)
        self._curr_module = keep

    def precompile(self, bucket_shapes, threads=None):
        """Bind every listed bucket, and every bound bucket that has not
        built its program yet, then build each one's program through a
        bounded pool (reference bucketing_module.py:252-292): a bucket on
        the fused step warms and captures its step without advancing
        training (``FusedTrainStep.prepare``; the captures of one device
        run one at a time), every other bucket precompiles its executors
        (``Executor.precompile``, which runs nothing the loop can see).

        ``bucket_shapes``: {bucket_key: (data_shapes, label_shapes)} or an
        iterable of (bucket_key, data_shapes, label_shapes).  ``threads``
        bounds the pool (default: one a bucket up to the host's cores).
        -> the labels of the buckets built."""
        assert self.binded and self.params_initialized, \
            "call bind and init_params before precompile"
        if self.for_training and not self.optimizer_initialized:
            raise MXNetError(
                "precompile() on a training-bound bucketing module needs "
                "init_optimizer first")
        from ..compile_cache import parallel_warm
        if isinstance(bucket_shapes, dict):
            items = [(k, v[0], v[1]) for k, v in bucket_shapes.items()]
        else:
            items = [tuple(it) for it in bucket_shapes]
        listed = {it[0] for it in items}
        for key, mod in self._buckets.items():
            if key not in listed and self._is_cold(mod):
                items.append((key, mod._data_shapes, mod._label_shapes))
        keep = self._curr_module
        tasks = []
        try:
            for key, data_shapes, label_shapes in items:
                self.switch_bucket(key, data_shapes, label_shapes)
                mod = self._curr_module
                if not self._is_cold(mod):
                    continue
                label = "bucket %r (data %s)" % (key, list(data_shapes))
                if mod._fused is not None and self.for_training:
                    from ..autotune import _zero_batch
                    batch = mod._fused.make_batch(_zero_batch(mod),
                                                  note_ids=False)
                    tasks.append((label, lambda m=mod, b=batch:
                                  m._fused.prepare(b)))
                else:
                    kinds = None if self.for_training else ("fwd_eval",)
                    for ex in mod._exec_group.execs:
                        tasks.append((label,
                                      lambda e=ex, k=kinds: e.precompile(k)))
        finally:
            self._curr_module = keep
        parallel_warm(tasks, threads=threads)
        return [label for label, _ in tasks]

    @staticmethod
    def _is_cold(mod) -> bool:
        """Whether a bucket's module has built no program yet."""
        if mod._fused is not None:
            return not mod._fused._graphs and not mod._fused.stats.eager_steps
        return not any(ex.has_compiled() for ex in mod._exec_group.execs)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        """The current bucket's optimizer, lent to every other bucket."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        if optimizer_params is None:
            optimizer_params = (("learning_rate", 0.01),)
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Install ``mon`` on every bucket bound so far (the reference's
        rule: a bucket bound later has none)."""
        assert self.binded
        for mod in self._buckets.values():
            mod.install_monitor(mon)
