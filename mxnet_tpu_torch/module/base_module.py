"""BaseModule: the abstract intermediate-level interface and the fit loop
(counterpart of ``mxnet_tpu/module/base_module.py``).

``fit`` keeps the reference's signature and its per-batch order (the
monitor's tic, forward_backward, update, update_metric, the monitor's
toc, the batch-end callbacks), then the epoch-end callbacks and the
validation score.  ``superstep=K`` (or ``MXNET_SUPERSTEP``) trains K
batches per ``superstep_train``, falling back to K=1 with the
reference's logged reasons; ``prefetch_to_device=`` stages batches (or
K-batch megabatches) on the device ahead of their step through
``feed.device_feed``; a feed whose iterator carries an ``augment_spec``
(uint8 batches of ``record_pipeline(device_augment=True)``) installs its
prologue on the fused step.  ``checkpoint=``/``checkpoint_every=``/
``resume=`` save the full train state through ``mx.checkpoint``, with
the iterator's feed cursor (``state()``) in ``meta["feed"]``, and resume
from the newest committed step at the exact next batch: through the
iterator's ``restore()`` when it has one, else by skipping the batches
already trained.  ``mesh=`` trains over a mesh's ``dp`` axis and
``sharding=`` holds each parameter with a spec as its shard
(``Module.set_mesh``).  ``autotune=True`` (or ``MXNET_AUTOTUNE=1``)
measures the superstep K when neither ``superstep=`` nor
``MXNET_SUPERSTEP`` chose one; ``autotune="joint"`` searches K x remat
(``autotune.tune_fit_joint``) and installs the winner
(``apply_joint_config``).  Measuring never advances training.
"""
from __future__ import annotations

import logging
import time

from .. import trace as _trace
from ..base import MXNetError, get_env
from .. import metric as metric_mod
from ..model import BatchEndParam
from ..initializer import Uniform

__all__ = ["BaseModule"]


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

    def _wire_eval_augment(self, eval_data):
        """A device-augment pipeline (uint8 wire, feed.AugmentSpec on the
        iterator) used for score/predict installs its prologue on the
        fused step -- or fails with the actionable message -- before its
        batches reach the step (reference base_module.py:57-85)."""
        spec = getattr(eval_data, "augment_spec", None)
        if spec is None:
            return
        applier = getattr(self, "apply_augment_spec", None)
        if applier is None or not applier(spec):
            raise MXNetError(
                "eval_data ships uint8 device-augment batches but this "
                "module has no fused step to run the on-device "
                "prologue; rebuild the pipeline with "
                "device_augment=False (or MXNET_FEED_DEVICE_AUGMENT=0)")

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, reset=True, epoch=0):
        """Evaluate ``eval_metric`` over ``eval_data``; -> [(name, value)]."""
        assert self.binded and self.params_initialized
        self._wire_eval_augment(eval_data)
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
        self._wire_eval_augment(eval_data)
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
        self._wire_eval_augment(eval_data)
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

        ``prefetch_to_device``: wrap ``train_data`` with the feed's
        device prefetcher (``Module.prefetch_to_device``), so batch N+1's
        copy to the device is issued while batch N trains; an int sets
        the lookahead depth (True = 2).  With ``superstep=K`` it stages
        whole megabatches.

        ``checkpoint``: a ``mx.checkpoint.CheckpointManager`` or a
        directory; saves every ``checkpoint_every`` batches and at every
        epoch end, with ``train_data.state()`` (a feed cursor) in
        ``meta["feed"]`` when the iterator has one.  ``resume=True``
        restores the newest committed step and continues from the exact
        next batch: ``train_data.restore(meta["feed"])`` when both exist,
        else by skipping the batches it had trained.  A SIGTERM caught
        by the manager's ``install_preemption_handler`` snapshots at the
        next batch boundary and returns.  ``work_load_list`` is the
        constructor's (the reference's fit ignores it too).

        ``autotune``: True (or ``MXNET_AUTOTUNE=1`` with ``autotune=None``)
        picks the superstep K by measuring candidate Ks on the real step
        (``autotune.tune_superstep``) when neither ``superstep=`` nor
        ``MXNET_SUPERSTEP`` chose; ``"joint"`` ranks superstep K x remat
        with the cost model and measures a shortlist
        (``autotune.tune_fit_joint``).  Every trial runs between a
        snapshot of the train state and its restore, so training does not
        advance; Ks a superstep blocker rules out are never measured.  The
        winner persists under ``MXNET_AUTOTUNE_DIR`` and the next fit of
        the same model loads it without measuring
        (``mx.profiler.autotune_report()``)."""
        if mesh is not None or sharding is not None:
            setter = getattr(self, "set_mesh", None)
            if setter is None:
                raise MXNetError(
                    "fit(mesh=...) needs a module with multichip support "
                    "(Module); %s has no set_mesh" % type(self).__name__)
            setter(mesh, sharding)
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
        # compact-feed pipelines (record_pipeline(device_augment=True))
        # ship uint8 HWC batches and carry the spec the fused step runs
        # at its head (reference base_module.py:160-188)
        aug_spec = getattr(train_data, "augment_spec", None)
        eval_spec = getattr(eval_data, "augment_spec", None) \
            if eval_data is not None else None
        if aug_spec is not None and eval_spec is not None and \
                aug_spec.signature() != eval_spec.signature():
            # one step carries ONE prologue; two specs would silently
            # augment eval with the train parameters
            raise MXNetError(
                "train_data and eval_data carry different device-augment "
                "specs (%r vs %r); build both pipelines with the same "
                "augmentation parameters" % (aug_spec, eval_spec))
        aug_spec = aug_spec or eval_spec
        applier = getattr(self, "apply_augment_spec", None)
        if aug_spec is not None:
            if applier is None or not applier(aug_spec):
                raise MXNetError(
                    "the training/eval feed ships uint8 device-augment "
                    "batches but this module has no fused train step to "
                    "run the on-device prologue; rebuild the pipeline "
                    "with device_augment=False (or MXNET_FEED_DEVICE_"
                    "AUGMENT=0) for the host-augmented f32 path")
        elif callable(applier):
            # a spec left by an earlier fit on this module would key this
            # float32 feed's graphs apart and block the classic fallback
            applier(None)
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
                           superstep, prefetch_to_device, autotune)
        finally:
            if owns_mgr:
                ckpt_mgr.close()

    def _autotune_superstep(self, autotune, eval_metric, monitor,
                            batch_end_callback, ckpt_mgr) -> int:
        """The superstep K ``fit(autotune=)`` picks (1 when tuning is
        off or the module has no fused superstep), installing a joint
        winner's remat (reference base_module.py:355-393)."""
        from ..autotune import mode as _autotune_mode
        amode = _autotune_mode(autotune)
        if amode is None or not callable(
                getattr(self, "superstep_train", None)) or \
                getattr(self, "_fused", None) is None:
            return 1

        def viable(k):
            return self._superstep_blockers(
                eval_metric, k, monitor=monitor,
                batch_end_callback=batch_end_callback,
                checkpoint_every=(ckpt_mgr.save_every_steps
                                  if ckpt_mgr is not None else None))
        if amode == "joint" and callable(
                getattr(self, "apply_joint_config", None)):
            from ..autotune import tune_fit_joint
            jcfg = tune_fit_joint(self, viable=viable)
            self.apply_joint_config(jcfg)
            self.logger.info("autotune(joint): superstep K=%d unroll=%d "
                             "remat=%s", jcfg["superstep"], jcfg["unroll"],
                             jcfg["remat"])
            return int(jcfg["superstep"])
        from ..autotune import tune_superstep
        k = tune_superstep(self, viable=viable)
        self.logger.info("autotune: superstep K=%d", k)
        return k

    def _fit_loop(self, train_data, eval_data, eval_metric,
                  epoch_end_callback, batch_end_callback,
                  eval_batch_end_callback, begin_epoch, num_epoch,
                  validation_metric, monitor, ckpt_mgr, resume, superstep,
                  prefetch_to_device=False, autotune=None):
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        k_env = get_env("MXNET_SUPERSTEP", None, int)
        if superstep is not None:
            k_super = int(superstep)
        elif k_env is not None:
            k_super = k_env
        else:
            k_super = self._autotune_superstep(
                autotune, eval_metric, monitor, batch_end_callback,
                ckpt_mgr)
        k_super = max(1, k_super)
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
        if prefetch_to_device and hasattr(self, "prefetch_to_device"):
            # after init_optimizer, so batches land on the fused step's
            # device; under a superstep the prefetcher stages megabatches
            depth = 2 if prefetch_to_device is True \
                else max(1, int(prefetch_to_device))
            train_data = self.prefetch_to_device(
                train_data, depth=depth, megabatch=k_super if use_super
                else 1)

        # each fit journals on its own: a later fit restarting from step
        # 1 in the same process must not be muted by the previous run's
        # high-water step
        _trace.reset_journal()
        global_step = 0
        start_epoch, start_batch = begin_epoch, 0
        if ckpt_mgr is not None and resume:
            from ..checkpoint import restore_module
            meta = restore_module(ckpt_mgr, self)
            if meta is not None:
                global_step = int(meta.get("global_step", 0))
                start_epoch = int(meta.get("epoch", begin_epoch))
                start_batch = int(meta.get("nbatch", 0))
                restore = getattr(train_data, "restore", None)
                feed_state = meta.get("feed")
                if feed_state is not None and callable(restore):
                    restore(feed_state)
                elif start_batch and callable(restore):
                    # a cursor-less checkpoint resumed into a feed wrapper
                    # (prefetch added after the save): its restore()
                    # skips UNDERLYING batches, where next() would pop
                    # whole megabatches
                    restore({"batch": start_batch})
                else:
                    # a plain DataIter: skip the batches the checkpoint
                    # had trained (counting those a megabatch carries)
                    skipped = 0
                    while skipped < start_batch:
                        try:
                            b = train_data.next()
                        except StopIteration:
                            break
                        skipped += getattr(b, "megabatch", 1)
                self.logger.info(
                    "resumed from checkpoint step %d: epoch %d, batch %d",
                    global_step, start_epoch, start_batch)
        last_saved_step = [-1]

        def ckpt_save(epoch_, nbatch_, blocking=False):
            from ..checkpoint import save_module
            meta = {"global_step": global_step, "epoch": epoch_,
                    "nbatch": nbatch_}
            if callable(getattr(train_data, "state", None)):
                meta["feed"] = train_data.state()
            save_module(ckpt_mgr, self, global_step, meta=meta,
                        blocking=blocking)
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
                # the run-metrics journal (MXNET_TRACE_JOURNAL): one
                # unified_report line every N global steps
                _trace.maybe_journal_step(global_step, epoch=epoch,
                                          nbatch=nbatch)
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
                # K batches, or one prefetch-staged megabatch, per
                # superstep (reference base_module.py:555-610); a
                # prefetcher stages the next megabatch before each drain
                data_iter = iter(train_data)
                stage = getattr(train_data, "stage_ahead", None)
                ahead = {"before_drain": stage} if callable(stage) else {}
                while not preempted:
                    mega, pulled = None, []
                    while len(pulled) < k_super:
                        try:
                            b = next(data_iter)
                        except StopIteration:
                            break
                        if getattr(b, "megabatch", 0) > 1:
                            mega = b
                            break
                        pulled.append(b)
                    if mega is None and not pulled:
                        break
                    if pulled and (mega is not None
                                   or len(pulled) < k_super):
                        # plain batches that cannot form a full K (the
                        # epoch tail, or stragglers ahead of a megabatch):
                        # one at a time, never dropped; the feed cursor
                        # already counts them all, so saves wait for the
                        # group's end
                        start_step = global_step
                        for i, b in enumerate(pulled):
                            last = i == len(pulled) - 1
                            if train_one(b, allow_ckpt=last,
                                         ckpt_from=(start_step if last
                                                    else None)):
                                return
                        pulled = []
                    group = mega if mega is not None else pulled
                    if not group:
                        continue
                    count = mega.megabatch if mega is not None \
                        else len(pulled)
                    if self.superstep_train(group, eval_metric,
                                            **ahead):
                        fire_batch_end(nbatch + count - 1, {"group": group})
                        if advance(count):
                            return
                        continue
                    # a superstep refused: one batch at a time (an
                    # unstacked megabatch was counted whole by the feed
                    # cursor), saves deferred to the group's end
                    singles = mega.unstack() if mega is not None \
                        else pulled
                    start_step = global_step
                    for i, b in enumerate(singles):
                        last = i == len(singles) - 1
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
            toc = time.perf_counter()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, toc - tic)
            _trace.complete("fit:epoch", tic, toc - tic, cat="train",
                            epoch=epoch, batches=nbatch)
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
