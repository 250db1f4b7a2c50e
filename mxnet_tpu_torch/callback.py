"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``)."""
from __future__ import annotations

import logging
import math
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar"]


def do_checkpoint(prefix, module=None):
    """Epoch-end checkpoint callback (reference callback.py:11-30): writes
    the ``prefix-symbol.json`` + ``prefix-NNNN.params`` pair, each file
    published atomically.  With the training ``module``, the full train
    state (optimizer slots, schedule position, random state) is also
    committed as step NNNN under ``prefix-ckpt/``, restorable with
    ``mx.checkpoint.restore_module`` or
    ``fit(checkpoint=..., resume=True)``."""
    manager = [None]

    def _callback(iter_no, sym, arg, aux):
        from .model import save_checkpoint
        save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
        if module is not None and module.optimizer_initialized:
            from .checkpoint import CheckpointManager, save_module
            if manager[0] is None:
                manager[0] = CheckpointManager(prefix + "-ckpt",
                                               keep_last_n=None,
                                               async_save=False)
            save_module(manager[0], module, iter_no + 1,
                        meta={"epoch": iter_no + 1, "nbatch": 0},
                        blocking=True)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Log evaluation metric every `period` batches (reference callback.py:28)."""
    def _callback(param):
        if param.nbatch % period or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()
    return _callback


class Speedometer:
    """Samples/sec logger (reference callback.py:49) — the throughput
    instrument behind every BASELINE.md number. Rates are measured over
    windows of `frequent` batches; the clock restarts whenever the batch
    counter jumps backwards (a new epoch).

    Windows are timed with ``time.perf_counter()`` — a monotonic clock;
    ``time.time()`` is wall-clock and an NTP step (or DST jump) inside a
    window used to corrupt the samples/sec sample.  The rate divides by
    the batches ACTUALLY covered since the window opened, so superstep
    training (``fit(superstep=K)`` fires the callback once per K
    batches, at batch indices that need not hit ``frequent`` exactly)
    reports true throughput instead of skipping windows."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._window_start = None
        self._window_batch = 0
        self._prev_batch = 0

    def __call__(self, param):
        n = param.nbatch
        if n < self._prev_batch:
            self._window_start = None
        self._prev_batch = n
        if self._window_start is None:
            self._window_start = time.perf_counter()
            self._window_batch = n
            return
        covered = n - self._window_batch
        if (n % self.frequent) and covered < self.frequent:
            return
        elapsed = max(time.perf_counter() - self._window_start, 1e-12)
        rate = max(covered, 1) * self.batch_size / elapsed
        metric = param.eval_metric
        if metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, n, rate)
        else:
            for name, value in metric.get_name_value():
                logging.info(
                    "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    "\tTrain-%s=%f", param.epoch, n, rate, name, value)
        self._window_start = time.perf_counter()
        self._window_batch = n


class ProgressBar:
    """ASCII progress bar (reference callback.py:99)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
