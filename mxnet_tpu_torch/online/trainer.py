"""Supervised fine-tune rounds over captured serve traffic (counterpart
of ``mxnet_tpu/online/trainer.py``).

:class:`OnlineTrainer` is the retrain leg of the online loop: it turns
the sealed capture shards into a replay feed
(:func:`mxnet_tpu_torch.online.replay.replay_pipeline`) and runs
``Module.fit`` against one persistent checkpoint store with
``resume=True`` — so a round interrupted by preemption, a torn save or
a SIGKILL resumes **bitwise** from the latest committed step when the
:class:`mxnet_tpu_torch.faults.Supervisor` restarts the process.  The
candidate the promotion gate evaluates is simply the newest committed
checkpoint step.

Rounds are cumulative: ``round(num_epoch=N)`` trains *up to* epoch N
over the current shard snapshot.  Passing the cumulative target (rather
than a per-round increment) keeps a restarted attempt idempotent — an
attempt that crashed after finishing its epochs re-enters ``fit``,
finds ``begin_epoch == num_epoch`` restored from the store, and falls
straight through to the next loop phase.
"""
from __future__ import annotations

import time

from ..base import MXNetError, make_lock
from ..faults import point as _fault_point
from .replay import replay_pipeline

__all__ = ["OnlineTrainer"]


class OnlineTrainer:
    """Fine-tune ``symbol`` on sealed capture shards, checkpointing
    into ``checkpoint_dir``.

    Parameters mirror ``Module.fit``: ``optimizer``/
    ``optimizer_params``/``eval_metric``/``superstep`` pass straight
    through; ``arg_params`` seeds the FIRST round only (later rounds
    resume from the store).  ``context`` defaults to the current
    context (the card, unless a ``with mx.cpu():`` scope asks for the
    host).
    """

    def __init__(self, symbol, capture_dir: str, checkpoint_dir: str, *,
                 batch_size: int, optimizer: str = "sgd",
                 optimizer_params=None, arg_params=None,
                 eval_metric="acc", checkpoint_every: int = 1,
                 superstep=None, context=None, to_device: bool = False,
                 name: str = "online-trainer"):
        self.name = name
        self.symbol = symbol
        self.capture_dir = str(capture_dir)
        self.checkpoint_dir = str(checkpoint_dir)
        self.batch_size = int(batch_size)
        self.optimizer = optimizer
        self.optimizer_params = optimizer_params
        self.arg_params = arg_params
        self.eval_metric = eval_metric
        self.checkpoint_every = int(checkpoint_every)
        self.superstep = superstep
        self.context = context
        self.to_device = to_device
        self._lock = make_lock("online.trainer")
        self._rounds = 0
        self._fit_s = 0.0
        self._last_step = None
        from .. import profiler
        profiler.register_online_stats(self)

    def round(self, num_epoch: int, shards=None) -> dict:
        """One supervised fine-tune round: train up to cumulative epoch
        ``num_epoch`` on the current sealed-shard snapshot (or an
        explicit ``shards`` list, pinned for cross-attempt
        determinism), resuming from the checkpoint store.  -> summary
        dict with the candidate's committed ``step``."""
        from ..context import current_context
        from ..module import Module
        from .. import checkpoint as ck
        _fault_point("online.train", stage="round",
                     num_epoch=int(num_epoch))
        it = replay_pipeline(self.capture_dir, self.batch_size,
                             shards=shards, to_device=self.to_device)
        t0 = time.perf_counter()
        try:
            mod = Module(self.symbol,
                         context=self.context or current_context())
            mod.fit(it, num_epoch=int(num_epoch),
                    arg_params=self.arg_params,
                    eval_metric=self.eval_metric,
                    optimizer=self.optimizer,
                    optimizer_params=self.optimizer_params,
                    checkpoint=self.checkpoint_dir,
                    checkpoint_every=self.checkpoint_every,
                    superstep=self.superstep,
                    resume=True)
        finally:
            it.close()
        mgr = ck.CheckpointManager(self.checkpoint_dir, keep_last_n=None)
        try:
            step = mgr.latest_step()
        finally:
            mgr.close()
        if step is None:
            raise MXNetError(
                "online round committed no checkpoint step — nothing "
                "for the promotion gate to evaluate (capture empty?)")
        with self._lock:
            self._rounds += 1
            self._fit_s += time.perf_counter() - t0
            self._last_step = step
        return {"step": step, "num_epoch": int(num_epoch)}

    def supervisor(self, argv, **kw):
        """A :class:`mxnet_tpu_torch.faults.Supervisor` wired to this
        trainer's checkpoint store (recovery is measured against commit
        progress there)."""
        from ..faults import Supervisor
        kw.setdefault("checkpoint_dir", self.checkpoint_dir)
        kw.setdefault("name", self.name)
        return Supervisor(argv, **kw)

    # -- introspection -----------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            return {
                "kind": "trainer",
                "rounds": self._rounds,
                "fit_s": round(self._fit_s, 4),
                "last_step": self._last_step,
            }

    def report_str(self) -> str:
        r = self.report()
        return ("online trainer %r: %d rounds (%.2fs fit), last step %s"
                % (self.name, r["rounds"], r["fit_s"], r["last_step"]))
