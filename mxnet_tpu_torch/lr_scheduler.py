"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``,
a copy: plain Python, shared by the classic and fused update paths)."""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    """Base LR scheduler: maps num_update -> lr (reference lr_scheduler.py:6)."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError()

    def state_dict(self) -> dict:
        """JSON-able snapshot of the schedule position (base_lr plus any
        counters a subclass keeps), for checkpointing: a resumed run must
        not replay completed lr decays."""
        return {k: v for k, v in vars(self).items()
                if isinstance(v, (int, float, bool, str))
                or (isinstance(v, list)
                    and all(isinstance(x, (int, float)) for x in v))}

    def load_state_dict(self, state: dict) -> None:
        for k, v in (state or {}).items():
            if k in vars(self):
                setattr(self, k, v)


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (reference lr_scheduler.py:36)."""

    def __init__(self, step, factor=1.0):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            logging.info("Update[%d]: Change learning rate to %0.5e",
                         num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each listed step (reference lr_scheduler.py:76)."""

    def __init__(self, step, factor=1.0):
        super().__init__()
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing integer list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr
