"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py``: ``FactorScheduler``,
``MultiFactorScheduler`` and ``PolyScheduler``, host-side callables
``sched(num_update) -> lr`` that the optimizer asks at every update.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler(object):
    """Base: maps the global num_update counter to a learning rate."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates, floored at stop_factor_lr."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("lr floor reached at update %d: %0.5e (held "
                             "from here on)", num_update, self.base_lr)
            else:
                logging.info("lr decayed at update %d -> %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each milestone in `step` (an increasing int list)."""

    def __init__(self, step, factor=1):
        super().__init__()
        assert isinstance(step, list) and len(step) >= 1
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing "
                                 "integer list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or "
                                 "equal than 1")
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
                logging.info("lr milestone hit at update %d -> %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay from base_lr to 0 over max_update steps."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        assert isinstance(max_update, int)
        if max_update < 1:
            raise ValueError("maximum number of updates must be strictly "
                             "positive")
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.power = pwr
        self.base_lr = self.base_lr_orig

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * pow(
                1.0 - float(num_update) / float(self.max_update), self.power)
        return self.base_lr
