"""Monitor: per-batch statistics of the tensors an executor computes.

Counterpart of ``mxnet_tpu/monitor.py``.  ``install`` hooks an executor
(``Executor.set_monitor_callback``), which reports each output by name
after every forward (with ``monitor_all`` each argument and aux state
too); every ``interval`` batches, between ``tic`` and ``toc``, the tensors
whose names match ``pattern`` are read back to the host and reduced by
``stat_func`` (mean |x| by default).  ``toc`` returns the (step, name,
stat) rows and ``toc_print`` logs them.  The stats are kept here only:
the reference also sets a telemetry gauge per tensor, which the port does
not export yet.
"""
import logging
import re

import numpy as np

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        if stat_func is None:
            def stat_func(x):
                return np.abs(x).mean()
        self.stat_func = stat_func
        self.interval = interval
        self.sort = sort
        self.re_pattern = re.compile(pattern)
        self.monitor_all = monitor_all
        self.queue = []
        self.step = 0
        self.activated = False
        self.exes = []
        self.logger = logging.getLogger(__name__)

    def stat_helper(self, name, arr):
        """The executor's callback: queue (step, name, stat) while
        active."""
        if not self.activated or not self.re_pattern.match(name):
            return
        arr = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
        self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper, self.monitor_all)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch if the interval has elapsed."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End the batch: [(step, name, str(stat))], sorted with
        ``sort``."""
        if not self.activated:
            return []
        self.activated = False
        queue = sorted(self.queue) if self.sort else self.queue
        res = [(step, name, str(stat)) for step, name, stat in queue]
        self.queue = []
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            self.logger.info("Batch: %7d %30s %s", step, name, stat)

    def close(self):
        """Stop collecting and forget the executors."""
        self.activated = False
        self.queue = []
        self.exes = []
