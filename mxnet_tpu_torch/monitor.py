"""Monitor: per-batch statistics of the tensors an executor computes.

Counterpart of ``mxnet_tpu/monitor.py``.  ``install`` hooks an executor
(``Executor.set_monitor_callback``), which reports each output by name
after every forward (with ``monitor_all`` each argument and aux state
too); every ``interval`` batches, between ``tic`` and ``toc``, the tensors
whose names match ``pattern`` are read back to the host and reduced by
``stat_func`` (mean |x| by default).  ``toc`` returns the (step, name,
stat) rows and ``toc_print`` logs them.  With telemetry on, each scalar
stat also sets the ``mxnet_monitor_tensor_stat{tensor}`` gauge, whose
series ``close`` reclaims.
"""
import logging
import re

import numpy as np

from .ndarray import NDArray

__all__ = ["Monitor"]

_STAT_GAUGES = {}       # tensor name -> memoized gauge child


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
        self._published = set()     # tensor labels this Monitor created
        self.logger = logging.getLogger(__name__)

    def stat_helper(self, name, arr):
        """The executor's callback: queue (step, name, stat) while
        active."""
        if not self.activated or not self.re_pattern.match(name):
            return
        arr = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
        stat = self.stat_func(arr)
        self.queue.append((self.step, name, stat))
        # scalar stats also land on the telemetry registry (one gauge
        # series per monitored tensor), scrapeable beside the rest
        from . import telemetry
        if telemetry.enabled():
            try:
                value = float(stat)
            except (TypeError, ValueError):
                pass        # non-scalar stat_func: log-only
            else:
                telemetry.bound(
                    _STAT_GAUGES, name,
                    lambda: telemetry.gauge(
                        "mxnet_monitor_tensor_stat",
                        "latest Monitor stat_func value per monitored "
                        "tensor", ("tensor",)).labels(tensor=name)
                ).set(value)
                self._published.add(name)

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
        """Stop collecting, forget the executors, and reclaim this
        Monitor's ``mxnet_monitor_tensor_stat`` series (and the shared
        memo entries, so a later Monitor binds fresh children)."""
        from . import telemetry
        fam = telemetry.registry().get("mxnet_monitor_tensor_stat")
        for name in self._published:
            if fam is not None:
                fam.remove(tensor=name)
            _STAT_GAUGES.pop(name, None)
        self._published.clear()
        self.activated = False
        self.queue = []
        self.exes = []
