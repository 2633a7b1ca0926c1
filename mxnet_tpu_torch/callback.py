"""Training callbacks (counterpart of ``Speedometer`` in
``mxnet_tpu/callback.py``)."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer"]


class Speedometer:
    """Batch-end callback that logs samples per second, and the running
    metric, every ``frequent`` batches.  The clock restarts at the first
    batch of each epoch, so start-up time does not count."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = max(1, int(frequent))
        self.auto_reset = auto_reset
        self._stamp = None          # (time, nbatch) of the last report
        self._prev_nbatch = -1

    def __call__(self, param):
        now = time.time()
        if param.nbatch < self._prev_nbatch or self._stamp is None:
            self._stamp = (now, param.nbatch)
            self._prev_nbatch = param.nbatch
            return
        self._prev_nbatch = param.nbatch
        if param.nbatch % self.frequent:
            return
        t0, n0 = self._stamp
        if now <= t0:
            return
        rate = (param.nbatch - n0) * self.batch_size / (now - t0)
        if param.eval_metric is not None:
            pieces = ["%s=%f" % nv
                      for nv in param.eval_metric.get_name_value()]
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                         param.epoch, param.nbatch, rate,
                         "\t".join(pieces))
            if self.auto_reset:
                param.eval_metric.reset()
        else:
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, rate)
        self._stamp = (now, param.nbatch)
