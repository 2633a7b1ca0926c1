"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py``: ``module_checkpoint``,
``do_checkpoint``, ``log_train_metric``, ``Speedometer``, ``ProgressBar``
and ``LogValidationMetricsCallback``.  Batch-end and eval-end callbacks
take a ``BatchEndParam`` (epoch, nbatch, eval_metric, locals); epoch-end
callbacks take (epoch index, symbol, arg_params, aux_params).
"""
from __future__ import annotations

import logging
import sys
import time


__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def _fmt_metric(eval_metric):
    """A metric's (name, value) pairs as 'name=value' strings."""
    return ["%s=%f" % nv for nv in eval_metric.get_name_value()]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback: ``mod.save_checkpoint(prefix, epoch,
    save_optimizer_states)`` every ``period`` epochs (epochs counted from
    1)."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        epoch = iter_no + 1
        if epoch % period == 0:
            mod.save_checkpoint(prefix, epoch, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs (epochs counted from
    1)."""
    from .model import save_checkpoint
    period = max(1, int(period))

    def _callback(iter_no, sym, arg, aux):
        epoch = iter_no + 1
        if epoch % period == 0:
            save_checkpoint(prefix, epoch, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches."""
    period = max(1, int(period))

    def _callback(param):
        if param.eval_metric is None or param.nbatch % period != 0:
            return
        logging.info("Iter[%d] Batch[%d] Train-%s", param.epoch, param.nbatch,
                     "\t".join(_fmt_metric(param.eval_metric)))
        if auto_reset:
            param.eval_metric.reset()
    return _callback


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
            pieces = _fmt_metric(param.eval_metric)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                         param.epoch, param.nbatch, rate,
                         "\t".join(pieces))
            if self.auto_reset:
                param.eval_metric.reset()
        else:
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, rate)
        self._stamp = (now, param.nbatch)


class ProgressBar:
    """Batch-end callback drawing an ASCII bar of ``nbatch / total``."""

    def __init__(self, total, length=80):
        self.total = max(1, int(total))
        self.length = max(1, int(length))

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        done = int(self.length * frac + 0.5)
        bar = "=" * done + "-" * (self.length - done)
        sys.stdout.write("[%s] %d%%\r" % (bar, int(frac * 100 + 0.999)))


class LogValidationMetricsCallback:
    """Eval-end callback logging the validation metrics."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
