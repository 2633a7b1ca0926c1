"""BaseModule: the train/predict interface and the ``fit`` loop.

Counterpart of ``mxnet_tpu/module/base_module.py``: ``forward_backward``,
``score`` and ``fit`` (bind, install the monitor, init params and
optimizer, then per epoch forward_backward / update / ``prepare`` of the
next batch / metric with batch-end callbacks, the monitor ticked before
each step and printed after it, and the epoch-end callbacks with a
host-consistent copy of the parameters).  With telemetry on, ``fit``
attributes each step's wall time to the phases ``data_wait``, ``h2d``
(the executor's batch upload), ``fwd_bwd``, ``optimizer`` (``update``)
and ``metric`` on the ``loop="fit"`` series (telemetry/step.py), with
tail-biased per-step span trees and an MFU gauge against the card's
peak.  Phases are host wall time: the card runs asynchronously, so its
wait falls in whichever phase first reads a result (``metric``).
"""
from __future__ import annotations

import contextlib
import logging
import time

from .. import metric
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _as_list(obj):
    if obj is None:
        return []
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]


def _check_input_names(symbol, names, typename, throw):
    """Declared data/label names must be inputs of the symbol."""
    args = set(symbol.list_arguments())
    missing = [n for n in names if n not in args]
    if not missing:
        return
    msg = ("Module %s_names=%s contains '%s', which is not an input of the "
           "symbol" % (typename, list(names), missing[0]))
    if throw:
        raise ValueError(msg)
    logging.warning(msg)


def _lookahead_iter(source):
    """Yield (batch, next batch or None), so the loop can prepare the
    upcoming batch while the device still computes the current one."""
    it = iter(source)
    try:
        cur = next(it)
    except StopIteration:
        return
    for nxt in it:
        yield cur, nxt
        cur = nxt
    yield cur, None


class BaseModule:
    """Lifecycle: bind -> init_params -> init_optimizer -> forward /
    backward / update, or fit / score."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def prepare(self, data_batch):
        """Make ready for ``data_batch`` before it is fed (a no-op)."""

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """``eval_metric`` over ``eval_data`` in inference mode."""
        assert self.binded and self.params_initialized
        eval_metric = metric.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            for cb in _as_list(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric, locals=locals()))
        for cb in _as_list(score_end_callback):
            cb(BatchEndParam(epoch=epoch, nbatch=nbatch + 1,
                             eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Train over ``train_data`` for epochs [begin_epoch, num_epoch).
        Each step runs forward_backward and update, then ``prepare``s the
        next batch, then updates the metric, as the reference orders
        them."""
        if num_epoch is None:
            raise ValueError("fit() needs num_epoch")
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
        validation_metric = validation_metric or eval_metric
        eval_metric = metric.create(eval_metric)

        from ..telemetry import step as step_mod
        # the device this module is bound to: MFU's peak and the memory
        # watermark report against the training card
        ctx = getattr(self, "_context", None)
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None
        st = step_mod.fit_timer(self._symbol, train_data.provide_data,
                                train_data.provide_label,
                                device=getattr(ctx, "device", None))

        for epoch in range(begin_epoch, num_epoch):
            t_epoch = time.time()
            eval_metric.reset()
            nbatch = 0
            lookahead = _lookahead_iter(train_data)
            while True:
                if st is not None:
                    st.begin_step()
                exhausted = False
                try:
                    with (step_mod.activate(st) if st is not None
                          else contextlib.nullcontext()):
                        with step_mod.active_phase("data_wait"):
                            pair = next(lookahead, None)
                        if pair is None:
                            exhausted = True
                        else:
                            batch, upcoming = pair
                            if monitor is not None:
                                monitor.tic()
                            with step_mod.active_phase("fwd_bwd"):
                                self.forward_backward(batch)
                            self.update()   # the optimizer phase inside
                            if upcoming is not None:
                                self.prepare(upcoming)
                            with step_mod.active_phase("metric"):
                                self.update_metric(eval_metric,
                                                   batch.label)
                            if monitor is not None:
                                monitor.toc_print()
                            for cb in _as_list(batch_end_callback):
                                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                                 eval_metric=eval_metric,
                                                 locals=locals()))
                finally:
                    if st is not None:
                        if exhausted:
                            st.abort_step()
                        else:
                            st.end_step()
                if exhausted:
                    break
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - t_epoch)
            arg_params, aux_params = self.get_params()
            self.set_params(arg_params, aux_params)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
