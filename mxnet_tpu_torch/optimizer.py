"""Optimizers and the Updater.

Counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base (lr,
wd, ``rescale_grad``, ``clip_gradient``, per-parameter ``lr_mult`` and
``wd_mult`` resolved through ``idx2name``, ``register``/``create``), SGD
on dense gradients through the in-place update ops (with a float32 master
copy of float16 weights under ``multi_precision``), and ``Updater`` /
``get_updater``.  A learning-rate scheduler (``lr_scheduler.py``) gives
the rate of every update from ``num_update``, the largest update count of
any index, which starts at ``begin_num_update``.  The reference's other
optimizers and sparse gradients are not yet ported.
"""
from __future__ import annotations

import logging
import pickle

import numpy as np
import torch

from .context import cpu
from .ndarray import (NDArray, array, zeros, zeros_like, sgd_update,
                      sgd_mom_update, mp_sgd_update, mp_sgd_mom_update)

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create",
           "register"]


class Optimizer:
    """Base optimizer."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s (ported: %s)"
                         % (name, sorted(Optimizer.opt_registry)))

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def _attr_mults(self, key):
        if self.sym is None:
            return {}
        attrs = self.sym.attr_dict()
        return {n: float(attrs[n][key]) for n in self.sym.list_arguments()
                if key in attrs.get(n, {})}

    def set_lr_mult(self, args_lr_mult):
        """Per-parameter lr multipliers, seeded from ``__lr_mult__``."""
        self.lr_mult = self._attr_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-parameter wd multipliers: only ``*_weight`` and ``*_gamma``
        decay by default, as in the reference."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._attr_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _multiplier(self, index, table):
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lr(self, index):
        """The rate of ``index``'s update: the scheduler's at
        ``num_update`` (else ``lr``) times its multiplier."""
        base = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return base * self._multiplier(index, self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._multiplier(index, self.wd_mult)

    def _common_attrs(self, index):
        a = {"lr": self._get_lr(index), "wd": self._get_wd(index),
             "rescale_grad": self.rescale_grad}
        if self.clip_gradient:
            a["clip_gradient"] = self.clip_gradient
        return a

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("sym", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.sym = None


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum, on dense gradients.  With ``multi_precision`` a
    float16 weight's state is (momentum or None, a float32 master copy),
    both f32, and the update runs on the master copy (the reference keeps
    the copy for float16 weights only: bfloat16 and float32 weights take
    the plain update)."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.multi_precision = multi_precision

    def create_state(self, index, weight):
        if weight.dtype == torch.float16:
            if self.multi_precision:
                mom = zeros(weight.shape, weight.context, torch.float32) \
                    if self.momentum != 0.0 else None
                return (mom, array(weight, weight.context, torch.float32))
            logging.warning("Accumulating with float16 in optimizer can "
                            "lead to poor accuracy or slow convergence. "
                            "Consider using multi_precision=True option of "
                            "the SGD optimizer")
        if self.momentum == 0.0:
            return None
        return zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = self._common_attrs(index)
        if isinstance(state, (list, tuple)):
            mom, weight32 = state
            if mom is not None:
                mp_sgd_mom_update(weight, grad, mom, weight32, out=weight,
                                  momentum=self.momentum, **kwargs)
            else:
                mp_sgd_update(weight, grad, weight32, out=weight, **kwargs)
        elif state is not None:
            sgd_mom_update(weight, grad, state, out=weight,
                           momentum=self.momentum, **kwargs)
        else:
            sgd_update(weight, grad, out=weight, **kwargs)


def _map_state(fn, kind, state):
    """``fn`` applied to every ``kind`` leaf of an optimizer state: one
    such leaf, None, or a tuple or list of states (the reference's
    ``to_nd``, ``to_np`` and ``sync_state_context``)."""
    if isinstance(state, kind):
        return fn(state)
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(fn, kind, s) for s in state)
    return state


class Updater:
    """Per-index optimizer state, applied by ``updater(index, grad,
    weight)``; ``get_states``/``set_states`` serialize it."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        # set_states loads on the host: each state moves to its weight's
        # context at first use
        state = self.states[index] = _map_state(
            lambda s: s.as_in_context(weight.context), NDArray,
            self.states[index])
        self.optimizer.update(index, weight, grad, state)

    def get_states(self, dump_optimizer=False):
        states = {k: _map_state(NDArray.asnumpy, NDArray, v)
                  for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """Load what ``get_states`` wrote (pickle: only this program's
        own files) onto the host, whatever the current context."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        self.states = {k: _map_state(lambda a: array(a, ctx=cpu()),
                                     np.ndarray, v)
                       for k, v in states.items()}


def get_updater(optimizer):
    return Updater(optimizer)
