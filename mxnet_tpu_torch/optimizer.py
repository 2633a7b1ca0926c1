"""Optimizers and the Updater.

Counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base (lr,
wd, ``rescale_grad``, ``clip_gradient``, per-parameter ``lr_mult`` and
``wd_mult`` resolved through ``idx2name``, ``register``/``create``), the
reference's sixteen optimizers on dense gradients (SGD with a float32
master copy of float16 weights under ``multi_precision``, ccSGD, SignSGD,
Signum, DCASGD, NAG, SGLD, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl,
Adamax, Nadam and Test), and ``Updater`` / ``get_updater``.  SGD, Adam,
RMSProp, Ftrl, SignSGD and Signum run the in-place update ops
(``ops/optimizer_ops.py``); the others are torch arithmetic on the
weight's tensor, in the reference's order, in place.  Every state lies on
its weight's device in its weight's dtype, and SGLD draws its noise from
the explicit generator of the weight's device (``random.generator``).  A
learning-rate scheduler (``lr_scheduler.py``) gives the rate of every
update from ``num_update``, the largest update count of any index, which
starts at ``begin_num_update``.  ``Updater.get_states`` pickles the states
as numpy arrays, the JAX package's format, so a state file written by
either package loads in the other.  Row-sparse gradients are not yet
ported.
"""
from __future__ import annotations

import logging
import math
import pickle

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from . import random as _random
from .ndarray import (NDArray, array, zeros, zeros_like, sgd_update,
                      sgd_mom_update, mp_sgd_update, mp_sgd_mom_update,
                      adam_update, rmsprop_update, rmspropalex_update,
                      ftrl_update, signsgd_update, signum_update)

__all__ = ["Optimizer", "SGD", "DCASGD", "NAG", "SGLD", "ccSGD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam",
           "Signum", "SignSGD", "Test", "Updater", "get_updater", "create",
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
                 sym=None, begin_num_update=0, param_dict=None):
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
        # Gluon's Trainer: {index: Parameter}, whose lr_mult and wd_mult
        # come before every other multiplier
        self.param_dict = dict(param_dict or {})
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

    def _multiplier(self, index, table, param_attr):
        if index in self.param_dict:
            return getattr(self.param_dict[index], param_attr)
        if index in table:
            return table[index]
        name = self.idx2name.get(index)
        return table.get(name, 1.0) if name is not None else 1.0

    def _get_lr(self, index):
        """The rate of ``index``'s update: the scheduler's at
        ``num_update`` (else ``lr``) times its multiplier."""
        base = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
        return base * self._multiplier(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._multiplier(index, self.wd_mult, "wd_mult")

    def _common_attrs(self, index):
        a = {"lr": self._get_lr(index), "wd": self._get_wd(index),
             "rescale_grad": self.rescale_grad}
        if self.clip_gradient:
            a["clip_gradient"] = self.clip_gradient
        return a

    def __getstate__(self):
        # the symbol and Gluon's Parameters stay with the program; a
        # Trainer that loads states gives its Parameters back
        d = self.__dict__.copy()
        d.pop("sym", None)
        d.pop("param_dict", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.sym = None
        self.param_dict = {}


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
        _dense(grad)
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


def _dense(grad):
    """Refuse a row-sparse gradient: the reference's lazy row updates are
    not yet ported."""
    if getattr(grad, "stype", "default") != "default":
        raise MXNetError("optimizer: %s gradients are not yet ported (dense "
                         "gradients only)" % grad.stype)


def _scaled_grad(opt, grad):
    """clip(rescale_grad * grad) as a tensor, the preamble of the
    optimizers written in torch arithmetic (clipped where
    ``clip_gradient`` is not None)."""
    _dense(grad)
    g = grad._data * opt.rescale_grad
    if opt.clip_gradient is not None:
        g = torch.clamp(g, -opt.clip_gradient, opt.clip_gradient)
    return g


@register
class SignSGD(Optimizer):
    """The sign of the gradient (``signsgd_update``)."""

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        signsgd_update(weight, grad, out=weight, **self._common_attrs(index))


@register
class Signum(Optimizer):
    """The sign of the momentum (``signum_update``); SignSGD's update
    without momentum."""

    def __init__(self, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return zeros_like(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        kwargs = self._common_attrs(index)
        if state is None:
            signsgd_update(weight, grad, out=weight, **kwargs)
            return
        if self.wd_lh:
            kwargs["wd_lh"] = self.wd_lh
        signum_update(weight, grad, state, out=weight,
                      momentum=self.momentum, **kwargs)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; its state is (momentum or None,
    the previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = zeros_like(weight) if self.momentum != 0.0 else None
        return (mom, weight.copy())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _scaled_grad(self, grad)
        mom, previous = state
        w, prev = weight._data, previous._data
        delta = -lr * (g + wd * w + self.lamda * g * g * (w - prev))
        if mom is not None:
            mom._data.mul_(self.momentum).add_(delta)
            delta = mom._data
        prev.copy_(w)
        w.add_(delta)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return zeros_like(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _scaled_grad(self, grad)
        w = weight._data
        if state is None:
            w.add_(-lr * (g + wd * w))
            return
        mom = state._data
        mom.mul_(self.momentum)
        g = g + wd * w
        mom.add_(g)
        g = g + self.momentum * mom
        w.add_(-lr * g)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half a gradient step plus
    N(0, lr) noise, drawn from the weight device's generator."""

    def _noise(self, weight, lr):
        t = torch.empty_like(weight._data)
        return t.normal_(0.0, math.sqrt(lr),
                         generator=_random.generator(weight.context))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _scaled_grad(self, grad)
        w = weight._data
        w.add_(-lr / 2 * (g + wd * w) + self._noise(weight, lr))


@register
class ccSGD(SGD):
    """The reference's alias of SGD."""


@register
class Adam(Optimizer):
    """Adam (``adam_update``), its bias correction folded into the rate:
    lr * sqrt(1 - beta2^t) / (1 - beta1^t) at the index's update t."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))   # mean, var

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        t = self._index_update_count[index]
        kwargs = self._common_attrs(index)
        kwargs["lr"] *= math.sqrt(1. - self.beta2 ** t) / (1. - self.beta1
                                                          ** t)
        mean, var = state
        adam_update(weight, grad, mean, var, out=weight, beta1=self.beta1,
                    beta2=self.beta2, epsilon=self.epsilon, **kwargs)


@register
class AdaGrad(Optimizer):
    """AdaGrad: the step over the root of the squared gradients' sum."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return zeros_like(weight)   # history

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _scaled_grad(self, grad)
        history, w = state._data, weight._data
        history.add_(g * g)
        div = g / torch.sqrt(history + self.float_stable_eps)
        w.add_((div + w * wd) * -lr)


@register
class RMSProp(Optimizer):
    """RMSProp: Tieleman and Hinton's (``rmsprop_update``), or Graves'
    centered form (``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return tuple(zeros_like(weight) for _ in range(3))  # n, g, delta
        return zeros_like(weight)   # n

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        kwargs = self._common_attrs(index)
        kwargs.update(gamma1=self.gamma1, epsilon=self.epsilon)
        if self.clip_weights:
            kwargs["clip_weights"] = self.clip_weights
        if self.centered:
            rmspropalex_update(weight, grad, *state, out=weight,
                               gamma2=self.gamma2, **kwargs)
        else:
            rmsprop_update(weight, grad, state, out=weight, **kwargs)


@register
class AdaDelta(Optimizer):
    """AdaDelta; its state is (accumulated g^2, accumulated delta^2)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = _scaled_grad(self, grad)
        acc_g, acc_delta = (s._data for s in state)
        w = weight._data
        acc_g.copy_(self.rho * acc_g + (1. - self.rho) * g * g)
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(acc_g + self.epsilon)) * g
        acc_delta.copy_(self.rho * acc_delta
                        + (1. - self.rho) * delta * delta)
        w.sub_(delta + wd * w)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_update``); its state is (z, n)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))

    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        z, n = state
        ftrl_update(weight, grad, z, n, out=weight, lamda1=self.lamda1,
                    beta=self.beta, **self._common_attrs(index))


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))   # mean, variance

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        w = weight._data
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m, u = (s._data for s in state)
        m.copy_(self.beta1 * m + (1. - self.beta1) * g)
        u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
        w.sub_(lr * m / (u + 1e-8))


@register
class Nadam(Optimizer):
    """Nesterov Adam, with the momentum schedule of Dozat (2016)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (zeros_like(weight), zeros_like(weight))   # mean, variance

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1. - 0.5 * (pow(0.96, t * self
                                                    .schedule_decay)))
        momentum_t_1 = self.beta1 * (1. - 0.5 * (pow(
            0.96, (t + 1) * self.schedule_decay)))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = (s._data for s in state)
        m.copy_(self.beta1 * m + (1. - self.beta1) * g)
        v.copy_(self.beta2 * v + (1. - self.beta2) * g * g)
        grad_prime = g / (1. - self.m_schedule)
        m_prime = m / (1. - m_schedule_next)
        v_prime = v / (1. - pow(self.beta2, t))
        m_bar = (1. - momentum_t) * grad_prime + momentum_t_1 * m_prime
        w.sub_(lr * m_bar / (torch.sqrt(v_prime) + self.epsilon))


@register
class Test(Optimizer):
    """The reference's test optimizer: weight += rescale_grad * grad, and
    the state holds the new weight."""

    def create_state(self, index, weight):
        return zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight._data.add_(grad._data * self.rescale_grad)
        state._data.copy_(weight._data)


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
