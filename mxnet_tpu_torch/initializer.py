"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``InitDesc``, the
``Initializer.__call__`` dispatch on the parameter's name (``*weight``,
``*bias`` -> 0, ``*gamma`` -> 1, ``*beta`` -> 0, ``*moving_mean`` -> 0,
``*moving_var`` -> 1, ...) and Zero, One, Constant, Uniform, Normal and
Xavier.  Random draws come from the explicit generator of the array's
device (``random.generator``), never from a global stream.
"""
from __future__ import annotations

import json
import math

import torch

from .base import MXNetError
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "register", "create"]

_INIT_REGISTRY = {}


class InitDesc(str):
    """A parameter name with its symbol attributes."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    """Register an initializer under its lower-case class name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if name.startswith("["):
        # a variable's __init__ attr: [name, kwargs] as JSON
        klass, kw = json.loads(name)
        return _INIT_REGISTRY[klass.lower()](**kw)
    if name.lower() not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[name.lower()](**kwargs)


def _draw(arr, fill):
    """A float32 tensor of arr's shape on arr's device, filled in place by
    ``fill(tensor, generator)``."""
    t = torch.empty(arr.shape, dtype=torch.float32, device=arr._data.device)
    fill(t, _random.generator(arr.context))
    return t


class Initializer:
    """Base initializer: dispatch on the parameter's name."""

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be an InitDesc or string")
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        if desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith(("bias", "beta", "min", "moving_mean",
                            "moving_inv_var", "moving_avg")):
            arr[:] = 0.0
        elif desc.endswith(("gamma", "max", "moving_var")):
            arr[:] = 1.0
        else:
            raise ValueError(
                "Unknown initialization pattern for %s. Default "
                "initialization is limited to \"weight\", \"bias\", "
                "\"gamma\" (1.0), and \"beta\" (0.0)." % desc)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = float(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _draw(arr, lambda t, g: t.uniform_(-self.scale, self.scale,
                                                    generator=g))


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _draw(arr, lambda t, g: t.normal_(0.0, self.sigma,
                                                   generator=g))


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale by fan-in/out, as the reference computes them
    from the weight's shape."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier initializer cannot be applied to vector "
                             "%s. It requires at least 2D." % name)
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr[:] = _draw(arr, lambda t, g: t.uniform_(-scale, scale,
                                                        generator=g))
        elif self.rnd_type == "gaussian":
            arr[:] = _draw(arr, lambda t, g: t.normal_(0.0, scale,
                                                       generator=g))
        else:
            raise ValueError("Unknown random type")
