"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``InitDesc``, the
``Initializer.__call__`` dispatch on the parameter's name (``*weight``,
``*bias`` -> 0, ``*gamma`` -> 1, ``*beta`` -> 0, ``*moving_mean`` -> 0,
``*moving_var`` -> 1, ...) and Zero, One, Constant, Uniform, Normal,
Xavier, MSRAPrelu, Orthogonal, Bilinear, LSTMBias, FusedRNN, Load and
Mixed, and ``dumps`` (the JSON a variable's ``init=`` keeps).  Random
draws come from the explicit generator of the array's device
(``random.generator``), never from a global stream.  Orthogonal takes the
SVD of its draw in float64 on the host, as the reference does; the
deterministic initializers compute in numpy as the reference does.
"""
from __future__ import annotations

import json
import logging
import math
import re

import numpy as np
import torch

from .base import MXNetError
from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "Load", "Mixed", "FusedRNN", "register", "create"]

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
    if isinstance(name, Initializer) or callable(name):
        return name
    if name.startswith("["):
        # a variable's __init__ attr: [name, kwargs] as JSON
        klass, kw = json.loads(name)
        return _INIT_REGISTRY[klass.lower()](**kw)
    if name.lower() not in _INIT_REGISTRY:
        raise MXNetError("unknown initializer %r" % name)
    return _INIT_REGISTRY[name.lower()](**kwargs)


def _draw_shape(arr, shape, fill):
    """A float32 tensor of ``shape`` on arr's device, filled in place by
    ``fill(tensor, generator)`` from the device's generator."""
    t = torch.empty(shape, dtype=torch.float32, device=arr._data.device)
    fill(t, _random.generator(arr.context))
    return t


def _draw(arr, fill):
    """``_draw_shape`` of arr's own shape."""
    return _draw_shape(arr, arr.shape, fill)


class Initializer:
    """Base initializer: dispatch on the parameter's name.  ``kwargs``
    are the constructor's arguments, which ``dumps`` serializes."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``[name, kwargs]`` as JSON, the reference's form (a variable's
        ``__init__`` attribute; ``create`` reads it back)."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

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
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = float(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        arr[:] = _draw(arr, lambda t, g: t.uniform_(-self.scale, self.scale,
                                                    generator=g))


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        arr[:] = _draw(arr, lambda t, g: t.normal_(0.0, self.sigma,
                                                   generator=g))


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale by fan-in/out, as the reference computes them
    from the weight's shape."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
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


@register
class MSRAPrelu(Xavier):
    """He (MSRA) initialization for PReLU units of negative slope
    ``slope``: Gaussian Xavier with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2. / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """``scale`` times an orthogonal matrix: a singular-vector factor of a
    (nout, prod(rest)) draw from U(-1, 1) or N(0, 1) (``rand_type``), the
    SVD taken in float64 on the host as the reference takes it."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _noise(self, arr, shape):
        """The draw, on arr's device."""
        if self.rand_type == "uniform":
            return _draw_shape(arr, shape, lambda t, g: t.uniform_(
                -1.0, 1.0, generator=g))
        return _draw_shape(arr, shape, lambda t, g: t.normal_(
            0.0, 1.0, generator=g))

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        tmp = self._noise(arr, (nout, nin)).double().cpu().numpy()
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * res.reshape(arr.shape)).astype(np.float32)


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a deconvolution: weight (.., ..,
    h, w) at (y, x) = (1 - |x / f - c|) (1 - |y / f - c|), f = ceil(w /
    2), c = (2f - 1 - f % 2) / 2f, in float64 as the reference computes
    it."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        arr[:] = weight.astype(np.float32).reshape(shape)


@register
class LSTMBias(Initializer):
    """An LSTM's bias: ``forget_bias`` on the forget gate (the second of
    the four gates), 0 elsewhere."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        num_hidden = int(arr.shape[0] / 4)
        arr[:] = 0.0
        arr[num_hidden:2 * num_hidden] = float(self.forget_bias)


@register
class FusedRNN(Initializer):
    """The packed blob of a fused RNN cell: unpacked into its per-gate
    weights and biases (``rnn.FusedRNNCell.unpack_weights``), each drawn by
    ``init`` (an initializer or its JSON; the global initializer when
    None), the LSTM's forget-gate biases set to ``forget_bias``, then
    packed back."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(self._num_hidden, self._num_layers,
                                     self._mode, self._bidirectional,
                                     forget_bias=self._forget_bias,
                                     prefix="")
        args = cell.unpack_weights({cell._parameter.name: arr})
        for name, piece in args.items():
            if self._mode == "lstm" and name.endswith("_f_bias"):
                piece[:] = self._forget_bias
            elif self._init is None:
                desc.global_init(InitDesc(name, global_init=desc.global_init),
                                 piece)
            else:
                self._init(InitDesc(name, global_init=desc.global_init),
                           piece)
        arr[:] = cell.pack_weights(args)[cell._parameter.name]


@register
class Load:
    """Parameters from a dict or a ``.params`` file (``arg:``/``aux:``
    prefixes dropped), shapes checked; names it lacks go to
    ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .context import cpu
            from .ndarray import load
            param = load(param, ctx=cpu())
        self.param = {(name[4:] if name.startswith(("arg:", "aux:"))
                       else name): arr for name, arr in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if arr.shape != self.param[name].shape:
                raise ValueError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, str(arr.shape), str(self.param[name].shape)))
            arr[:] = self.param[name]
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise ValueError(
                    "Cannot Initialize parameter %s. Not found in loaded "
                    "param and no default initialization is provided."
                    % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


@register
class Mixed:
    """The first initializer whose regex pattern matches the name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have the same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Consider adding a "
            "\".*\" pattern at the and with default Initializer." % name)
