"""Gluon Parameter, Constant and ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py``.  A Parameter holds one
NDArray on one context (the card unless the caller names another) and,
unless its grad_req is null, a gradient NDArray; its data is an autograd
variable (``autograd.mark_variables``), so a recorded forward that reads
it gets its gradient.  Shapes with 0 (or None) defer initialization to
the first forward, which infers them.  Every later change of the value
(``set_data``, ``load``, an optimizer step) writes into the same tensor,
so the variable stays the one the recorded graph reaches.  ``save`` and
``load`` use the ``.npz`` files of ``ndarray.save``/``load``, which the
JAX package reads and writes too.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..base import MXNetError
from .. import ndarray as nd
from ..context import cpu, current_context
from ..initializer import InitDesc
from .. import initializer as init_mod
from ..ops.registry import torch_dtype

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization."""


class Parameter:
    """A container holding a Block's parameter (weights) and its gradient.

    grad_req: 'write' | 'add' | 'null'.  Shape entries of 0 (or None)
    defer initialization until the first forward infers them.
    """

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self._var = None
        self._data = None
        self._grad = None
        self._deferred_init = ()
        self.name = name
        self._differentiable = differentiable
        if not differentiable:
            grad_req = "null"
        self._grad_req = None
        self.grad_req = grad_req
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._stype = stype
        self._grad_stype = grad_stype

    def __repr__(self):
        return "Parameter {name} (shape={shape}, dtype={dtype})".format(
            name=self.name, shape=self.shape, dtype=self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be one of 'write', 'add', or "
                             "'null', but got %s" % req)
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._data = self._data._data.detach()
        elif self._data is not None:
            self._init_grad()

    def _check_and_get(self, arr, ctx):
        if arr is not None:
            return arr
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass. Please pass one batch of "
                "data through the network before accessing Parameters."
                % self.name)
        raise RuntimeError(
            "Parameter %s has not been initialized. Note that you should "
            "initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks"
            % self.name)

    def _load_init(self, data, ctx):
        """Take ``data`` (an NDArray) as this parameter's value: its first
        value when not initialized yet (on ``ctx``, else on
        ``current_context()``), else written into the existing array."""
        if self.shape:
            for self_dim, data_dim in zip(self.shape, data.shape):
                if self_dim not in (0, data_dim):
                    raise MXNetError(
                        "Failed loading Parameter %s from saved params: "
                        "shape incompatible expected %s vs saved %s"
                        % (self.name, str(self.shape), str(data.shape)))
        if self.dtype is not None \
                and torch_dtype(self.dtype) != data.dtype:
            data = data.astype(self.dtype)
        if self._data is None:
            self._deferred_init = ()
            if isinstance(ctx, (list, tuple)):
                ctx = ctx[0]
            self._init_impl(data.copyto(ctx or current_context()))
        else:
            self.set_data(data)

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        self._deferred_init = ()
        if self.shape is None or not np.prod(self.shape) > 0:
            raise MXNetError("Cannot initialize Parameter %s because it has "
                             "invalid shape: %s." % (self.name,
                                                     str(self.shape)))
        data = nd.zeros(self.shape, dtype=self.dtype, ctx=ctx)
        # the resolved initializer applies directly: Gluon's parameters
        # carry their own (bias 'zeros', gamma 'ones'), so the name dispatch
        # of the Module path must not run here
        initializer = init_mod.create(init if init is not None
                                      else default_init)
        if isinstance(initializer, init_mod.Initializer):
            initializer._init_weight(InitDesc(self.name, {}), data)
        else:
            initializer(InitDesc(self.name, {}), data)
        self._init_impl(data)

    def _init_impl(self, data):
        self._data = data if isinstance(data, nd.NDArray) else nd.array(data)
        if self.shape is None or 0 in self.shape:
            self.shape = self._data.shape
        if self._grad_req != "null":
            self._init_grad()

    def _init_grad(self):
        self._grad = nd.zeros(self._data.shape, dtype=self._data.dtype,
                              ctx=self._data.context)
        from .. import autograd
        autograd.mark_variables([self._data], [self._grad],
                                grad_reqs=self._grad_req)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Make the data (and gradient) on ``ctx``, else on
        ``current_context()``; deferred while the shape is unknown."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        if init is None:
            init = default_init if self.init is None else self.init
        if self.shape is None or np.prod(self.shape) <= 0:
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError("Cannot initialize Parameter %s because it has "
                             "invalid shape: %s." % (self.name,
                                                     str(self.shape)))
        self._deferred_init = (init, ctx, default_init)
        self._finish_deferred_init()

    def reset_ctx(self, ctx):
        if self._data is not None:
            data = self._data.as_in_context(
                ctx[0] if isinstance(ctx, (list, tuple)) else ctx)
            if data is not self._data:
                self._init_impl(data.detach())

    def set_data(self, data):
        """Write ``data`` (an NDArray, a numpy array or a number) into this
        parameter's array, in place."""
        if self._data is None:
            raise MXNetError("Parameter %s has not been initialized"
                             % self.name)
        from .. import autograd
        with autograd.pause():
            self._data[:] = data

    def data(self, ctx=None):
        """The parameter's NDArray."""
        return self._check_and_get(self._data, ctx)

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter %s because "
                "grad_req='null'" % self.name)
        return self._check_and_get(self._grad, ctx)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return [self._deferred_init[1]]
            raise RuntimeError("Parameter %s has not been initialized"
                               % self.name)
        return [self._data.context]

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def var(self):
        """This parameter as a symbol variable (for hybridize).  A shape
        with unknown (0) dims is left out: the op's shape fill completes
        it from the data."""
        from .. import symbol
        if self._var is None:
            shape = self.shape
            if shape is not None and 0 in shape:
                shape = None
            self._var = symbol.var(
                self.name, shape=shape, dtype=self.dtype,
                lr_mult=self.lr_mult, wd_mult=self.wd_mult,
                init=self.init if isinstance(self.init, str) else None)
        return self._var

    def cast(self, dtype):
        """Cast the data and gradient to ``dtype``; the cast data is the
        variable from now on."""
        self.dtype = dtype
        if self._data is None:
            return
        from .. import autograd
        with autograd.pause():
            self._data = self._data.astype(dtype).detach()
            if self._grad is not None:
                self._init_grad()


class Constant(Parameter):
    """A constant parameter: grad_req null, initialized to ``value`` (kept
    on the host until then)."""

    def __init__(self, name, value):
        if not isinstance(value, nd.NDArray):
            value = nd.array(value, ctx=cpu())
        self.value = value

        class Init(init_mod.Initializer):
            def _init_weight(self, _, arr):
                arr[:] = value
        init_name = "Constant_{}_{}".format(name, id(self))
        init_mod._INIT_REGISTRY[init_name.lower()] = Init
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=init_name)


class ParameterDict:
    """An ordered dictionary of Parameters named under ``prefix``; one
    given as ``shared`` lends its Parameters by name."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{name}(\n{content}\n)".format(name=name, content="\n".join(
            [repr(v).replace("\n", "\n  ") for v in self.values()]))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The Parameter named prefix + ``name``, made with ``kwargs`` if
        there is none; an existing one must agree with them (a 0 dim of a
        shape is filled by the other's)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
                continue
            if k == "shape" and v is not None and len(v) == len(existing):
                merged = []
                for d1, d2 in zip(v, existing):
                    if d1 != d2 and d1 * d2 != 0:
                        break
                    merged.append(d1 or d2)
                else:
                    param.shape = tuple(merged)
                    continue
            if v is not None and v != existing:
                raise MXNetError(
                    "Cannot retrieve Parameter %s because desired attribute "
                    "does not match with stored for attribute %s: desired "
                    "%s vs stored %s." % (name, k, str(v), str(existing)))
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '{}'. Please specify value "
                               "if you want to create a new constant."
                               .format(name))
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None and not isinstance(param, Constant):
            raise MXNetError("Parameter '{}' already exists but it is not a "
                             "constant.".format(name))
        return param

    def update(self, other):
        """Copy all Parameters in ``other`` into self."""
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise MXNetError(
                        "Cannot update self with other because they have "
                        "different Parameters with the same name '%s'" % k)
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter on ``ctx``, else on
        ``current_context()``, with its own initializer, else ``init``."""
        if init is None:
            init = init_mod.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with '%s'"
                    % (strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Values from a file ``save`` (of either package) wrote: written
        into each initialized Parameter's array, and onto ``ctx`` (else
        ``current_context()``) for one not initialized yet."""
        for name in self.keys():
            if not name.startswith(restore_prefix):
                raise MXNetError("restore_prefix is '%s' but Parameter name "
                                 "'%s' does not start with it"
                                 % (restore_prefix, name))
        lprefix = len(restore_prefix)
        loaded = nd.load(filename, ctx=cpu())
        arg_dict = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter '%s' is missing in file '%s'"
                                     % (name[lprefix:], filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in ParameterDict" % (name[lprefix:], filename))
                continue
            self[name]._load_init(value, ctx)
