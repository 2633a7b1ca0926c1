"""Gluon Block, HybridBlock and SymbolBlock.

Counterpart of ``mxnet_tpu/gluon/block.py``.  A Block runs its
``forward`` eagerly on NDArrays (each op through ``ndarray.invoke``,
recorded under ``autograd.record()``).  ``hybridize()`` makes a
HybridBlock trace ``hybrid_forward`` once with symbols and run the symbol
through a ``CachedOp`` from then on: the same registry ops in the same
order, so a hybridized block gives the imperative one's results bit for
bit.  A SymbolBlock runs a given symbol (a model-zoo network's, a
checkpoint's, or the fused symbolic ResNet's) the same way.
"""
from __future__ import annotations

import copy
import re
import threading

from ..base import MXNetError
from .. import ndarray as nd
from .. import symbol as sym_mod
from ..symbol import Symbol
from ..ndarray import NDArray
from .. import initializer as init_mod
from ..cached_op import CachedOp
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Naming scope for Blocks: children are named ``<hint><count>_``
    under their parent's prefix; a top-level block takes its prefix from
    the process-wide ``NameManager``."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """(prefix, params) for a new Block."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from ..base import NameManager
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from ..base import Prefix
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _flatten(args):
    if isinstance(args, (NDArray, Symbol)):
        return [args], 0
    if args is None:
        return [None], None
    if not isinstance(args, (list, tuple)):
        raise MXNetError("HybridBlock input must be (nested) list of Symbol "
                         "or NDArray, but got %s of type %s"
                         % (str(args), str(type(args))))
    flat, fmts = [], []
    for i in args:
        arg, fmt = _flatten(i)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    if fmt is None:
        return None, args[1:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


class Block:
    """Base class of every layer and model: a define-by-run container of
    Parameters and child Blocks."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []

    def __repr__(self):
        modstr = "\n".join(["  ({key}): {block}".format(
            key=key, block=repr(block).replace("\n", "\n  "))
            for key, block in self.__dict__.items()
            if isinstance(block, Block)])
        return "{name}(\n{modstr}\n)".format(name=self.__class__.__name__,
                                            modstr=modstr)

    def __setattr__(self, name, value):
        """Registers parameters and children."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError("Changing attribute type for {name} from "
                                "{type1} to {type2} is not allowed.".format(
                                    name=name, type1=type(existing),
                                    type2=type(value)))
            if isinstance(existing, Block) and isinstance(value, Block):
                self._children[self._children.index(existing)] = value
                super().__setattr__(name, value)
                return
        if isinstance(value, Block):
            self.register_child(value)
        super().__setattr__(name, value)

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """The naming scope of this block's children and parameters, for a
        ``with`` statement."""
        return self._scope

    @property
    def params(self):
        """This Block's own ParameterDict (no children; see
        collect_params)."""
        return self._params

    def collect_params(self, select=None):
        """Every Parameter of this Block and its children; with ``select``
        (a regular expression) only the names it matches."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret._params.update({name: value for name, value
                                in self.params.items()
                                if pattern.match(name)})
        for cld in self._children:
            child = cld.collect_params(select)
            if select is None:
                ret.update(child)
            else:
                ret._params.update(child._params)
        return ret

    def save_params(self, filename):
        """The parameters, named without this block's prefix, as an
        ``.npz`` file both packages read."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Parameters from a file ``save_params`` of either package
        wrote."""
        self.collect_params().load(filename, ctx, allow_missing, ignore_extra,
                                   self.prefix)

    def register_child(self, block):
        """Register a child block for parameter collection."""
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every Parameter on ``ctx``, else on
        ``current_context()`` (the card unless a ``with mt.cpu():`` scope
        is open)."""
        if init is None:
            init = init_mod.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True):
        """Turn hybridization on (off) in every HybridBlock child."""
        for cld in self._children:
            cld.hybridize(active)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        """Override to implement the computation."""
        raise NotImplementedError


class HybridBlock(Block):
    """A Block whose computation ``hybrid_forward(F, x, ...)`` runs on
    NDArrays (F = ``ndarray``) or builds a symbol (F = ``symbol``);
    ``hybridize()`` runs it through a CachedOp of that symbol."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._reg_params = {}
        self._cached_graph = ()
        self._cached_op = None
        self._cached_op_args = []
        self._out_format = None
        self._in_format = None
        self._active = False

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()
        if isinstance(value, Parameter):
            if isinstance(self._reg_params.get(name), Parameter):
                raise MXNetError(
                    "Overriding Parameter attribute %s is not allowed. If "
                    "you want to share parameters between blocks, please set "
                    "'params' at Block construction instead." % name)
            self._reg_params[name] = value

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s has "
                "type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block), str(type(block))))
        super().register_child(block)
        self._clear_cached_op()

    def hybridize(self, active=True):
        self._active = active
        self._clear_cached_op()
        super().hybridize(active)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None

    def _get_graph(self, *args):
        if not self._cached_graph:
            flat_args, self._in_format = _flatten(args)
            data = [sym_mod.var("data%d" % i) if len(flat_args) > 1
                    else sym_mod.var("data")
                    for i, _ in enumerate(flat_args)]
            grouped, _ = _regroup(data, self._in_format)
            params = {i: j.var() for i, j in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(sym_mod, *grouped, **params) \
                    if isinstance(grouped, list) else \
                    self.hybrid_forward(sym_mod, grouped, **params)
            flat_out, self._out_format = _flatten(out)
            self._cached_graph = data, (sym_mod.Group(flat_out)
                                        if len(flat_out) > 1 else flat_out[0])
        return self._cached_graph

    def infer_shape(self, *args):
        """Infer (and set) the parameters' shapes from the inputs'."""
        inputs, out = self._get_graph(*args)
        flat_args, _ = _flatten(args)
        arg_shapes, _, aux_shapes = out.infer_shape(
            **{i.name: j.shape for i, j in zip(inputs, flat_args)})
        sdict = dict(zip(out.list_arguments(), arg_shapes))
        sdict.update(zip(out.list_auxiliary_states(), aux_shapes))
        for p in self.collect_params().values():
            if p.name in sdict:
                p.shape = tuple(sdict[p.name])

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError("Deferred initialization failed because shape "
                             "cannot be inferred. {}".format(e)) from e

    def _build_cache(self, *args):
        inputs, out = self._get_graph(*args)
        self._cached_op = CachedOp(out)
        params = dict(self.collect_params().items())
        data_names = {d.name: i for i, d in enumerate(inputs)}
        # the CachedOp's inputs in its list_inputs order: data by position,
        # parameters by name (their arrays are read at each call)
        self._cached_op_args = [
            (True, data_names[name]) if name in data_names
            else (False, params[name])
            for name in self._cached_op.input_names]

    def _call_cached_op(self, *args):
        if self._cached_op is None:
            self._build_cache(*args)
        flat_args, fmt = _flatten(args)
        if fmt != self._in_format:
            raise MXNetError("Invalid input format")
        cargs = [flat_args[val] if is_data else val.data()
                 for is_data, val in self._cached_op_args]
        out = self._cached_op(*cargs)
        if isinstance(out, NDArray):
            out = [out]
        return _regroup(list(out), self._out_format)[0]

    def _finish_deferred(self, x, *args):
        self._deferred_infer_shape(x, *args)
        for p in self.collect_params().values():
            p._finish_deferred_init()

    def forward(self, x, *args):
        """``hybrid_forward`` with F = ``ndarray`` on NDArrays (through the
        CachedOp when hybridized), with F = ``symbol`` on Symbols."""
        if isinstance(x, NDArray):
            if self._active:
                try:
                    return self._call_cached_op(x, *args)
                except DeferredInitializationError:
                    self._finish_deferred(x, *args)
                    return self._call_cached_op(x, *args)
            try:
                params = {i: j.data() for i, j in self._reg_params.items()}
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                params = {i: j.data() for i, j in self._reg_params.items()}
            return self.hybrid_forward(nd, x, *args, **params)
        if not isinstance(x, Symbol):
            raise MXNetError("HybridBlock requires the first argument to "
                             "forward be either Symbol or NDArray, but got %s"
                             % type(x))
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(sym_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override to implement the computation; F is ``mt.nd`` or
        ``mt.sym``."""
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A block that runs ``outputs`` (a Symbol) on ``inputs`` (its input
    variables), always through a CachedOp; every other argument and aux
    state becomes a Parameter (aux states with grad_req null)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        syms, self._in_format = _flatten(inputs)
        flat_out, self._out_format = _flatten(outputs)
        out = sym_mod.Group(flat_out) if len(flat_out) > 1 else flat_out[0]
        input_names = set()
        for i in syms:
            if len(i.get_internals().list_outputs()) != 1:
                raise MXNetError("Input symbols must be variable, but %s is "
                                 "an output of operators" % str(i))
            input_names.add(i.name)
        for i in out.list_arguments():
            if i not in input_names:
                self.params.get(i, allow_deferred_init=True)
        for i in out.list_auxiliary_states():
            if i not in input_names:
                self.params.get(i, grad_req="null", allow_deferred_init=True)
        self._cached_graph = syms, out
        self._build_cache()

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                return self._call_cached_op(x, *args)
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                return self._call_cached_op(x, *args)
        if not isinstance(x, Symbol):
            raise MXNetError("HybridBlock requires the first argument to "
                             "forward be either Symbol or NDArray, but got %s"
                             % type(x))
        _args, in_fmt = _flatten([x] + list(args))
        if in_fmt != self._in_format:
            raise MXNetError("Invalid input format")
        return copy.copy(self._cached_graph[1])

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
