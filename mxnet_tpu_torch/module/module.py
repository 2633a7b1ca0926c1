"""Module: a Symbol trained through one Executor on one device.

Counterpart of ``mxnet_tpu/module/module.py``: bind (and ``reshape``,
which a batch of another shape triggers in ``forward``), init_params,
set_params / get_params, init_optimizer and ``borrow_optimizer``,
forward, backward, update, update_metric, get_outputs,
``get_input_grads``, ``get_states`` / ``set_states``, ``output_shapes``,
``install_monitor``, ``save_checkpoint`` and ``Module.load`` with the
optimizer's states (``prefix-%04d.states``, a file either package reads).
The context defaults to ``gpu(0)`` (and raises without a card) like every
entry point of the port, where MXNet's default is the CPU; pass
``context=cpu()`` to train on the host.  One device with
``kvstore='local'`` (or None) is ported; sharding plans and multi-device
stores are not.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..context import default_context
from ..executor import Executor
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import _create_kvstore, load_checkpoint, save_checkpoint
from ..ndarray import zeros
from .. import optimizer as opt
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


class Module(BaseModule):
    """Module over a Symbol."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module over %d devices is not yet ported"
                                 % len(context))
            context = context[0]
        self._context = [default_context(context)]
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        _check_input_names(symbol, self._state_names, "state", True)
        _check_input_names(symbol, self._fixed_param_names, "fixed_param",
                           True)
        inputs = self._data_names + self._label_names + self._state_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over checkpoint ``prefix``/``epoch``, its parameters
        set at ``bind`` and, with ``load_optimizer_states``, the
        optimizer's states from ``prefix-%04d.states`` at
        ``init_optimizer``; ``kwargs`` go to the constructor."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json`` + ``prefix-%04d.params`` (+
        ``prefix-%04d.states``), readable by either package."""
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, self._arg_params,
                        self._aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        """[(output name, shape)] at the bound shapes."""
        assert self.binded
        shapes = {d.name: d.shape
                  for d in self._data_shapes + (self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self._output_names, [tuple(s) for s in out_shapes]))

    # -- parameters -------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Each parameter and aux state from ``arg_params``/``aux_params``
        where given, else from ``initializer`` (by name)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                if cache[name] is not arr:
                    arr[:] = cache[name]
            elif cache is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name, {})), arr)

        for name in self._param_names:
            _impl(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            _impl(name, self._exec.aux_dict[name], aux_params)
        self.params_initialized = True
        self._params_dirty = True
        self._sync_params_from_devices()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def _sync_params_from_devices(self):
        if self._exec is None:
            return
        self._arg_params = {n: self._exec.arg_dict[n].copy()
                            for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n].copy()
                            for n in self._aux_names}
        self._params_dirty = False

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """One executor with zero-filled arrays of the inferred shapes;
        gradients for the parameters (and the data with
        inputs_need_grad) when training.  Parameters the module already
        holds (``Module.load``, ``reshape``), or ``shared_module``'s with
        its optimizer, are copied in."""
        if force_rebind:
            self.binded = False
            self._exec = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert for_training or not inputs_need_grad
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = None if label_shapes is None else [
            d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in label_shapes]
        shapes = {d.name: d.shape
                  for d in self._data_shapes + (self._label_shapes or [])}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        ctx = self._context[0]
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or name in self._state_names \
                    or name in self._fixed_param_names:
                req[name] = "null"
            else:
                req[name] = grad_req if for_training else "null"
        args = {n: zeros(s, ctx) for n, s in
                zip(self._symbol.list_arguments(), arg_shapes)}
        aux = {n: zeros(s, ctx) for n, s in zip(self._aux_names, aux_shapes)}
        self._exec = Executor(self._symbol, ctx, args, None, req, aux)
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
        elif self._arg_params is not None:
            # parameters preloaded (Module.load) or kept by reshape
            self.params_initialized = True
            for name in self._param_names:
                if name in self._arg_params:
                    self._exec.arg_dict[name][:] = self._arg_params[name]
            for name in self._aux_names:
                if name in self._aux_params:
                    self._exec.aux_dict[name][:] = self._aux_params[name]

    def reshape(self, data_shapes, label_shapes=None):
        """Bind anew for other input shapes; ``bind`` copies the
        parameters back in."""
        assert self.binded
        if self.params_initialized and self._params_dirty:
            self._sync_params_from_devices()
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """The optimizer and its updater; ``rescale_grad`` defaults to
        1/batch, so the loss heads' summed gradients become means."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        _create_kvstore(kvstore, len(self._context), self._exec.arg_dict)
        rescale_grad = 1.0 / self._data_shapes[0].shape[0]
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not optimizer.idx2name:
            optimizer.idx2name = idx2name
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share ``shared_module``'s optimizer and updater (its states)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    def save_optimizer_states(self, fname):
        """The updater's states, pickled as numpy arrays (either package
        reads them)."""
        assert self.optimizer_initialized
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        """States that ``save_optimizer_states`` (of either package)
        wrote; pickle, so only files of a trusted source."""
        assert self.optimizer_initialized
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def install_monitor(self, mon):
        """Let Monitor ``mon`` see the executor's outputs (and inputs)."""
        assert self.binded
        mon.install(self._exec)

    # -- computation ------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Run the executor on ``data_batch``; a batch of other shapes
        re-binds first (``reshape``)."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        new_shapes = [tuple(d.shape) for d in data_batch.data]
        if [tuple(d.shape) for d in self._data_shapes] != new_shapes:
            dshapes = [DataDesc(d.name, s, d.dtype, d.layout)
                       for d, s in zip(self._data_shapes, new_shapes)]
            lshapes = None
            if data_batch.label is not None and self._label_shapes:
                lshapes = [DataDesc(d.name, tuple(l.shape), d.dtype,
                                    d.layout)
                           for d, l in zip(self._label_shapes,
                                           data_batch.label)]
            self.reshape(dshapes, lshapes)
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_shapes and data_batch.label is not None:
            feed.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feed)
        self._params_dirty = True

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """Apply the optimizer to every parameter's gradient: the
        training step's ``optimizer`` phase and the profiler's
        ``update`` span."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        from .. import profiler
        from ..telemetry import step as step_mod
        self._params_dirty = True
        with step_mod.active_phase("optimizer"), \
                profiler.record_span("update", "update"):
            self._update_impl()

    def _update_impl(self):
        for idx, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is not None:
                self._updater(idx, grad, self._exec.arg_dict[name])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        """The gradients of the data inputs (``bind(inputs_need_grad=
        True)``)."""
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def get_states(self, merge_multi_context=True):
        """The state inputs (``state_names``)."""
        assert self.binded and self.params_initialized
        return [self._exec.arg_dict[n] for n in self._state_names]

    def set_states(self, states=None, value=None):
        """Set the state inputs to ``states`` (NDArrays, or lists whose
        first entry is one) or fill them with ``value``."""
        assert self.binded and self.params_initialized
        for i, name in enumerate(self._state_names):
            dst = self._exec.arg_dict[name]
            if states is not None:
                src = states[i]
                dst[:] = src[0] if isinstance(src, (list, tuple)) else src
            else:
                dst[:] = float(value)

    def update_metric(self, eval_metric, labels):
        preds = dict(zip(self._output_names, self.get_outputs()))
        eval_metric.update_dict(dict(zip(self._label_names, labels or [])),
                                preds)
