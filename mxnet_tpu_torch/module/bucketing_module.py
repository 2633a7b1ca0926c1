"""BucketingModule: one Module per bucket, all sharing the parameters.

Counterpart of ``mxnet_tpu/module/bucketing_module.py``.  ``sym_gen(key)``
gives each bucket's symbol; its Module binds once, with the default
bucket's module as ``shared_module``, so each bucket key has exactly one
Executor.  The optimizer (and its states) is the current module's,
borrowed by the others; ``prepare`` binds the next batch's bucket ahead
and switches back; on every switch the parameters are copied from the
module that was current, as in the reference.  Each copy is an NDArray
copy on the modules' device (``Module.get_params``/``set_params``).
"""
from __future__ import annotations

import logging

from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """Parameter-sharing Modules keyed by bucket."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._fixed_param_names = fixed_param_names or []
        self._state_names = state_names or []
        self._context = context
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None
        self._grad_req = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            logging.warning("Parameters already initialized and "
                            "force_init=False. set_params call ignored.")
            return
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._params_dirty = False
        self.params_initialized = True

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        self._curr_module.set_states(states, value)

    def _module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._grad_req = grad_req
        module = self._module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it on first use
        (sharing the default bucket's parameters and optimizer), else
        copying the current parameters into it."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            module = self._module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key],
                        grad_req=self._grad_req)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        elif self.params_initialized:
            arg_params, aux_params = self.get_params()
            self._buckets[bucket_key].set_params(arg_params, aux_params)
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch):
        """Bind (or refresh) the module of ``data_batch``'s bucket ahead
        of its forward, then make the current bucket current again."""
        assert self.binded and self.params_initialized
        original_bucket_key = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module = self._buckets[original_bucket_key]
        self._curr_bucket_key = original_bucket_key

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if data_batch.bucket_key != self._curr_bucket_key:
            arg_params, aux_params = self.get_params()
            self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                               data_batch.provide_label)
            self._curr_module.set_params(arg_params, aux_params)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)
        self._params_dirty = True

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol and the current parameters (and the
        optimizer's states)."""
        from ..model import save_checkpoint as _save
        symbol = self._sym_gen(self._default_bucket_key)[0]
        arg_params, aux_params = self.get_params()
        _save(prefix, epoch, symbol, arg_params, aux_params)
        if save_optimizer_states:
            self._curr_module.save_optimizer_states(
                "%s-%04d.states" % (prefix, epoch))
