"""Gluon Trainer: an Optimizer applied to a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py``.  On one device the store
is ``model._create_kvstore``'s answer for ``"device"`` (none: each
parameter is updated where it lies); a ``dist`` store raises there, as it
does for ``Module``.  ``step`` rescales the gradients by 1/batch_size and
runs the optimizer's in-place update on each parameter's array, so the
array stays the autograd variable the next recorded forward reaches.
Each Parameter's ``lr_mult`` and ``wd_mult`` apply (the optimizer's
``param_dict``).  With telemetry on, ``step`` is the ``optimizer`` phase
of the ambient training step, or, called outside one, a step of its own
on the ``loop="trainer"`` series.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..model import _create_kvstore
from .parameter import ParameterDict, Parameter

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % (type(params)))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % (type(param)))
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = optimizer_params.get("rescale_grad", 1.0)
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_initialized = False
        self._kvstore = kvstore

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _init_kvstore(self):
        arg_arrays = {param.name: param.data() for param in self._params}
        self._kvstore_obj, _ = _create_kvstore(self._kvstore, 1, arg_arrays)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter whose grad_req is not
        null, the gradients scaled by 1/batch_size."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        from ..telemetry import step as step_mod
        with step_mod.ensure_step("trainer"), \
                step_mod.active_phase("optimizer"):
            for i, param in enumerate(self._params):
                if param.grad_req == "null":
                    continue
                self._updaters[0](i, param.grad(), param.data())

    def save_states(self, fname):
        """The optimizer and its per-parameter states, as the Updater
        writes them."""
        with open(fname, "wb") as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            states = f.read()
        # the states load; the optimizer stays this trainer's, as in the
        # reference
        self._updaters[0].set_states(states)
        self._updaters[0].optimizer = self._optimizer
