"""Modules written in Python: host computation in the Module training
loop, with no symbol and no executor.

Counterpart of ``mxnet_tpu/module/python_module.py``: ``PythonModule``,
the base of parameterless stages, and ``PythonLossModule``, an identity
forward whose backward is ``grad_func(scores, labels)``, by default the
softmax cross-entropy gradient ``p - onehot(label)`` of softmax scores
(computed on the scores' device).  As in the reference,
``install_monitor`` is a no-op, so a Python stage inside a monitored
SequentialModule does not stop the chain.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import ndarray as nd
from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Base of parameterless host-side modules: subclasses implement
    ``forward``, ``backward`` and ``_compute_output_shapes``."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

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
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        pass

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("%s already bound", type(self).__name__)
            return
        got = [d[0] for d in data_shapes]
        if got != self._data_names:
            raise MXNetError("%s expects data %s, got %s"
                             % (type(self).__name__, self._data_names, got))
        if label_shapes is not None and \
                len(label_shapes) != len(self._label_names):
            raise MXNetError("%s expects %d labels, got %d"
                             % (type(self).__name__, len(self._label_names),
                                len(label_shapes)))
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """[(name, shape)] of the outputs at the bound input shapes."""
        raise NotImplementedError


def _softmax_ce_grad(scores, labels):
    """The default loss gradient: ``scores`` softmax probabilities,
    ``labels`` class indices; d(sum CE)/d(scores) = p - onehot."""
    if isinstance(scores, nd.NDArray):
        p = scores._data.detach()
        lab = labels._data if isinstance(labels, nd.NDArray) \
            else torch.as_tensor(np.asarray(labels))
        onehot = torch.nn.functional.one_hot(
            lab.to(p.device).long(), p.shape[-1]).to(p.dtype)
        return nd.NDArray(p - onehot)
    p = np.asarray(scores)
    onehot = np.eye(p.shape[-1], dtype=p.dtype)[
        np.asarray(labels).astype(int)]
    return p - onehot


class PythonLossModule(PythonModule):
    """Identity forward and a loss gradient as backward."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        if len(data_names) != 1 or len(label_names) != 1:
            raise MXNetError("PythonLossModule is single-input/single-label")
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func or _softmax_ce_grad
        self._scores = None
        self._labels = None
        self._grad = None

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train if is_train is not None else self.for_training:
            self._labels = data_batch.label[0] if data_batch.label else None

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("a loss module defines its own gradient; "
                             "out_grads must be None")
        assert self.for_training
        g = self._grad_func(self._scores, self._labels)
        self._grad = g if isinstance(g, nd.NDArray) else nd.array(
            g, ctx=self._scores.context)

    def get_input_grads(self, merge_multi_context=True):
        return [self._grad]
