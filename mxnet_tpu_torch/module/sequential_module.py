"""SequentialModule: a chain of modules run as one, each stage's outputs
the next stage's inputs.

Counterpart of ``mxnet_tpu/module/sequential_module.py``:
``add(module, take_labels=..., auto_wiring=...)``; labels reach only the
stages that ask for them, inner stages bind with input gradients so the
backward pass chains, and two stages naming one parameter raise at
``init_params``.
"""
from __future__ import annotations

import collections
import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]

_Stage = collections.namedtuple("_Stage", ["module", "take_labels",
                                           "auto_wire"])


class SequentialModule(BaseModule):
    """A pipeline of modules executed in order."""

    # the reference's names of add()'s keywords
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []
        self._label_shapes = None

    def add(self, module, **meta):
        unknown = set(meta) - {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        if unknown:
            raise MXNetError("SequentialModule.add: unknown meta %s "
                             "(valid: take_labels, auto_wiring)"
                             % sorted(unknown))
        self._stages.append(_Stage(module,
                                   bool(meta.get(self.META_TAKE_LABELS)),
                                   bool(meta.get(self.META_AUTO_WIRING))))
        # a new stage invalidates any previous bind/init state
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # -- properties delegate to the ends of the chain ----------------------
    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._stages[-1].module.output_shapes

    # -- params ------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for st in self._stages:
            a, x = st.module.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "bind() must run before init_params()"
        for st in self._stages:
            st.module.init_params(initializer=initializer,
                                  arg_params=arg_params,
                                  aux_params=aux_params,
                                  allow_missing=allow_missing,
                                  force_init=force_init,
                                  allow_extra=allow_extra)
        self._raise_on_shadowed_params()
        self.params_initialized = True

    def _raise_on_shadowed_params(self):
        """Two stages naming the same parameter is almost certainly a bug
        (the dicts returned by get_params would silently merge them)."""
        owner = {}
        for i, st in enumerate(self._stages):
            for group in st.module.get_params():
                for name in group:
                    if name in owner:
                        raise MXNetError(
                            "parameter %r appears in stage %d and stage %d "
                            "of the SequentialModule; give the layers "
                            "distinct names" % (name, owner[name], i))
                    owner[name] = i

    # -- bind --------------------------------------------------------------
    def _wire(self, stage, shapes):
        """Rename incoming descriptors to the stage's expected input names
        when auto_wiring is on."""
        if not stage.auto_wire:
            return shapes
        names = stage.module.data_names
        if len(names) != len(shapes):
            raise MXNetError(
                "auto_wiring: stage expects %d inputs, got %d"
                % (len(names), len(shapes)))
        return [DataDesc(n, d.shape if isinstance(d, DataDesc) else d[1])
                for n, d in zip(names, shapes)]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("SequentialModule already bound")
            return
        if shared_module is not None:
            raise MXNetError("SequentialModule does not support "
                             "shared_module")
        if not self._stages:
            raise MXNetError("SequentialModule has no stages to bind")
        if inputs_need_grad:
            assert for_training

        chain_shapes = data_shapes
        labels_used = False
        for i, st in enumerate(self._stages):
            # inner stages must produce input grads so backward can chain
            need_grad = inputs_need_grad or (for_training and i > 0)
            st.module.bind(
                data_shapes=self._wire(st, chain_shapes),
                label_shapes=label_shapes if st.take_labels else None,
                for_training=for_training,
                inputs_need_grad=need_grad,
                force_rebind=force_rebind, grad_req=grad_req)
            labels_used |= st.take_labels
            chain_shapes = st.module.output_shapes

        self._label_shapes = label_shapes if labels_used else None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized")
            return
        for st in self._stages:
            st.module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                     optimizer_params=optimizer_params,
                                     force_init=force_init)
        self.optimizer_initialized = True

    # -- compute -----------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for i, st in enumerate(self._stages):
            st.module.forward(batch, is_train=is_train)
            if i + 1 == len(self._stages):
                break
            outs = st.module.get_outputs()
            batch = DataBatch(
                data=outs, label=data_batch.label, pad=data_batch.pad,
                index=data_batch.index,
                provide_data=[DataDesc(n, s)
                              for n, s in st.module.output_shapes],
                provide_label=data_batch.provide_label)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        grads = out_grads
        for i in range(len(self._stages) - 1, -1, -1):
            self._stages[i].module.backward(out_grads=grads)
            if i:
                grads = self._stages[i].module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for st in self._stages:
            st.module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._stages[-1].module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._stages[0].module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for st in self._stages:
            if st.take_labels:
                st.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for st in self._stages:
            st.module.install_monitor(mon)
