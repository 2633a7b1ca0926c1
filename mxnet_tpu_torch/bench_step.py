"""The repo's benchmark training step in the port.

Counterpart of ``train_step`` in ``bench.py`` (``_device_main``): a batch
of uint8 NHWC images is scaled into the parameters' dtype on the device,
``executor.build_graph_fn``'s training forward gives the softmax, the loss
is the mean negative log-likelihood of the labels (in f32), and each
parameter takes one SGD step ``p - lr * g`` in its own dtype.  The aux
states (BatchNorm's moving statistics, f32) come back updated.  The
scale and the learning rate are rounded to the parameters' dtype first,
as the reference's ``jnp.asarray(x, dtype)`` rounds them, so both
products round once, as the reference's do.

Where the JAX package compiles this step into one program, the port runs
it eagerly, op by op, with torch's autograd.
"""
from __future__ import annotations

import torch

from .executor import build_graph_fn

__all__ = ["TrainStep"]


def _as_dtype(v, dtype):
    """The Python float ``v`` rounded to ``dtype``."""
    return float(torch.tensor(v, dtype=dtype))


class TrainStep:
    """``step(data_u8, labels, params, auxs) -> (loss, grads, new_params,
    new_auxs)`` over tensors on one device: ``params`` in
    ``param_names`` order (every argument but the data and the labels),
    ``auxs`` in ``aux_names`` order.  A parameter the loss does not reach
    (bn_data_gamma under the fused stem) gets a zero gradient."""

    def __init__(self, symbol, dtype=torch.bfloat16, lr=0.05,
                 data_name="data", label_name="softmax_label"):
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.param_names = [n for n in self.arg_names
                            if n not in (data_name, label_name)]
        self.dtype = dtype
        self.lr = lr
        self._inputs = (data_name, label_name)
        self._graph_fn = build_graph_fn(symbol, self.arg_names,
                                        self.aux_names)

    def forward_loss(self, data_u8, labels, params, auxs):
        """(loss, new_auxs) of the training forward; differentiable in the
        parameters when they require gradients."""
        data = data_u8.to(self.dtype) * _as_dtype(1.0 / 255.0, self.dtype)
        vals = dict(zip(self.param_names, params))
        vals[self._inputs[0]] = data
        vals[self._inputs[1]] = labels
        outs, new_aux = self._graph_fn([vals[n] for n in self.arg_names],
                                       list(auxs), training=True)
        probs = outs[0].float()
        rows = torch.arange(probs.shape[0], device=probs.device)
        loss = -torch.log(probs[rows, labels.long()] + 1e-8).mean()
        return loss, tuple(a.detach() for a in new_aux)

    def __call__(self, data_u8, labels, params, auxs):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss, new_aux = self.forward_loss(data_u8, labels, leaves, auxs)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tuple(torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads))
        with torch.no_grad():
            new_params = tuple(p - _as_dtype(self.lr, p.dtype) * g
                               for p, g in zip(params, grads))
        return loss.detach(), grads, new_params, new_aux
