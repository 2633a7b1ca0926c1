"""Checkpoints (``prefix-symbol.json`` + ``prefix-%04d.params``) and the
kvstore choice of a training loop.

Counterpart of ``save_checkpoint`` / ``load_checkpoint``,
``BatchEndParam`` and ``_create_kvstore`` in ``mxnet_tpu/model.py``; the
checkpoint files interchange with the JAX package.
"""
from __future__ import annotations

from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError
from .context import cpu

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore, update_on_kvstore): one device with ``"local"`` (or any
    non-dist name) or None needs no store, and the module updates the
    weights itself.  Stores are not yet ported."""
    if kvstore is None or (isinstance(kvstore, str) and num_device == 1
                           and "dist" not in kvstore):
        return None, False
    raise MXNetError("kvstore %r with %d devices is not yet ported (one "
                     "device with kvstore='local' or None)"
                     % (kvstore, num_device))


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v.as_in_context(cpu())
                 for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v.as_in_context(cpu())
                      for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params), the params as CPU NDArrays."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch),
                           ctx=cpu()).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
