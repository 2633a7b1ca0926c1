"""NDArray: a thin handle over a ``torch.Tensor`` on a context.

Counterpart of the parts of ``mxnet_tpu/ndarray/ndarray.py`` the serving
and training paths use: creation, ``asnumpy``, ``as_in_context``,
``copyto``, ``copy``, indexing and assignment, shape and dtype, and the
SGD updates with ``out=`` (in place, as the reference writes them).
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import Context, cpu
from ..ops.registry import torch_dtype

__all__ = ["NDArray", "array", "zeros", "zeros_like", "sgd_update",
           "sgd_mom_update"]


class NDArray:
    __slots__ = ("_data",)

    def __init__(self, tensor):
        self._data = tensor

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def context(self):
        return Context.of(self._data.device)

    def __getitem__(self, key):
        return NDArray(self._data[key])

    def __setitem__(self, key, value):
        """Write a scalar, a numpy array or an NDArray into ``self[key]``,
        cast to this array's dtype and moved to its device."""
        with torch.no_grad():
            if isinstance(value, (int, float)):
                self._data[key] = value
                return
            src = value._data if isinstance(value, NDArray) \
                else torch.from_numpy(np.ascontiguousarray(value))
            self._data[key].copy_(src)

    def copy(self):
        return NDArray(self._data.detach().clone())

    def asnumpy(self):
        """A host copy: later in-place updates of this array (an
        optimizer step) do not show through it."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def copyto(self, other):
        """Copy into another NDArray (in place, keeping its device and
        dtype) or onto a context (a new NDArray)."""
        if isinstance(other, NDArray):
            other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.to(other.device, copy=True))
        raise TypeError("copyto does not support type %s" % type(other))

    def as_in_context(self, context):
        if context == self.context:
            return self
        return self.copyto(context)

    def __repr__(self):
        return "<NDArray %s @%s>" % ("x".join(map(str, self.shape)),
                                     self.context)


def array(source, ctx=None, dtype=None):
    """NDArray from a numpy array (or anything numpy can take); float64
    input becomes float32, as in the reference."""
    if isinstance(source, NDArray):
        source = source.asnumpy()
    a = np.asarray(source)
    if dtype is None and a.dtype == np.float64:
        dtype = np.float32
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return NDArray(t.to((ctx or cpu()).device))


def zeros(shape, ctx=None, dtype=None):
    return NDArray(torch.zeros(tuple(shape),
                               dtype=torch_dtype(dtype or np.float32),
                               device=(ctx or cpu()).device))


def zeros_like(arr):
    return NDArray(torch.zeros_like(arr._data))


def _update_target(weight, out):
    if out is None:
        return weight.copy()
    if out is not weight:
        weight.copyto(out)
    return out


def sgd_update(weight, grad, out=None, **attrs):
    """``ops.optimizer_ops.sgd_update`` into ``out`` (a copy of weight
    when None; ``out=weight`` updates in place)."""
    from ..ops.optimizer_ops import sgd_update as update
    out = _update_target(weight, out)
    update(out._data, grad._data, **attrs)
    return out


def sgd_mom_update(weight, grad, mom, out=None, **attrs):
    """``ops.optimizer_ops.sgd_mom_update`` into ``out``; the momentum
    ``mom`` is updated in place."""
    from ..ops.optimizer_ops import sgd_mom_update as update
    out = _update_target(weight, out)
    update(out._data, grad._data, mom._data, **attrs)
    return out
