"""Data iterators.

Counterpart of ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter`` in ``mxnet_tpu/io.py``.  Batches are host NDArrays of a
fixed shape (the last one padded or discarded); the executor moves each
to the device when it is fed.  Shuffling draws from the explicit CPU
generator of ``random``.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array
from . import random as _random

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)


class DataBatch:
    """One batch: lists of data and label NDArrays, and the number of
    padding rows at its end."""

    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """[(name, host numpy array)] from an array, a list or a dict."""
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise MXNetError("NDArrayIter: no data")
        names = [default_name] if len(data) == 1 else \
            ["_%d_%s" % (i, default_name) for i in range(len(data))]
        data = OrderedDict(zip(names, data))
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Batches over in-memory arrays, optionally shuffled once; the last
    batch is padded from the start ("pad") or dropped ("discard")."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard"):
            raise MXNetError("NDArrayIter: last_batch_handle=%r is not yet "
                             "ported (pad, discard)" % (last_batch_handle,))
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        n = self.data[0][1].shape[0]
        if shuffle:
            idx = torch.randperm(n, generator=_random.generator()).numpy()
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            n -= n % batch_size
        if n < batch_size:
            raise MXNetError("batch_size needs to be smaller than data size")
        self.num_data = n
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _batch(self, source):
        # host-side staging: Module copies the batch to its device
        lo, hi = self.cursor, self.cursor + self.batch_size
        if hi <= self.num_data:
            return [array(v[lo:hi], ctx=cpu()) for _, v in source]
        pad = hi - self.num_data
        return [array(np.concatenate([v[lo:self.num_data], v[:pad]]),
                      ctx=cpu()) for _, v in source]

    def getdata(self):
        return self._batch(self.data)

    def getlabel(self):
        return self._batch(self.label)

    def getpad(self):
        return max(0, self.cursor + self.batch_size - self.num_data)
