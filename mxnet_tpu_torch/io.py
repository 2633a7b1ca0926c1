"""Data iterators.

Counterpart of ``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``ResizeIter``, ``PrefetchingIter``, ``NDArrayIter`` (pad,
discard and roll_over), ``MNISTIter``, ``CSVIter`` and the factories
``ImageRecordIter``, ``ImageRecordUInt8Iter`` and ``ImageDetRecordIter``
(``image/``).  Batches are host NDArrays of a fixed shape (the last one
padded, wrapped or discarded); the executor moves each to the device
when it is fed.
``NDArrayIter`` shuffles from the explicit CPU generator of ``random``.
With telemetry on, each batch an iterator produces observes
``mxnet_io_batch_latency_ms{iter}`` (labeled by the class the user built:
``MNISTIter`` and ``CSVIter`` pin their label on the inner iterator) and
notes its interval on the ambient training step's trace.
``LibSVMIter`` (CSR arrays) is not yet ported.
"""
from __future__ import annotations

import gzip
import struct
import threading
import time
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array
from . import random as _random

_BATCH_HIST = {}        # iterator label -> memoized histogram child


def _observe_batch(iter_obj, t0):
    """Record one produced batch's host latency against the telemetry
    registry, labeled by iterator class (callers gate on
    telemetry.enabled()).  Wrappers that delegate next() to an inner
    iterator (MNISTIter/CSVIter) pin their own label on the inner via
    ``_telemetry_label`` so traffic is attributed to the class the
    user built."""
    from . import telemetry
    from .telemetry import step as _step
    label = getattr(iter_obj, "_telemetry_label",
                    None) or type(iter_obj).__name__
    child = telemetry.bound(
        _BATCH_HIST, label,
        lambda: telemetry.histogram(
            "mxnet_io_batch_latency_ms",
            "host input-pipeline time to produce one batch, by iterator",
            ("iter",)).labels(iter=label))
    child.observe((time.perf_counter() - t0) * 1e3)
    # span-only note on the ambient training step (fit's data_wait
    # phase already owns this interval in the histograms)
    _step.annotate_active("io.batch[%s]" % label, t0)


__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "MNISTIter", "CSVIter",
           "ImageRecordIter", "ImageRecordUInt8Iter", "ImageDetRecordIter"]


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
    """One batch: lists of data and label NDArrays, the number of padding
    rows at its end, and the bucket it belongs to (``BucketingModule``)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
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
        from . import telemetry
        rec = telemetry.enabled()
        t0 = time.perf_counter() if rec else 0.0
        if self.iter_next():
            batch = DataBatch(data=self.getdata(), label=self.getlabel(),
                              pad=self.getpad(), index=self.getindex())
            if rec:
                _observe_batch(self, t0)
            return batch
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


class ResizeIter(DataIter):
    """``data_iter`` resized to ``size`` batches an epoch: it restarts
    the inner iterator when that runs out first."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """One background thread per iterator of ``iters`` fetches its next
    batch while the caller uses the current one; the batches of all of
    them are joined into one (their data and labels concatenated)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0].shape[0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()
        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i])
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.daemon = True
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join(timeout=1.0)

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            for i in self.next_batch:
                assert i is None, \
                    "Number of entry mismatches between iterators"
            return False
        for batch in self.next_batch:
            assert batch.pad == self.next_batch[0].pad, \
                "Number of entry mismatches between iterators"
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data, provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


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
    """Batches over in-memory arrays, optionally shuffled once.  The last
    batch is filled from the start and its rows counted as padding
    ("pad"), dropped ("discard"), or filled from the start with no padding
    counted, the next epoch starting where that left off ("roll_over")."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError("NDArrayIter: last_batch_handle must be pad, "
                             "discard or roll_over, not %r"
                             % (last_batch_handle,))
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

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
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
        if self.last_batch_handle == "pad":
            return max(0, self.cursor + self.batch_size - self.num_data)
        return 0


class _WrappedIter(DataIter):
    """An iterator that hands every call to an inner NDArrayIter."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class MNISTIter(_WrappedIter):
    """MNIST idx-format files (optionally gzipped), scaled to [0, 1],
    shuffled once from ``seed``, sharded by ``num_parts``/``part_index``;
    the last partial batch is dropped."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0,
                 part_index=0, num_parts=1, input_shape=None, **kwargs):
        super().__init__(batch_size)
        images = self._read_images(image)
        labels = self._read_labels(label)
        assert images.shape[0] == labels.shape[0]
        if num_parts > 1:
            n = images.shape[0] // num_parts
            s = part_index * n
            images, labels = images[s:s + n], labels[s:s + n]
        if shuffle:
            order = np.random.RandomState(seed).permutation(images.shape[0])
            images, labels = images[order], labels[order]
        images = images.astype(np.float32) / 255.0
        if flat:
            images = images.reshape(images.shape[0], -1)
        else:
            images = images.reshape(images.shape[0], 1, 28, 28)
        if input_shape is not None:
            images = images.reshape((images.shape[0],) + tuple(input_shape))
        self._inner = NDArrayIter(images, labels, batch_size,
                                  shuffle=False, last_batch_handle="discard")
        self._inner._telemetry_label = type(self).__name__

    @staticmethod
    def _open(path):
        if path.endswith(".gz"):
            return gzip.open(path, "rb")
        return open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError("bad MNIST image magic in %s" % path)
            return np.frombuffer(f.read(num * rows * cols),
                                 dtype=np.uint8).reshape(num, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, num = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError("bad MNIST label magic in %s" % path)
            return np.frombuffer(f.read(num),
                                 dtype=np.uint8).astype(np.float32)


class CSVIter(_WrappedIter):
    """Rows of ``data_csv`` (and ``label_csv``) reshaped to ``data_shape``
    (``label_shape``); the last batch padded (``round_batch``) or
    dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard")
        self._inner._telemetry_label = type(self).__name__


def ImageRecordIter(**kwargs):
    """The record-file image pipeline (``image.ImageRecordIterImpl``)."""
    from .image import ImageRecordIterImpl
    return ImageRecordIterImpl(**kwargs)


def ImageRecordUInt8Iter(**kwargs):
    """The uint8 record-file pipeline: decode, crop and mirror only."""
    from .image import ImageRecordUInt8Iter as impl
    return impl(**kwargs)


def ImageDetRecordIter(**kwargs):
    """The detection record iterator (``image.ImageDetRecordIterImpl``)."""
    from .image import ImageDetRecordIterImpl
    return ImageDetRecordIterImpl(**kwargs)
