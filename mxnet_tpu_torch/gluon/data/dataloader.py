"""DataLoader: mini-batches from a Dataset.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``.  Workers are host
threads (numpy's batching and the decoders release the GIL), with a
bounded window of batches in flight; a batch is made on
``current_context()`` (the card unless a ``with mt.cpu():`` scope is
open), once per step.  With telemetry on, each batch observes
``mxnet_io_batch_latency_ms{iter="DataLoader"}``: its making time without
workers, and with them how long the consumer waited for it.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice

import numpy as np

from ... import ndarray as nd
from ...context import Context
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays with ``stack``, tuples field
    by field, anything else through numpy."""
    if isinstance(data[0], nd.NDArray):
        return nd.invoke("stack", list(data), {"axis": 0})
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


class DataLoader:
    """Loads data from a dataset and returns mini-batches."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _load(self, batch, scope=None):
        """One batch; ``scope`` is the caller's innermost ``with ctx:``
        context, which a worker thread does not inherit."""
        with scope if scope is not None else contextlib.nullcontext():
            return self._batchify_fn([self._dataset[i] for i in batch])

    def __iter__(self):
        from ... import telemetry
        from ...io import _observe_batch
        rec = telemetry.enabled()
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                t0 = time.perf_counter() if rec else 0.0
                out = self._load(batch)
                if rec:
                    _observe_batch(self, t0)
                yield out
            return
        # at most twice the workers' batches in flight, so a slow consumer
        # never holds a whole epoch in memory
        stack = getattr(Context._scope, "stack", None)
        scope = stack[-1] if stack else None
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            batches = iter(self._batch_sampler)
            window = deque(pool.submit(self._load, b, scope)
                           for b in islice(batches, 2 * self._num_workers))
            while window:
                f = window.popleft()
                nxt = next(batches, None)
                if nxt is not None:
                    window.append(pool.submit(self._load, nxt, scope))
                # the consumer's stall for the prefetched batch (0 when
                # the workers kept up): the pipeline-bubble signal
                t0 = time.perf_counter() if rec else 0.0
                out = f.result()
                if rec:
                    _observe_batch(self, t0)
                yield out

    def __len__(self):
        return len(self._batch_sampler)
