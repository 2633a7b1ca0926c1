"""Bucketed batches of variable-length sentences.

Counterpart of ``mxnet_tpu/rnn/io.py``: ``encode_sentences`` (tokens to
ids, building the vocabulary) and ``BucketSentenceIter`` (each sentence
in the smallest bucket that holds it, padded with ``invalid_label``,
batches tagged with their ``bucket_key``).  The shuffles draw from the
standard library's ``random.Random(seed)`` in the reference's order, so
both packages give the same batches, bit for bit.  Batches are CPU
NDArrays, as the port's other iterators give them.
"""
import bisect
import logging
import random

import numpy as np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray import array

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Token lists -> (id lists, vocabulary); a new vocabulary numbers
    tokens from ``start_label``, skipping ``invalid_label``."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                assert new_vocab, "Unknown token %s" % word
                if idx == invalid_label:
                    idx += 1
                vocab[word] = idx
                idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed, padded sentence batches; the label is the data shifted
    left by ``label_shift``.  Without ``buckets``, every length that has
    a full batch of sentences is a bucket."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", label_shift=1, seed=0):
        super().__init__(batch_size)
        if buckets is None:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens) if n >= batch_size]
        buckets = sorted(buckets)
        assert buckets, "no bucket can hold a full batch; pass buckets="
        self.buckets = buckets
        self.data_name, self.label_name = data_name, label_name
        self.invalid_label = invalid_label
        self.layout = layout
        self.dtype = dtype
        self._shift = label_shift
        self._rng = random.Random(seed)

        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            i = bisect.bisect_left(buckets, len(sent))
            if i == len(buckets):
                ndiscard += 1
                continue
            padded = np.full((buckets[i],), invalid_label, np.float32)
            padded[:len(sent)] = sent
            self.data[i].append(padded)
        if ndiscard:
            logging.getLogger(__name__).warning(
                "discarded %d sentences longer than the largest bucket",
                ndiscard)
        self.data = [np.asarray(d, np.float32) for d in self.data]
        self._plan = []
        self._idx = {}
        self.default_bucket_key = max(buckets)
        self.reset()

    def _desc(self, name, shape):
        return DataDesc(name, shape, self.dtype, layout=self.layout)

    @property
    def provide_data(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.layout == "NT" else (self.default_bucket_key,
                                         self.batch_size)
        return [self._desc(self.data_name, shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.layout == "NT" else (self.default_bucket_key,
                                         self.batch_size)
        return [self._desc(self.label_name, shape)]

    def reset(self):
        self._plan = []
        for i, d in enumerate(self.data):
            order = list(range(len(d)))
            self._rng.shuffle(order)
            self._idx[i] = order
            for k in range(len(d) // self.batch_size):
                self._plan.append((i, k))
        self._rng.shuffle(self._plan)
        self._cursor = -1

    def iter_next(self):
        self._cursor += 1
        return self._cursor < len(self._plan)

    def next(self):
        if not self.iter_next():
            raise StopIteration
        bkt, k = self._plan[self._cursor]
        rows = self._idx[bkt][k * self.batch_size:(k + 1) * self.batch_size]
        data = self.data[bkt][rows]
        label = np.full_like(data, self.invalid_label)
        label[:, :-self._shift] = data[:, self._shift:]
        if self.layout == "TN":
            data, label = data.T, label.T
        shape = data.shape
        return DataBatch(
            data=[array(data, ctx=cpu())], label=[array(label, ctx=cpu())],
            pad=0, bucket_key=self.buckets[bkt],
            provide_data=[self._desc(self.data_name, shape)],
            provide_label=[self._desc(self.label_name, shape)])
