"""Shape buckets and the per-bucket program cache of the serving engine.

Counterpart of ``mxnet_tpu/serving/buckets.py``.  All traffic is
quantized onto a small grid:

- **batch buckets**: a batch of n requests pads up to the next power of
  two up to ``max_batch``, so at most log2(max_batch)+1 batch shapes run;
- **seq buckets** (optional): one designated per-example axis pads up to
  the next configured bucket, for length-polymorphic models whose
  outputs are row-independent along that axis.

:class:`ProgramCache` holds
the parameters on the device once and one callable per bucket shape:
the graph function with every non-data input (params, aux, placeholder
labels sized for that bucket) already in place.  Torch runs eagerly, so
building a bucket's callable compiles nothing; ``compile_count`` counts
the callables built (each also moves the process-wide program-build
counter, ``mxnet_xla_traces_total``), ``plan_hits``/``plan_misses`` the
dispatches that found or built one.  With the efficiency plane on
(``telemetry.goodput.enabled()``) each bucket program is priced once, as
it is built, by ``telemetry.goodput.price_graph``.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..base import MXNetError
from ..context import default_context
from ..executor import _count_xla_trace, build_graph_fn
from ..ops.registry import torch_dtype
from ..predict import _infer_label_shapes, _label_like

__all__ = ["BucketPolicy", "ProgramCache", "pad_valid_lengths"]


def _next_pow2(n):
    p = 1
    while p < n:
        p <<= 1
    return p


def pad_valid_lengths(lengths, bucket):
    """Batch-pad a per-request live-length vector onto the bucket grid:
    slot i carries request i's live extent along the repaired axis and
    the pad rows carry 0, so every spliced SequenceMask masks them
    entirely.  Always float32: the spliced variable declares float32,
    and a half-precision length would round onto the wrong mask
    boundary (float16 cannot represent 2049)."""
    out = np.zeros((bucket,), dtype=np.float32)
    out[:len(lengths)] = lengths
    return out


class BucketPolicy(object):
    """Quantizes request-batch sizes (and optionally one per-example
    axis) onto the bucket grid the program cache builds for."""

    def __init__(self, max_batch=8, seq_axis=None, seq_buckets=()):
        if max_batch < 1:
            raise MXNetError("max_batch must be >= 1, got %d" % max_batch)
        self.max_batch = _next_pow2(int(max_batch))
        self.seq_axis = seq_axis
        self.seq_buckets = tuple(sorted(int(b) for b in seq_buckets))
        if self.seq_buckets and seq_axis is None:
            raise MXNetError("seq_buckets given without seq_axis")

    @classmethod
    def from_config(cls):
        """Build from ``MXNET_SERVE_MAX_BATCH`` and
        ``MXNET_SERVE_SEQ_BUCKETS`` (which buckets per-example axis 0)."""
        from .. import config
        raw = config.get("MXNET_SERVE_SEQ_BUCKETS").strip()
        seq_buckets = tuple(int(t) for t in raw.split(",") if t.strip())
        return cls(max_batch=config.get("MXNET_SERVE_MAX_BATCH"),
                   seq_axis=0 if seq_buckets else None,
                   seq_buckets=seq_buckets)

    def batch_buckets(self):
        out, b = [], 1
        while b <= self.max_batch:
            out.append(b)
            b <<= 1
        return out

    def batch_bucket(self, n):
        if n < 1:
            raise MXNetError("empty batch")
        if n > self.max_batch:
            raise MXNetError("batch %d exceeds max_batch %d"
                             % (n, self.max_batch))
        return _next_pow2(n)

    def seq_bucket(self, length):
        """Smallest configured seq bucket >= length (identity when seq
        bucketing is off)."""
        if not self.seq_buckets:
            return length
        for b in self.seq_buckets:
            if length <= b:
                return b
        raise MXNetError(
            "sequence length %d exceeds largest seq bucket %d"
            % (length, self.seq_buckets[-1]))

    def example_shape(self, shape):
        """Pad a per-example shape onto the bucket grid."""
        if self.seq_axis is None:
            return tuple(shape)
        if self.seq_axis >= len(shape):
            raise MXNetError("seq_axis %d out of range for shape %s"
                             % (self.seq_axis, tuple(shape)))
        s = list(shape)
        s[self.seq_axis] = self.seq_bucket(s[self.seq_axis])
        return tuple(s)


class ProgramCache(object):
    """Device-resident params + one prepared forward per bucket shape."""

    def __init__(self, symbol, arg_params, aux_params, data_names,
                 ctx=None, dtype=np.float32):
        self._ctx = default_context(ctx)
        self._device = self._ctx.device
        self._sym = symbol
        self._dtype = torch_dtype(dtype)
        self.data_names = list(data_names)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        missing = [n for n in arg_names
                   if n not in (arg_params or {}) and n not in self.data_names]
        self._label_names = _label_like(missing)
        missing = [n for n in missing if n not in self._label_names]
        if missing:
            raise MXNetError("ProgramCache: params missing for %s" % missing)
        self._params = {n: arg_params[n].as_in_context(self._ctx)._data
                        for n in arg_names
                        if n not in self.data_names
                        and n not in self._label_names}
        self._aux = [aux_params[n].as_in_context(self._ctx)._data
                     for n in aux_names]
        self._arg_names = arg_names
        self._graph_fn = build_graph_fn(symbol, arg_names, aux_names)
        self._n_out = len(symbol._outputs)
        self._programs = {}          # shape key -> callable(feeds)
        self._lock = threading.Lock()
        # plan-cache traffic: plain ints, touched by the one device
        # thread; the engine's collect callback mirrors them
        self.plan_hits = 0
        self.plan_misses = 0
        # efficiency plane: advisory integer FLOPs price per bucket
        # signature, computed once as the program is built (None =
        # the FLOPs pass could not price it)
        self.flops_by_key = {}

    @property
    def compile_count(self):
        """Bucket callables built so far; warm traffic leaves it unchanged."""
        return len(self._programs)

    def flops_for(self, shape_key):
        """Advisory FLOPs price of one bucket program (shape key: sorted
        (name, padded shape) tuples); None when unpriced."""
        return self.flops_by_key.get(shape_key)

    def _program_for(self, shape_key, record=True):
        with self._lock:
            prog = self._programs.get(shape_key)
            if prog is not None:
                self.plan_hits += record
                return prog
            self.plan_misses += record
            data_shapes = dict(shape_key)
            labels = {n: torch.zeros(s, dtype=torch.float32,
                                     device=self._device)
                      for n, s in _infer_label_shapes(
                          self._sym, data_shapes, self._label_names).items()}
            template = [self._params.get(n, labels.get(n))
                        for n in self._arg_names]
            data_pos = [(i, n) for i, n in enumerate(self._arg_names)
                        if n in data_shapes]
            graph_fn, aux = self._graph_fn, self._aux

            def prog(feeds):
                args = list(template)
                for i, n in data_pos:
                    args[i] = feeds[n]
                with torch.inference_mode():
                    return graph_fn(args, aux)[0]
            from ..telemetry import goodput as _goodput
            if _goodput.enabled():
                self.flops_by_key[shape_key] = _goodput.price_graph(
                    self._sym, data_shapes,
                    label_names=self._label_names)
            self._programs[shape_key] = prog
            _count_xla_trace()
            return prog

    @property
    def bucket_keys(self):
        """The bucket signatures built so far."""
        with self._lock:
            return sorted(self._programs)

    def run(self, feeds, host=True, dtypes=None, record=True):
        """Dispatch one padded batch: ``feeds`` maps data name to a host
        array WITH batch dim, already padded to a bucket shape.  Returns
        the outputs as host arrays (still batch-padded), or as tensors
        on the device with ``host=False``.  Inputs take the cache's
        dtype, except those ``dtypes`` names (a repaired graph's
        float32 valid lengths).  ``record=False`` leaves the hit/miss
        counts alone (the pad probe's second dispatch of one batch)."""
        shape_key = tuple(sorted((k, tuple(v.shape))
                                 for k, v in feeds.items()))
        prog = self._program_for(shape_key, record)
        dtypes = dtypes or {}
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self._device, torch_dtype(dtypes[k]) if k in dtypes
            else self._dtype, non_blocking=False)
               for k, v in feeds.items()}
        outs = prog(dev)[:self._n_out]
        if not host:
            return list(outs)
        return [o.float().cpu().numpy() if o.dtype == torch.bfloat16
                else o.cpu().numpy() for o in outs]

    def run_pad_probe(self, feeds, live_masks, sentinel=7.5, dtypes=None):
        """The runtime padding-soundness check (``MXNET_SERVE_PAD_CHECK``):
        dispatch the batch twice, once as given (zero pads) and once
        with every pad slot set to ``sentinel``.  A graph that is truly
        row-local along the padded axes computes live outputs from live
        inputs only, so the two runs agree bitwise on live rows (same
        program, same live operands); any divergence is contamination.
        Returns (base_outs, probed_outs); the engine compares each
        request's live region.  ``live_masks`` maps input name to a bool
        array of the batch-padded shape, True on live slots."""
        base = self.run(feeds, dtypes=dtypes)
        probed_feeds = {}
        for name, arr in feeds.items():
            mask = live_masks.get(name)
            if mask is None:
                probed_feeds[name] = arr
            else:
                probed_feeds[name] = np.where(
                    mask, arr, np.asarray(sentinel, arr.dtype))
        probed = self.run(probed_feeds, dtypes=dtypes, record=False)
        return base, probed
