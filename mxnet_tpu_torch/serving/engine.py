"""ServingEngine: thread-safe batched inference over one frozen graph.

Counterpart of the core of ``mxnet_tpu/serving/engine.py``: clients
``submit`` single examples (no batch dim) and get futures; one worker
thread takes the oldest request's shape group from the admission queue
(waiting at most the batching window for company), pads it up to a
power-of-two bucket, has the bucket's program run on the device, and
hands each client its own row back on the host.  ``warmup`` runs every
bucket once up front.  With no ``ctx`` the engine serves on the first
CUDA card, and raises when there is none; pass ``ctx=cpu()`` for the CPU.

Every program runs on one device thread that lives as long as the
engine, warmup included: cuBLAS handles and cuDNN's execution plans are
kept per thread, so a warmup on any other thread would leave the first
live batches to build them again.

Construction runs the analysis preflight (``MXNET_ANALYSIS_ON``): the
verifier, shapes, retrace and padding passes over the graph at the
largest bucket.  A graph that mixes rows along the zero-padded batch
axis warns and serves one request per batch (``max_batch=1``), or
raises under ``MXNET_ANALYSIS_STRICT=1``; the retrace linter's findings
are kept as ``hazard_fingerprints``.  Then the verdict-gated optimizer
(``MXNET_SERVE_OPTIMIZE``) rewrites the graph the ``ProgramCache`` runs,
adopted only when re-analysis is no worse.

Not yet ported: the sequence axis (seq buckets, and with them the
preflight's masking repair and seq degrade, ROADMAP Queue A item 3),
the memory preflight, replicas, sharding plans, the AOT program cache,
telemetry, fault injection, the supervisor and the overload regulator.
"""
from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..base import MXNetError
from ..context import default_context
from .admission import (AdmissionController, Request, EngineClosedError,
                        _fail_future)
from .buckets import BucketPolicy, ProgramCache

__all__ = ["ServingEngine"]

_LAT_WINDOW = 4096


class ServingEngine(object):
    """Thread-safe batched-inference front end over one frozen graph.

    ``data_shapes`` maps each data input to its per-EXAMPLE shape (no
    batch dim); requests are validated against it.  ``start=False``
    leaves the worker stopped so requests can be staged."""

    def __init__(self, symbol, arg_params, aux_params, data_shapes,
                 ctx=None, policy=None, max_queue=None,
                 batch_timeout_ms=None, default_deadline_ms=None,
                 dtype=np.float32, start=True):
        from .. import config
        self._ctx = default_context(ctx)
        self._policy = policy or BucketPolicy.from_config()
        if max_queue is None:
            max_queue = config.get("MXNET_SERVE_MAX_QUEUE")
        if batch_timeout_ms is None:
            batch_timeout_ms = config.get("MXNET_SERVE_BATCH_TIMEOUT_MS")
        if default_deadline_ms is None:
            default_deadline_ms = config.get(
                "MXNET_SERVE_DEFAULT_DEADLINE_MS")
        self._window_s = float(batch_timeout_ms) / 1e3
        self._default_deadline_s = float(default_deadline_ms) / 1e3
        self._data_shapes = {k: tuple(v) for k, v in dict(data_shapes).items()}
        self._dtype = np.dtype(dtype)
        # static preflight: IR verifier + shapes + retrace + padding over
        # the batch axis this engine zero-pads; a cross-position verdict
        # is refused (strict) or de-fanged (max_batch=1)
        self._serve_sym = symbol         # what the ProgramCache runs
        self.analysis_report = None
        self.hazard_fingerprints = {}
        self._verdicts = None            # padded-axis verdicts, if analyzed
        pre = None
        if config.get("MXNET_ANALYSIS_ON"):
            pre = self._preflight(symbol, config.get("MXNET_ANALYSIS_STRICT"))
        # the verdict-gated optimizer rewrites the graph the ProgramCache
        # runs; its acceptance protocol IS analysis, so both knobs gate it
        self.opt_plan = None
        if config.get("MXNET_SERVE_OPTIMIZE") \
                and config.get("MXNET_ANALYSIS_ON"):
            self._optimize_preflight(arg_params, aux_params, pre)
        self._cache = ProgramCache(self._serve_sym, arg_params, aux_params,
                                   list(self._data_shapes), ctx=self._ctx,
                                   dtype=dtype)
        self._adm = AdmissionController(max_queue=max_queue)
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mxnet-serve-device",
            initializer=self._bind_device)
        self._lock = threading.Lock()
        self._batches = 0
        self._warmup_batches = 0
        self._requests_served = 0
        self._occupancy_sum = 0.0
        self._lat_ms = []
        self._worker = None
        if start:
            self.start()

    @classmethod
    def from_checkpoint(cls, prefix, epoch, data_shapes, **kwargs):
        """Build from ``prefix-symbol.json`` + ``prefix-%04d.params``."""
        from ..model import load_checkpoint
        kwargs["ctx"] = default_context(kwargs.get("ctx"))
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(symbol, arg_params, aux_params, data_shapes, **kwargs)

    # ------------------------------------------------------------ preflight
    def _preflight(self, symbol, strict):
        """Construction-time static analysis (mxnet_tpu_torch.analysis).

        Verifier errors raise under ``MXNET_ANALYSIS_STRICT``.  A graph
        cross-position along the **batch** axis stops coalescing
        requests (``max_batch=1``): with positions mixing across the
        batch axis, even unpadded batching would blend requests.  Under
        strict it raises instead.  (The JAX package also repairs or
        degrades a bucketed seq axis; the port's policy has none.)
        Returns the analysis' ``(report, ctx)`` for the optimizer to
        reuse, or None when a degrade changed the padded shapes."""
        from ..analysis import check_serving_graph, AnalysisError
        verdicts, report, ctx = check_serving_graph(
            symbol, self._data_shapes, self._policy, with_ctx=True)
        self.analysis_report = report
        self._verdicts = dict(verdicts)
        self._harvest_hazards(report)
        if report.errors:
            if strict:
                report.raise_if_errors()    # names the failing passes
            warnings.warn("ServingEngine: graph verification failed:\n%s"
                          % report.format())
        cross = [lb for lb, v in verdicts.items() if v == "cross-position"]
        if not cross:
            return report, ctx
        detail = "\n".join(
            "  " + str(d) for d in report.warnings) or "  (see report)"
        if strict:
            raise AnalysisError(
                "[padding] ServingEngine: graph is cross-position along "
                "padded axis(es) %s — zero-pad slots would bleed into "
                "live outputs:\n%s" % (cross, detail))
        if "batch" in cross:
            warnings.warn(
                "ServingEngine: graph mixes positions across the BATCH "
                "axis; disabling request coalescing (max_batch=1) so "
                "requests cannot contaminate each other:\n%s" % detail)
            self._policy = BucketPolicy(max_batch=1)
        return None

    def _harvest_hazards(self, report):
        """Keep the report's retrace-linter warnings under their hazard
        fingerprints (the JAX package labels runtime retraces with the
        same keys)."""
        from ..analysis import hazard_fingerprint
        for d in report.warnings:
            if d.pass_name != "retrace":
                continue
            fp = hazard_fingerprint(d.node, d.op, d.message)
            self.hazard_fingerprints.setdefault(fp, str(d))

    def _optimize_preflight(self, arg_params, aux_params, pre):
        """Optimize the graph the ProgramCache runs.  The candidate is
        served only when the plan's re-analysis verdicts are no worse
        than the input graph's — padded-axis verdicts, output shapes,
        and output dtypes all intact.  Constants fold on the engine's
        device, so the optimized graph computes the unoptimized one's
        bits there.  ``pre`` is the preflight's ``(report, ctx)`` over the
        same graph and spec, or None.  A rejected (or crashed)
        optimization leaves the engine serving the unoptimized graph, and
        says so."""
        from ..analysis import optimize_graph
        from ..analysis.core import same_dtype
        from ..analysis.rewrite import serving_pad_spec
        try:
            full, pad_axes = serving_pad_spec(self._data_shapes,
                                              self._policy)
            dtypes = {n: self._dtype for n in self._data_shapes}
            for src in (arg_params or {}), (aux_params or {}):
                for k, v in src.items():
                    dt = getattr(v, "dtype", None)
                    if dt is not None:
                        dtypes.setdefault(k, dt)
            # the preflight assumed float32 throughout, so any other
            # dtype re-analyzes
            if not all(same_dtype(d, np.float32) for d in dtypes.values()):
                pre = None
            plan = optimize_graph(self._serve_sym, data_shapes=full,
                                  dtypes=dtypes, policy=self._policy,
                                  pad_axes=pad_axes, training=False,
                                  precomputed=pre, device=self._ctx.device)
        except Exception as e:      # optimizer crash must never block
            warnings.warn("ServingEngine: graph optimization crashed "
                          "(%r); serving the unoptimized graph" % (e,))
            return
        self.opt_plan = plan
        if plan.accepted and plan.symbol is not None and plan.rewrites:
            self._serve_sym = plan.symbol
        elif not plan.accepted:
            warnings.warn("ServingEngine: graph optimization rejected "
                          "(%s); serving the unoptimized graph"
                          % plan.reason)

    @property
    def served_sym(self):
        """The graph the ProgramCache runs (optimized when adopted)."""
        return self._serve_sym

    # ------------------------------------------------------------ lifecycle
    def start(self):
        if self._adm.closed:
            raise EngineClosedError(
                "engine is closed; build a new ServingEngine")
        if self._worker is None:
            self._worker = threading.Thread(target=self._run,
                                            name="mxnet-serve-worker",
                                            daemon=True)
            self._worker.start()
        return self

    def close(self, drain=True):
        """Stop admitting; with ``drain`` finish queued work first.
        Closing is permanent."""
        self._adm.close(drain=drain)
        if self._worker is not None:
            self._worker.join(timeout=None if drain else 60)
            if not self._worker.is_alive():
                self._worker = None
        elif drain:
            self._run()          # never started: drain on this thread
        self._device_thread.shutdown(wait=self._worker is None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -------------------------------------------------------------- client
    def _group_for(self, feeds):
        if set(feeds) != set(self._data_shapes):
            raise MXNetError("inputs %s do not match engine data inputs %s"
                             % (sorted(feeds), sorted(self._data_shapes)))
        for name, x in feeds.items():
            if tuple(x.shape) != self._data_shapes[name]:
                raise MXNetError(
                    "input %r: shape %s does not match the engine's %s "
                    "(per-example shapes, no batch dim)"
                    % (name, tuple(x.shape), self._data_shapes[name]))
        return tuple(sorted((k, tuple(v.shape)) for k, v in feeds.items()))

    def submit(self, value=None, deadline_ms=None, **feeds):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the per-request output array (a list for
        multi-output graphs).  Raises QueueFullError under backpressure;
        the future fails with DeadlineExceededError on expiry."""
        if value is not None:
            if len(self._data_shapes) != 1 or feeds:
                raise MXNetError("positional submit needs a single-input "
                                 "graph and no named inputs")
            feeds = {next(iter(self._data_shapes)): value}
        if self._adm.closed:
            raise EngineClosedError("serving engine is closed")
        feeds = {k: np.asarray(v, dtype=self._dtype)
                 for k, v in feeds.items()}
        group = self._group_for(feeds)
        if deadline_ms is None and self._default_deadline_s > 0:
            deadline_ms = self._default_deadline_s * 1e3
        deadline = None if not deadline_ms else \
            time.monotonic() + float(deadline_ms) / 1e3
        fut = Future()
        self._adm.admit(Request(feeds, group, fut, deadline=deadline))
        return fut

    def predict(self, value=None, timeout=None, deadline_ms=None, **feeds):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(value, deadline_ms=deadline_ms,
                           **feeds).result(timeout=timeout)

    # -------------------------------------------------------------- worker
    def _bind_device(self):
        if self._ctx.device.type == "cuda":
            torch.cuda.set_device(self._ctx.device)

    def _on_device_thread(self, feeds):
        return self._device_thread.submit(self._cache.run, feeds).result()

    def _run(self):
        while True:
            reqs = self._adm.take(self._policy.max_batch, self._window_s)
            if reqs is None:
                return                     # closed and drained
            if not reqs:
                continue
            try:
                self._dispatch(reqs)
            except Exception as e:         # fail the batch, keep serving
                self._fail_batch(reqs, e)

    @staticmethod
    def _fail_batch(reqs, e):
        for r in reqs:
            if not r.future.done():
                _fail_future(r.future, e)

    def _dispatch(self, reqs):
        # claim every future: a running future can no longer be cancelled,
        # and requests the client already cancelled drop out here
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        n = len(reqs)
        b = self._policy.batch_bucket(n)
        feeds = {}
        for name, ex_shape in reqs[0].group:
            arr = np.zeros((b,) + ex_shape, dtype=self._dtype)
            for i, r in enumerate(reqs):
                arr[i] = r.inputs[name]
            feeds[name] = arr
        outs = self._on_device_thread(feeds)
        now = time.monotonic()
        for i, r in enumerate(reqs):
            res = [o[i] for o in outs]
            r.future.set_result(res if len(res) > 1 else res[0])
        with self._lock:
            self._batches += 1
            self._requests_served += n
            self._occupancy_sum += n / float(b)
            self._lat_ms.extend((now - r.t_enqueue) * 1e3 for r in reqs)
            del self._lat_ms[:-_LAT_WINDOW]

    # ------------------------------------------------------------- observe
    def warmup(self):
        """Run every batch bucket once so live traffic finds each bucket's
        program (and the kernels) ready.  Returns the compile count."""
        for bb in self._policy.batch_buckets():
            self._on_device_thread(
                {name: np.zeros((bb,) + ex, dtype=self._dtype)
                 for name, ex in self._data_shapes.items()})
            with self._lock:
                self._warmup_batches += 1
        return self.compile_count

    @property
    def compile_count(self):
        return self._cache.compile_count

    def stats(self):
        """Admission counters, dispatch and occupancy aggregates, and
        request latency percentiles (ms) over the last completions."""
        snap = self._adm.stats()
        with self._lock:
            lat = sorted(self._lat_ms)
            snap.update({
                "batches": self._batches,
                "warmup_batches": self._warmup_batches,
                "requests_served": self._requests_served,
                "batch_occupancy": (self._occupancy_sum / self._batches
                                    if self._batches else 0.0),
                "compile_count": self.compile_count,
                "max_batch": self._policy.max_batch,
                "device": str(self._ctx.device),
                "pad_verdicts": dict(self._verdicts or {}),
                "optimizer": None if self.opt_plan is None else {
                    "accepted": self.opt_plan.accepted,
                    "rewrites": len(self.opt_plan.rewrites),
                    "reason": self.opt_plan.reason,
                },
            })
        for q in (50, 90, 99):
            snap["latency_p%d_ms" % q] = (
                lat[min(len(lat) - 1, int(len(lat) * q / 100.0))]
                if lat else 0.0)
        return snap
