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

With a policy that buckets a per-example sequence axis
(``BucketPolicy(seq_axis=..., seq_buckets=...)``), requests of any length
along that axis share the programs of their seq bucket: a request pads
up to its bucket, coalesces with the requests of the same bucket, and
gets its outputs back sliced to the shapes the graph infers at its
unpadded input.  ``warmup`` runs the whole (seq bucket x batch bucket)
grid.

Construction runs the analysis preflight (``MXNET_ANALYSIS_ON``): the
verifier, shapes, retrace and padding passes over the graph at the
largest bucket.  A graph that mixes positions along the bucketed seq
axis first gets a masking repair (``MXNET_SERVE_REPAIR``): SequenceMask
nodes driven by a per-request valid-length input, adopted only when
re-analysis says the rewritten graph is row-local; the engine then feeds
each batch its live lengths.  Without a repair, the seq buckets are
dropped and every exact length runs its own program.  A graph that mixes
rows along the batch axis serves one request per batch
(``max_batch=1``).  Either degrade warns, or raises under
``MXNET_ANALYSIS_STRICT=1``; the retrace linter's findings are kept as
``hazard_fingerprints``.  Then the verdict-gated optimizer
(``MXNET_SERVE_OPTIMIZE``) rewrites the graph the ``ProgramCache`` runs,
adopted only when re-analysis is no worse, and the memory preflight
(``MXNET_MEMORY_PLAN``) prices the warm program set against the device
budget before any program runs: over budget warns, naming the program
and its bytes, or raises under strict.

Overload: a full queue rejects (``QueueFullError``) or, under
``overload_policy="shed-oldest"`` (``MXNET_SERVE_OVERLOAD_POLICY``),
fails the oldest queued request with ``ServerOverloadError``.
``MXNET_SERVE_PAD_CHECK=1`` dispatches every batch twice, the second time
with its pad slots set to a sentinel, and fails the batch with
"contamination" when a live output changed.

Not yet ported: replicas, sharding plans, the AOT program cache,
telemetry, fault injection, the supervisor and the overload regulator
(ROADMAP Queue A, items 4 and 7).
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
from .buckets import BucketPolicy, ProgramCache, pad_valid_lengths

__all__ = ["ServingEngine"]

_LAT_WINDOW = 4096


class ServingEngine(object):
    """Thread-safe batched-inference front end over one frozen graph.

    ``data_shapes`` maps each data input to its per-EXAMPLE shape (no
    batch dim); requests are validated against it, except along the
    policy's seq axis, which may vary per request.  ``overload_policy``
    is ``"reject"`` or ``"shed-oldest"`` (default
    ``MXNET_SERVE_OVERLOAD_POLICY``).  ``start=False`` leaves the worker
    stopped so requests can be staged."""

    def __init__(self, symbol, arg_params, aux_params, data_shapes,
                 ctx=None, policy=None, max_queue=None,
                 batch_timeout_ms=None, default_deadline_ms=None,
                 overload_policy=None, dtype=np.float32, start=True):
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
        if overload_policy is None:
            overload_policy = config.get("MXNET_SERVE_OVERLOAD_POLICY")
        self._window_s = float(batch_timeout_ms) / 1e3
        self._default_deadline_s = float(default_deadline_ms) / 1e3
        self._sym = symbol
        self._data_shapes = {k: tuple(v) for k, v in dict(data_shapes).items()}
        self._dtype = np.dtype(dtype)
        # static preflight: IR verifier + shapes + retrace + padding over
        # the axes this engine zero-pads; a cross-position seq verdict is
        # repaired or degraded, a cross-position batch verdict refused
        # (strict) or de-fanged (max_batch=1)
        self._serve_sym = symbol         # what the ProgramCache runs
        self.analysis_report = None
        self.repair_plan = None          # accepted RepairPlan, if any
        self._repair_rejected = None     # rejection reason, if attempted
        self._valid_name = None          # a repaired graph's extra input
        self._length_sources = {}        # input name -> per-example axis
        self.hazard_fingerprints = {}
        self._verdicts = None            # padded-axis verdicts, if analyzed
        self._pad_check = config.get("MXNET_SERVE_PAD_CHECK")
        pre = None
        if config.get("MXNET_ANALYSIS_ON"):
            pre = self._preflight(symbol, config.get("MXNET_ANALYSIS_STRICT"))
        # the verdict-gated optimizer rewrites the graph the ProgramCache
        # runs; its acceptance protocol IS analysis, so both knobs gate it
        self.opt_plan = None
        if config.get("MXNET_SERVE_OPTIMIZE") \
                and config.get("MXNET_ANALYSIS_ON"):
            self._optimize_preflight(arg_params, aux_params, pre)
        # the memory planner prices the warm program set before any
        # program runs; it only diagnoses, so outputs are the same bits
        # with it on or off
        self.memory_plan = None
        if config.get("MXNET_MEMORY_PLAN") \
                and config.get("MXNET_ANALYSIS_ON"):
            self._memory_preflight(arg_params, aux_params,
                                   config.get("MXNET_ANALYSIS_STRICT"))
        data_names = list(self._data_shapes)
        if self._valid_name is not None:
            data_names.append(self._valid_name)
        self._cache = ProgramCache(self._serve_sym, arg_params, aux_params,
                                   data_names, ctx=self._ctx, dtype=dtype)
        self._feed_dtypes = ({self._valid_name: np.float32}
                             if self._valid_name is not None else None)
        self._adm = AdmissionController(max_queue=max_queue,
                                        overload_policy=overload_policy)
        self._device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="mxnet-serve-device",
            initializer=self._bind_device)
        self._lock = threading.Lock()
        self._group_cache = {}           # exact input shapes -> group
        self._batches = 0
        self._warmup_batches = 0
        self._requests_served = 0
        self._occupancy_sum = 0.0
        self._dispatched_keys = set()
        self._retraces = 0
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
        cross-position along the bucketed **seq** axis first gets the
        masking repair (``MXNET_SERVE_REPAIR``); when the repair is
        rejected or off, the engine degrades to stay sound:

        - cross-position along **seq**: the seq buckets are dropped, and
          each exact length runs its own program;
        - cross-position along **batch**: requests stop coalescing
          (``max_batch=1``).

        Under strict a degrade raises instead.  Returns the analysis'
        ``(report, ctx)`` for the optimizer to reuse, or None when a
        repair or degrade changed the graph or the padded shapes."""
        from .. import config
        from ..analysis import (check_serving_graph, repair_serving_graph,
                                AnalysisError)
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
        if "seq" in cross and config.get("MXNET_SERVE_REPAIR") \
                and not report.errors:
            plan = repair_serving_graph(symbol, self._data_shapes,
                                        self._policy,
                                        precomputed=(report, ctx))
            if plan.accepted:
                # serve the rewritten graph from the whole grid; dispatch
                # feeds the live lengths that drive the spliced masks
                self.repair_plan = plan
                self._serve_sym = plan.symbol
                self._valid_name = plan.valid_length_name
                self._length_sources = dict(plan.length_sources)
                cross.remove("seq")
                if not cross:
                    return None
            else:
                self._repair_rejected = plan.reason
        detail = "\n".join(
            "  " + str(d) for d in report.warnings) or "  (see report)"
        if strict:
            raise AnalysisError(
                "[padding] ServingEngine: graph is cross-position along "
                "padded axis(es) %s — zero-pad slots would bleed into "
                "live outputs%s:\n%s"
                % (cross,
                   " (repair rejected: %s)" % self._repair_rejected
                   if self._repair_rejected else "", detail))
        if "seq" in cross:
            warnings.warn(
                "ServingEngine: graph is cross-position along the "
                "bucketed seq axis%s; disabling seq buckets (lengths "
                "still vary per request, but each exact length now "
                "runs its own program):\n%s"
                % (" and the masking repair was rejected (%s)"
                   % self._repair_rejected if self._repair_rejected
                   else "", detail))
            self._policy = BucketPolicy(
                max_batch=self._policy.max_batch,
                seq_axis=self._policy.seq_axis, seq_buckets=())
            self._collect_seq_hazards()
        if "batch" in cross:
            warnings.warn(
                "ServingEngine: graph mixes positions across the BATCH "
                "axis; disabling request coalescing (max_batch=1) so "
                "requests cannot contaminate each other:\n%s" % detail)
            self._policy = BucketPolicy(
                max_batch=1, seq_axis=self._policy.seq_axis,
                seq_buckets=self._policy.seq_buckets)
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

    def _collect_seq_hazards(self):
        """Exact-length degrade mode IS the retrace linter's
        unbucketed-dynamic-dim hazard (one program per observed length):
        re-run the linter with the seq axis declared dynamic so the
        engine's fingerprints name it."""
        from ..analysis import analyze
        shapes = {}
        for name, ex in self._data_shapes.items():
            s = [0 if ax == self._policy.seq_axis else d
                 for ax, d in enumerate(ex)]
            shapes[name] = (self._policy.max_batch,) + tuple(s)
        try:
            report, _ = analyze(self._sym, data_shapes=shapes,
                                policy=self._policy,
                                passes=("verify", "shapes", "retrace"))
        except Exception:
            return                      # advisory only: never block
        self._harvest_hazards(report)

    def _param_dtypes(self, arg_params, aux_params):
        dtypes = {n: self._dtype for n in self._data_shapes}
        if self._valid_name is not None:
            dtypes[self._valid_name] = np.dtype(np.float32)
        for src in (arg_params or {}), (aux_params or {}):
            for k, v in src.items():
                dt = getattr(v, "dtype", None)
                if dt is not None:
                    dtypes.setdefault(k, dt)
        return dtypes

    def _optimize_preflight(self, arg_params, aux_params, pre):
        """Optimize the graph the ProgramCache runs (the repaired graph
        when a repair was adopted).  The candidate is served only when
        the plan's re-analysis verdicts are no worse than the input
        graph's — padded-axis verdicts, output shapes, and output dtypes
        all intact.  Constants fold on the engine's device, so the
        optimized graph computes the unoptimized one's bits there.
        ``pre`` is the preflight's ``(report, ctx)`` over the same graph
        and spec, or None.  A rejected (or crashed) optimization leaves
        the engine serving the unoptimized graph, and says so."""
        from ..analysis import optimize_graph
        from ..analysis.core import same_dtype
        from ..analysis.rewrite import serving_pad_spec
        try:
            full, pad_axes = serving_pad_spec(self._data_shapes,
                                              self._policy)
            valid_lengths = None
            if self._valid_name is not None:
                full[self._valid_name] = (self._policy.max_batch,)
                pad_axes["batch"][self._valid_name] = 0
                valid_lengths = {self.repair_plan.label: self._valid_name}
            dtypes = self._param_dtypes(arg_params, aux_params)
            # the preflight assumed float32 throughout, so any other
            # dtype re-analyzes
            if not all(same_dtype(d, np.float32) for d in dtypes.values()):
                pre = None
            plan = optimize_graph(self._serve_sym, data_shapes=full,
                                  dtypes=dtypes, policy=self._policy,
                                  pad_axes=pad_axes, training=False,
                                  valid_lengths=valid_lengths,
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

    def _seq_shapes(self):
        """[(seq bucket or None, per-example shapes)] of the warm grid."""
        pol = self._policy
        if pol.seq_axis is None or not pol.seq_buckets:
            return [(None, dict(self._data_shapes))]
        out = []
        for sb in pol.seq_buckets:
            shapes = {}
            for name, ex in self._data_shapes.items():
                s = list(ex)
                s[pol.seq_axis] = sb
                shapes[name] = tuple(s)
            out.append((sb, shapes))
        return out

    def _memory_preflight(self, arg_params, aux_params, strict):
        """The OOM preflight (analysis/memory.py): price the warm program
        set — one program per seq bucket at the largest batch bucket
        (the byte cost grows with every padded extent, so the grid's
        largest batch IS the warm set's watermark) — against the device
        budget before any program runs.  Over budget warns naming the
        program and its bytes; ``MXNET_ANALYSIS_STRICT=1`` raises."""
        from ..analysis import AnalysisError
        from ..analysis.memory import (plan_memory, plan_digest,
                                       device_memory_budget, format_bytes)
        try:
            dtypes = self._param_dtypes(arg_params, aux_params)
            bb = max(self._policy.batch_buckets())
            programs = []
            for sb, shapes in self._seq_shapes():
                full = {name: (bb,) + tuple(ex)
                        for name, ex in shapes.items()}
                if self._valid_name is not None:
                    full[self._valid_name] = (bb,)
                plan, _rep = plan_memory(self._serve_sym, full,
                                         dtypes=dtypes)
                if not plan:
                    continue
                programs.append({
                    "program": ("b%d" % bb) + ("s%d" % sb
                                               if sb is not None else ""),
                    "peak_bytes": plan["peak_bytes"],
                    "param_bytes": plan["param_bytes"],
                    "transient_peak_bytes": plan["transient_peak_bytes"],
                    "inplace_savings_bytes":
                        plan["inplace_savings_bytes"]})
            if not programs:
                return
            worst = max(programs, key=lambda p: p["peak_bytes"])
            mem = {
                "enabled": True,
                "programs": programs,
                "predicted_peak_bytes": worst["peak_bytes"],
                "param_bytes": worst["param_bytes"],
                "offender": worst["program"],
                "sharded": False,
                "donation": None,
            }
            mem["digest"] = plan_digest(
                {k: mem[k] for k in ("programs", "predicted_peak_bytes",
                                     "sharded", "donation")})
            budget = device_memory_budget(self._ctx)
            mem["budget_bytes"] = budget
            mem["budget_ok"] = (None if budget is None
                                else worst["peak_bytes"] <= budget)
            self.memory_plan = mem
            if mem["budget_ok"] is False:
                msg = ("ServingEngine memory preflight: program %r "
                       "predicts peak %s (params %s + transient %s) "
                       "but the device budget is %s — the warm set "
                       "cannot fit; shrink max_batch/seq buckets or "
                       "raise MXNET_MEMORY_BUDGET_BYTES (priced before "
                       "any program runs)"
                       % (worst["program"],
                          format_bytes(worst["peak_bytes"]),
                          format_bytes(worst["param_bytes"]),
                          format_bytes(worst["transient_peak_bytes"]),
                          format_bytes(budget)))
                if strict:
                    raise AnalysisError("[memory] " + msg)
                warnings.warn(msg)
        except AnalysisError:
            raise
        except Exception as e:      # planner crash must never block
            warnings.warn("ServingEngine: memory preflight crashed "
                          "(%r); continuing without a memory plan"
                          % (e,))

    @property
    def served_sym(self):
        """The graph the ProgramCache runs (repaired and optimized when
        adopted)."""
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
        """Validate one request's inputs and compute its coalescing key
        (bucket-padded per-example shapes, name-sorted), its outputs'
        unpadded shapes and its padded-element cost; memoized on the
        exact input shapes."""
        sig = tuple(sorted((k, v.shape) for k, v in feeds.items()))
        hit = self._group_cache.get(sig)
        if hit is not None:
            return hit
        if set(feeds) != set(self._data_shapes):
            raise MXNetError("inputs %s do not match engine data inputs %s"
                             % (sorted(feeds), sorted(self._data_shapes)))
        group = []
        for name in sorted(feeds):
            x = feeds[name]
            ref = self._data_shapes[name]
            if x.ndim != len(ref):
                raise MXNetError(
                    "input %r: rank %d does not match the engine's %s "
                    "(per-example shapes, no batch dim)"
                    % (name, x.ndim, ref))
            for ax, (got, want) in enumerate(zip(x.shape, ref)):
                if ax == self._policy.seq_axis:
                    continue
                if got != want:
                    raise MXNetError(
                        "input %r: shape %s does not match the engine's "
                        "%s (per-example shapes, no batch dim; only the "
                        "seq axis may vary per request)"
                        % (name, tuple(x.shape), ref))
            group.append((name, self._policy.example_shape(x.shape)))
        if self._length_sources:
            # a repaired graph needs ONE live length per request: refuse
            # the request here, not its whole batch at dispatch
            lens = {feeds[n].shape[ax]
                    for n, ax in self._length_sources.items()}
            if len(lens) > 1:
                raise MXNetError(
                    "repaired-graph request needs ONE live length, but "
                    "its inputs disagree along the repaired axis: %s"
                    % {n: feeds[n].shape[ax]
                       for n, ax in sorted(self._length_sources.items())})
        # with a seq axis, outputs are sliced back to exactly what the
        # graph infers at the UNPADDED input (never guessed from axis
        # sizes: an output axis that equals the pad length is not cut)
        out_rows = None
        if self._policy.seq_axis is not None:
            _, out_shapes, _ = self._sym.infer_shape(
                **{k: (1,) + v.shape for k, v in feeds.items()})
            out_rows = tuple(tuple(s[1:]) for s in out_shapes)
        cost = int(sum(int(np.prod(shape)) if shape else 1
                       for _name, shape in group))
        out = tuple(group), out_rows, cost
        self._group_cache[sig] = out
        return out

    def submit(self, value=None, deadline_ms=None, **feeds):
        """Enqueue one request; returns a ``concurrent.futures.Future``
        resolving to the per-request output array (a list for
        multi-output graphs).  Raises QueueFullError under backpressure;
        the future fails with DeadlineExceededError on expiry and with
        ServerOverloadError when shed."""
        if value is not None:
            if len(self._data_shapes) != 1 or feeds:
                raise MXNetError("positional submit needs a single-input "
                                 "graph and no named inputs")
            feeds = {next(iter(self._data_shapes)): value}
        if self._adm.closed:
            raise EngineClosedError("serving engine is closed")
        feeds = {k: np.asarray(v, dtype=self._dtype)
                 for k, v in feeds.items()}
        group, out_rows, cost = self._group_for(feeds)
        if deadline_ms is None and self._default_deadline_s > 0:
            deadline_ms = self._default_deadline_s * 1e3
        deadline = None if not deadline_ms else \
            time.monotonic() + float(deadline_ms) / 1e3
        fut = Future()
        self._adm.admit(Request(feeds, group, fut, deadline=deadline,
                                out_rows=out_rows, cost=cost))
        return fut

    def predict(self, value=None, timeout=None, deadline_ms=None, **feeds):
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(value, deadline_ms=deadline_ms,
                           **feeds).result(timeout=timeout)

    # -------------------------------------------------------------- worker
    def _bind_device(self):
        if self._ctx.device.type == "cuda":
            torch.cuda.set_device(self._ctx.device)

    def _on_device_thread(self, fn, *args):
        return self._device_thread.submit(fn, *args).result()

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
                x = r.inputs[name]
                arr[(i,) + tuple(slice(0, d) for d in x.shape)] = x
            feeds[name] = arr
        if self._valid_name is not None:
            # a repaired graph: each request's live length drives the
            # spliced masks; pad rows carry 0 and are masked whole
            feeds[self._valid_name] = pad_valid_lengths(
                [self._live_length(r) for r in reqs], b)
        key = tuple(sorted((k, v.shape) for k, v in feeds.items()))
        c0 = self.compile_count
        if self._pad_check:
            outs = self._on_device_thread(self._pad_probe, feeds, reqs)
        else:
            outs = self._on_device_thread(self._cache.run, feeds, True,
                                          self._feed_dtypes)
        self._count_compiles(c0, key)
        now = time.monotonic()
        for i, r in enumerate(reqs):
            res = [self._unpad(o[i], r, j) for j, o in enumerate(outs)]
            r.future.set_result(res if len(res) > 1 else res[0])
        with self._lock:
            self._batches += 1
            self._requests_served += n
            self._occupancy_sum += n / float(b)
            self._lat_ms.extend((now - r.t_enqueue) * 1e3 for r in reqs)
            del self._lat_ms[:-_LAT_WINDOW]

    def _count_compiles(self, c0, key):
        """A program built for a bucket signature already dispatched is a
        retrace (the program cache lost it); a first sight is a build,
        which exact-length seq mode does by design."""
        built = self.compile_count - c0
        with self._lock:
            if built and key in self._dispatched_keys:
                self._retraces += built
            self._dispatched_keys.add(key)

    def _live_length(self, req):
        """One request's live extent along the repaired axis, read off its
        unpadded inputs; inputs that disagree fail the batch (they would
        mask the wrong slots)."""
        lengths = {req.inputs[n].shape[ax]
                   for n, ax in self._length_sources.items()}
        if len(lengths) != 1:
            raise MXNetError(
                "repaired-graph dispatch needs ONE live length per "
                "request, but the padded inputs disagree along the "
                "repaired axis: %s"
                % {n: req.inputs[n].shape[ax]
                   for n, ax in sorted(self._length_sources.items())})
        return lengths.pop()

    def _pad_probe(self, feeds, reqs):
        """``MXNET_SERVE_PAD_CHECK``: dispatch twice through the
        ProgramCache's probe and require each request's live output
        region to be bitwise equal (see ``ProgramCache.run_pad_probe``).
        Runs on the device thread; builds no extra program."""
        live_masks = {}
        for name, arr in feeds.items():
            mask = np.zeros(arr.shape, dtype=bool)
            if name == self._valid_name:
                # perturbing the lengths' PAD entries scrambles only pad
                # rows' masks, which a sound repair keeps out of live rows
                mask[:len(reqs)] = True
            else:
                for i, r in enumerate(reqs):
                    x = r.inputs[name]
                    mask[(i,) + tuple(slice(0, d) for d in x.shape)] = True
            live_masks[name] = mask
        base, probed = self._cache.run_pad_probe(
            feeds, live_masks, dtypes=self._feed_dtypes)
        for j, (o0, o1) in enumerate(zip(base, probed)):
            for i, r in enumerate(reqs):
                a = self._unpad(o0[i], r, j)
                bb = self._unpad(o1[i], r, j)
                if not np.array_equal(a, bb, equal_nan=True):
                    raise MXNetError(
                        "padding contamination detected at runtime: "
                        "output %d of request %d changed when pad slots "
                        "were perturbed — the graph is cross-position "
                        "along a padded axis" % (j, i))
        return base

    @staticmethod
    def _unpad(row, req, j):
        """Slice output ``j``'s row back to the shape the graph infers at
        the request's UNPADDED input; a pad-invariant output passes
        through."""
        if req.out_rows is None:
            return row
        want = req.out_rows[j]
        if row.shape == want:
            return row
        return row[tuple(slice(0, d) for d in want)]

    # ------------------------------------------------------------- observe
    def warmup(self):
        """Run every (seq bucket x batch bucket) program once so live
        traffic finds each program (and the kernels) ready.  Returns the
        compile count."""
        for _sb, shapes in self._seq_shapes():
            for bb in self._policy.batch_buckets():
                feeds = {name: np.zeros((bb,) + ex, dtype=self._dtype)
                         for name, ex in shapes.items()}
                if self._valid_name is not None:
                    # all-pad lengths: the same program, outputs dropped
                    feeds[self._valid_name] = pad_valid_lengths([], bb)
                self._on_device_thread(self._cache.run, feeds, True,
                                       self._feed_dtypes)
                with self._lock:
                    self._dispatched_keys.add(tuple(sorted(
                        (k, v.shape) for k, v in feeds.items())))
                    self._warmup_batches += 1
        return self.compile_count

    @property
    def compile_count(self):
        return self._cache.compile_count

    def stats(self):
        """Admission counters (queue depth, rejected, shed, expired),
        dispatch and occupancy aggregates, the program cache, the
        construction-time repair, optimizer and memory outcomes, and
        request latency percentiles (ms) over the last completions."""
        snap = self._adm.stats()
        mem = _memory_stats_block(self.memory_plan, self._ctx)
        with self._lock:
            lat = sorted(self._lat_ms)
            snap.update({
                "batches": self._batches,
                "warmup_batches": self._warmup_batches,
                "requests_served": self._requests_served,
                "batch_occupancy": (self._occupancy_sum / self._batches
                                    if self._batches else 0.0),
                "compile_count": self.compile_count,
                "retraces": self._retraces,
                "bucket_keys": len(self._cache.bucket_keys),
                "max_batch": self._policy.max_batch,
                "device": str(self._ctx.device),
                "pad_verdicts": dict(self._verdicts or {}),
                "repairs": {
                    "applied": (len(self.repair_plan.actions)
                                if self.repair_plan is not None else 0),
                    "rejected": 1 if self._repair_rejected else 0,
                    "valid_length_input": self._valid_name,
                    "reason": self._repair_rejected,
                },
                "optimizer": None if self.opt_plan is None else {
                    "accepted": self.opt_plan.accepted,
                    "rewrites": len(self.opt_plan.rewrites),
                    "reason": self.opt_plan.reason,
                },
                "memory": mem,
            })
        for q in (50, 90, 99):
            snap["latency_p%d_ms" % q] = (
                lat[min(len(lat) - 1, int(len(lat) * q / 100.0))]
                if lat else 0.0)
        return snap


def _memory_stats_block(memory_plan, ctx):
    """One engine's ``stats()["memory"]`` block (both engine kinds): the
    construction-time plan plus the allocator's measured peak on a CUDA
    card (None on the CPU)."""
    if not memory_plan:
        return {"enabled": False}
    peak = None
    if ctx.device.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(ctx.device))
    return dict(memory_plan, measured_peak_bytes=peak)
