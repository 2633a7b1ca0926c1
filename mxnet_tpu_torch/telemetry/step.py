"""Training-step attribution: where does each training step's wall go?

The serving stack answers "where did THIS request's 40 ms go?" per
request; the training loop could not answer the same question per
step: a low MFU with no attribution data cannot say whether the
missing time is input wait, h2d upload, compute dispatch, kvstore
traffic, the optimizer, or host sync.

A :class:`StepTimer` instruments one training loop (``BaseModule.fit``
wires one up automatically; ``gluon.Trainer.step`` and
``PipelineModule.update`` fall back to a per-loop default when driven
outside ``fit``) and attributes each step's wall time to *disjoint*
phases:

==============  ============================================================
``data_wait``   blocked pulling the next batch off the input iterator
                (the io.py batch histograms measure *production* cost;
                this measures the loop's *wait*, which prefetch hides)
``h2d``         host->device upload of the batch feed (executor.forward)
``fwd_bwd``     forward_backward dispatch (+ any program build inside it)
``kv_push``     kvstore gradient push (direction split joins the
                ``mxnet_kvstore_*`` series)
``kv_pull``     kvstore aggregate/weight pull
``optimizer``   optimizer update (self-time: nested kv phases subtract)
``metric``      update_metric / host-side output sync
==============  ============================================================

Phases nest: a phase records its *self* time (children subtract), so
the per-step phase sum never double-counts and an "unattributed
residual" (step wall minus phase sum) is an honest number —
``tools/step_report.py`` renders it as its own row.

Exported series (all labeled ``loop`` = fit/trainer/pipeline):

- ``mxnet_train_step_phase_seconds{loop,phase}`` histogram — one
  observation per phase per step (the step's summed self-time);
- ``mxnet_train_step_seconds{loop}`` histogram — step wall;
- ``mxnet_train_steps_total{loop}`` counter;
- ``mxnet_train_step_compiles_total{loop}`` counter — steps that
  built a graph program (``mxnet_xla_traces_total`` delta, the
  reference's name; warm steps must not move it);
- ``mxnet_train_mfu{loop}`` gauge — analytic-FLOPs MFU: the
  :mod:`mxnet_tpu_torch.analysis.flops` count for one step over measured
  step wall x the card's dense bf16 peak (``PEAKS_TFLOPS``), whatever
  dtype the step runs in; 0 for a graph the efficiency plane leaves
  unpriced (``goodput.UNPRICED_OPS``: the fused ResNet units, the fused
  stem, the fused RNN);
- ``mxnet_train_step_flops{loop}`` gauge — the analytic per-step FLOPs
  themselves, so MFU recomputes offline from any snapshot;
- ``mxnet_train_device_mem_peak_bytes{loop}`` gauge — device memory
  watermark (``torch.cuda.memory_stats``), refreshed per step.

Per-step span trees flow through the SAME tail-biased retention chain
serving uses (sampling.py): every step is timed, the slowest steps
(top-K / moving p99 / every-Nth floor) land in the trace store as
``train.step[<loop>]`` trees with one child span per phase interval —
so ``telemetry_dump top`` shows straggler steps next to straggler
requests.  Cross-rank, the series ride the rank-snapshot aggregation
(``telemetry_dump aggregate`` / ``tools/step_report.py``), which names
the straggling rank per phase from per-rank histogram means.
"""
from __future__ import annotations

import contextlib
import contextvars
import time

__all__ = ["StepTimer", "PHASES", "STEP_SECONDS_BUCKETS",
           "PEAKS_TFLOPS", "peak_flops_for", "active_timer", "activate",
           "active_phase", "ensure_step", "observe_active",
           "annotate_active", "default_timer", "fit_timer"]

#: the attribution vocabulary — tools/step_report.py renders rows in
#: this order; anything outside these is the residual row
PHASES = ("data_wait", "h2d", "fwd_bwd", "kv_push", "kv_pull",
          "optimizer", "metric")

#: step-scale buckets in SECONDS (training steps span 100 us toy fits
#: to multi-second compiles; the ms-scale serving buckets top out too
#: early and would flatten every real step into +Inf)
STEP_SECONDS_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
                        1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0, 30.0)

#: dense bf16 peak TFLOP/s by card-name substring: the MFU denominator.
#: NVIDIA's data sheets: the H100 SXM and the H200 both give 989 dense
#: bf16 TFLOP/s at 700 W.  The H100 PCIe and the H100 and H200 NVL parts
#: run other clocks and powers and are left out (``_OTHER_PARTS``): an
#: unknown card has no honest denominator, so its MFU is not published.
PEAKS_TFLOPS = {
    "h100 80gb hbm3": 989.0, "h100 sxm": 989.0, "h200": 989.0,
}
_OTHER_PARTS = ("nvl", "pcie")


def peak_flops_for(device):
    """Peak FLOP/s for a ``torch.device`` (or a ``Context``, or a card
    name), matched on ``torch.cuda.get_device_name``; None for the CPU
    and for cards outside the table: no honest MFU denominator exists
    then."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        kind = device.lower()
    else:
        import torch
        device = torch.device(getattr(device, "device", device))
        if device.type != "cuda":
            return None
        kind = torch.cuda.get_device_name(device).lower()
    if any(part in kind for part in _OTHER_PARTS):
        return None
    for key, val in PEAKS_TFLOPS.items():
        if key in kind:
            return val * 1e12
    return None


_ACTIVE = contextvars.ContextVar("mxnet_tpu_torch_step_timer", default=None)

# -- per-loop heartbeat aggregation -----------------------------------------
#
# One ``train.<loop>`` heartbeat per loop label, aggregating every live
# StepTimer on that label: concurrent fits sharing a label must not
# clobber each other's registration (a wedged fit would become
# invisible the moment a healthy one registered over it).  ``busy`` is
# true while ANY timer has a step open; ``age_s`` is the STALEST busy
# timer's progress age (the one the watchdog should page about).
# WeakSet membership: a timer GC'd without close() drops out on its
# own instead of being kept alive by its diagnostics.

import threading as _threading
import weakref as _weakref

_HB_LOCK = _threading.Lock()
_HB_LOOPS = {}      # loop label -> WeakSet[StepTimer]


def _loop_heartbeat(loop):
    with _HB_LOCK:
        timers = list(_HB_LOOPS.get(loop, ()))
    now = time.monotonic()
    busy = [t for t in timers if t._t0 is not None]
    if busy:
        age = max(now - t._hb_stamp for t in busy)
    elif timers:
        age = min(now - t._hb_stamp for t in timers)
    else:
        age = 0.0
    return {"age_s": age, "busy": bool(busy), "in_step": bool(busy),
            "kind": "train", "loop": loop, "timers": len(timers),
            "steps": sum(t.steps for t in timers)}


def _loop_hb_add(loop, timer):
    # register/unregister run INSIDE _HB_LOCK so a close() racing a
    # same-label construction cannot unregister the heartbeat the new
    # timer just registered (lock order step._HB_LOCK -> recorder's
    # heartbeat lock; nothing takes them in reverse)
    from .recorder import register_heartbeat
    with _HB_LOCK:
        group = _HB_LOOPS.get(loop)
        if group is None:
            group = _HB_LOOPS[loop] = _weakref.WeakSet()
            register_heartbeat("train.%s" % loop,
                               lambda loop=loop: _loop_heartbeat(loop))
        group.add(timer)


def _loop_hb_discard(loop, timer):
    from .recorder import unregister_heartbeat
    with _HB_LOCK:
        group = _HB_LOOPS.get(loop)
        if group is None:
            return
        group.discard(timer)
        if len(group) == 0:
            del _HB_LOOPS[loop]
            unregister_heartbeat("train.%s" % loop)

_PHASE_DOC = ("training-step wall time attributed per phase (self-time: "
              "nested phases subtract, so phases sum to <= step wall and "
              "the residual is honest)")


class _Phase(object):
    """Slotted context manager for one phase frame — the per-phase hot
    path runs a few times per training step and a generator-based
    @contextmanager pair measured ~3x this object's cost."""
    __slots__ = ("st", "name", "t0", "child")

    def __init__(self, st, name):
        self.st = st
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.child = 0.0
        self.st._stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        st = self.st
        st._stack.pop()
        st._record(self.name, self.t0, t1, t1 - self.t0 - self.child)
        return False


class StepTimer(object):
    """Attributes one training loop's step wall time to phases.

    Instruments bind at construction iff telemetry is enabled — a
    disabled timer is inert (``step``/``phase`` are no-ops and make
    zero registry calls, the overhead discipline every other built-in
    instrument follows).  One timer serves one loop label; several
    fits sharing a label share series (bounded cardinality).
    """

    def __init__(self, loop="fit", flops_per_step=0.0, peak_flops=None,
                 trace_counter=None, retention=None, device=None):
        from . import (enabled, histogram, counter, gauge)
        self.loop = str(loop)
        self.flops_per_step = float(flops_per_step or 0.0)
        self.peak_flops = peak_flops
        self.device = device    # the chip actually training (memory
        #                         watermark); None = the first card
        self.steps = 0
        self._on = enabled()
        self._t0 = None             # None = no step open
        self._stack = []            # open phase frames [name, t0, child_s]
        self._phase_self = {}       # phase -> accumulated self seconds
        self._spans = []            # (name, t0, t1) intervals for the trace
        self._traces0 = 0.0
        self._mem_ok = True         # device.memory_stats support probe
        if not self._on:
            return
        self._trace_counter = trace_counter
        self._trace_fam = None      # memoized mxnet_xla_traces_total
        lab = dict(loop=self.loop)
        self._h_phase_fam = histogram(
            "mxnet_train_step_phase_seconds", _PHASE_DOC,
            ("loop", "phase"), buckets=STEP_SECONDS_BUCKETS)
        self._h_phase = {}          # phase -> bound child
        self._h_step = histogram(
            "mxnet_train_step_seconds",
            "training-step wall time (fetch of the batch through "
            "metric update)", ("loop",),
            buckets=STEP_SECONDS_BUCKETS).labels(**lab)
        self._c_steps = counter(
            "mxnet_train_steps_total", "training steps completed",
            ("loop",)).labels(**lab)
        self._c_compiles = counter(
            "mxnet_train_step_compiles_total",
            "training steps that built at least one graph program "
            "(mxnet_xla_traces_total delta; warm steps must not move "
            "this)", ("loop",)).labels(**lab)
        self._g_mfu = gauge(
            "mxnet_train_mfu",
            "live model-FLOPs utilization: analytic per-step FLOPs / "
            "(measured step wall x chip peak); 0 when the peak or the "
            "FLOP count is unknown", ("loop",)).labels(**lab)
        self._g_flops = gauge(
            "mxnet_train_step_flops",
            "analytic FLOPs per training step (mxnet_tpu_torch.analysis."
            "flops over the bound shapes)", ("loop",)).labels(**lab)
        self._g_mem = gauge(
            "mxnet_train_device_mem_peak_bytes",
            "device memory watermark (torch.cuda.memory_stats "
            "allocated_bytes.all.peak), refreshed per training step; 0 "
            "= unsupported backend", ("loop",)).labels(**lab)
        # fits sharing a label share these gauges, and the fit defaults
        # are never closed: a fit with no FLOP count or no peak resets
        # them to 0 rather than showing an earlier fit's values
        self._g_flops.set(self.flops_per_step)
        if not (self.flops_per_step and self.peak_flops):
            self._g_mfu.set(0.0)
        # per-step span trees ride the serving retention chain (tail
        # top-K + moving p99 + every-Nth floor); None = tracing off
        if retention is not None:
            self._retention = retention
        else:
            from .sampling import chain_from_config
            self._retention = chain_from_config()
        # zero-progress watchdog coverage for training loops (the
        # engines cover their workers): the timer stamps a heartbeat
        # at step and phase boundaries, and registers the same
        # watchdog rule shape the engines use — a fit() wedged
        # mid-step (hung input pipeline, stuck collective, wedged
        # dispatch) is NAMED on /alerts instead of dying silently.
        # Shared+refcounted per loop label: concurrent fits on one
        # label hold one rule, and the ONE ``train.<loop>`` heartbeat
        # aggregates every live timer on the label (a wedged fit must
        # stay visible even while a concurrent healthy fit on the same
        # label stamps progress).  Caveat the engines share: a cold
        # program build inside a step looks identical to a hang, which
        # is what the 30 s production default is sized to absorb.
        self._hb_stamp = time.monotonic()
        self._hb_name = "train.%s" % self.loop
        self._watchdog_owner = None
        _loop_hb_add(self.loop, self)
        from .. import config
        if config.get("MXNET_TELEMETRY_ALERTS"):
            from .alerts import AlertRule, default_manager
            # owner token unique PER TIMER: remove_owner drops exactly
            # this timer's reference, so co-resident timers on one loop
            # label refcount the shared rule correctly
            owner = "train:%s:%d" % (self.loop, id(self))
            default_manager().add_rule(AlertRule(
                "train_%s_stalled" % self.loop, "watchdog",
                heartbeat=self._hb_name,
                threshold=config.get("MXNET_TELEMETRY_WATCHDOG_SECS"),
                annotations={"loop": self.loop, "kind": "train",
                             "summary": "training step open with zero "
                                        "progress — wedged dispatch, "
                                        "hung input pipeline, or stuck "
                                        "collective"}),
                owner=owner, shared=True)
            self._watchdog_owner = owner

    def _trace_count(self):
        if self._trace_counter is not None:
            return self._trace_counter()
        fam = self._trace_fam
        if fam is None:
            # the counter registers at the first program build, which may
            # be later than this timer's construction — resolve lazily,
            # then keep the family (no registry lock per step)
            from . import registry
            fam = registry().get("mxnet_xla_traces_total")
            if fam is None:
                return 0.0
            self._trace_fam = fam
        try:
            return fam.value
        except Exception:
            return 0.0

    # -- step lifecycle ----------------------------------------------------
    def begin_step(self, t0=None):
        if not self._on:
            return
        self._hb_stamp = time.monotonic()
        self._t0 = time.perf_counter() if t0 is None else t0
        self._stack = []
        self._phase_self = {}
        self._spans = []
        self._traces0 = self._trace_count()

    def abort_step(self):
        """Discard an open step without recording it (the final
        iterator probe that raised StopIteration is not a step)."""
        self._t0 = None
        self._stack = []

    def end_step(self, t1=None):
        if not self._on or self._t0 is None:
            return
        self._hb_stamp = time.monotonic()
        t1 = time.perf_counter() if t1 is None else t1
        t0, self._t0 = self._t0, None
        wall = max(t1 - t0, 0.0)
        self.steps += 1
        self._c_steps.inc()
        self._h_step.observe(wall)
        for name, secs in self._phase_self.items():
            child = self._h_phase.get(name)
            if child is None:
                child = self._h_phase_fam.labels(loop=self.loop,
                                                 phase=name)
                self._h_phase[name] = child
            child.observe(secs)
        compiles = self._trace_count() - self._traces0
        if compiles > 0:
            self._c_compiles.inc()
        if self.flops_per_step and self.peak_flops and wall > 0:
            self._g_mfu.set(self.flops_per_step / (wall * self.peak_flops))
        self._observe_device_mem()
        if self._retention is not None:
            keep, why = self._retention.decide(wall * 1e3, None)
            if keep:
                self._publish_trace(t0, t1, compiles, why)

    @contextlib.contextmanager
    def step(self, t0=None):
        """One training step; exceptions still record the partial step
        (a crashing step's attribution is evidence, not noise)."""
        if not self._on:
            yield self
            return
        self.begin_step(t0)
        try:
            yield self
        finally:
            self.end_step()

    # -- phase recording ---------------------------------------------------
    def phase(self, name):
        """Timed phase inside the open step.  Nested phases subtract
        from the enclosing phase's self-time, keeping phases disjoint."""
        if not self._on or self._t0 is None:
            return _NOOP
        return _Phase(self, name)

    def observe_phase(self, name, t0, t1):
        """Attribute an already-measured interval (the kvstore veneer
        measured its own latency once; re-timing it would skew both)."""
        if not self._on or self._t0 is None:
            return
        self._record(name, t0, t1, t1 - t0)

    def _record(self, name, t0, t1, self_s):
        # phase completion IS progress: a slow-but-moving step keeps
        # the watchdog quiet, a step stuck inside one phase does not
        self._hb_stamp = time.monotonic()
        self._phase_self[name] = (self._phase_self.get(name, 0.0)
                                  + max(self_s, 0.0))
        self._spans.append((name, t0, t1))
        if self._stack:
            self._stack[-1].child += (t1 - t0)

    def annotate(self, name, t0, t1):
        """Span-only record (shows in the step trace, not the phase
        histograms): io batch-production intervals use this so the
        trace shows production cost INSIDE the data_wait span without
        double-counting the histogram sum."""
        if not self._on or self._t0 is None:
            return
        self._spans.append((name, t0, t1))

    # -- internals ---------------------------------------------------------
    def _publish_trace(self, t0, t1, compiles, retained_by):
        from .tracing import TraceContext
        tc = TraceContext("train.step[%s]" % self.loop, "train")
        tc.root.t0 = t0
        tc.root.meta = {"loop": self.loop, "step": self.steps,
                        "compiles": int(compiles)}
        for (name, s0, s1) in self._spans:
            tc.add(name, s0, s1, "train")
        tc.finish(t1, retained_by=retained_by)

    def _observe_device_mem(self):
        if not self._mem_ok:
            return
        from .devicemem import device_memory_peak
        peak = device_memory_peak(self.device)
        if peak is None:
            self._mem_ok = False    # probe once; CPU backends lack it
            return
        self._g_mem.set(float(peak))

    def close(self):
        """Reclaim this timer's labeled series (mirrors
        ServingEngine.close(): short-lived loop labels must not grow
        scrapes forever).  The fit/trainer defaults are long-lived and
        never closed; tests and ad-hoc timers use this."""
        if not self._on:
            return
        _loop_hb_discard(self.loop, self)
        if self._watchdog_owner is not None:
            from .alerts import default_manager
            default_manager().remove_owner(self._watchdog_owner)
            self._watchdog_owner = None
        from . import registry
        reg = registry()
        for name in ("mxnet_train_step_seconds", "mxnet_train_steps_total",
                     "mxnet_train_step_compiles_total", "mxnet_train_mfu",
                     "mxnet_train_step_flops",
                     "mxnet_train_device_mem_peak_bytes"):
            fam = reg.get(name)
            if fam is not None:
                fam.remove(loop=self.loop)
        fam = reg.get("mxnet_train_step_phase_seconds")
        if fam is not None:
            for phase in list(self._h_phase):
                fam.remove(loop=self.loop, phase=phase)
        self._h_phase.clear()
        _DEFAULT.pop(self.loop, None)


# -- ambient-timer plumbing (library hook points) ---------------------------

def active_timer():
    """The StepTimer active on this context, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(timer):
    """Make ``timer`` ambient for the enclosed block so library hook
    points (executor h2d, kvstore push/pull, optimizer update) can
    attribute without plumbing arguments."""
    token = _ACTIVE.set(timer)
    try:
        yield timer
    finally:
        _ACTIVE.reset(token)


_NOOP = contextlib.nullcontext()    # stateless; safe to share


def active_phase(name):
    """Phase on the ambient timer when a step is open; a shared no-op
    (zero allocations, zero instrument calls) otherwise — the hook
    library code (executor, fit loop, trainers) calls this a few times
    per step/forward, so it must stay allocation-free when inert."""
    st = _ACTIVE.get()
    if st is None or st._t0 is None:
        return _NOOP
    return _Phase(st, name)


def observe_active(name, t0, t1=None):
    """Pre-measured interval onto the ambient timer (kvstore veneer)."""
    st = _ACTIVE.get()
    if st is not None and st._on and st._t0 is not None:
        st.observe_phase(name, t0,
                         time.perf_counter() if t1 is None else t1)


def annotate_active(name, t0, t1=None):
    """Span-only annotation onto the ambient timer (io batch spans)."""
    st = _ACTIVE.get()
    if st is not None and st._on and st._t0 is not None:
        st.annotate(name, t0, time.perf_counter() if t1 is None else t1)


_DEFAULT = {}           # loop label -> (registry generation, StepTimer)


def default_timer(loop):
    """Memoized per-loop-label timer for loops driven outside fit()
    (standalone gluon Trainer.step, PipelineModule.update); versioned
    by registry generation so telemetry.reset() invalidates it."""
    from . import registry
    gen = registry().generation
    hit = _DEFAULT.get(loop)
    if hit is not None and hit[0] == gen:
        return hit[1]
    t = StepTimer(loop=loop)
    _DEFAULT[loop] = (gen, t)
    return t


@contextlib.contextmanager
def ensure_step(loop):
    """Join the open ambient step, or — when none is open and
    telemetry is on — make the enclosed block ONE step on the loop's
    default timer.  gluon.Trainer.step / PipelineModule.update wrap
    themselves with this, so they attribute correctly whether driven
    by an instrumented fit() loop or called standalone."""
    st = _ACTIVE.get()
    if st is not None and st._on and st._t0 is not None:
        yield st
        return
    from . import enabled
    if not enabled():
        yield None
        return
    st = default_timer(loop)
    with st.step():
        with activate(st):
            yield st


def fit_timer(symbol, provide_data, provide_label=None, loop="fit",
              device=None):
    """The StepTimer BaseModule.fit builds: analytic per-step FLOPs
    from the bound symbol + shapes (training = fwd + bwd), peak from
    the device the module is actually BOUND to (``device``; falling
    back to the first card, else the CPU — a CPU-context fit on a
    card's host must not claim the idle card's peak).  Returns None when telemetry is
    disabled; never raises — attribution must not break training."""
    from . import enabled
    if not enabled():
        return None
    flops = 0.0
    try:
        if symbol is not None:
            shapes = {}
            for d in list(provide_data or []) + list(provide_label or []):
                name, shape = (d.name, d.shape) if hasattr(d, "name") \
                    else (d[0], d[1])
                shapes[name] = tuple(shape)
            # memoized on the symbol: re-fitting a bound module must
            # not pay the static analysis again (the count is a pure
            # function of graph + input shapes)
            key = tuple(sorted(shapes.items()))
            cache = symbol.__dict__.setdefault("_analytic_flops", {})
            flops = cache.get(key)
            if flops is None:
                # an unpriced graph (goodput.UNPRICED_OPS) gets 0: no
                # FLOPs gauge and no MFU
                from .goodput import analytic_flops
                flops = analytic_flops(symbol, shapes, training=True) or 0.0
                cache[key] = flops
    except Exception:
        flops = 0.0
    peak = None
    try:
        if device is None:
            import torch
            device = torch.device("cuda" if torch.cuda.is_available()
                                  else "cpu")
        peak = peak_flops_for(device)
    except Exception:
        peak = None
    return StepTimer(loop=loop, flops_per_step=flops, peak_flops=peak,
                     device=device)
