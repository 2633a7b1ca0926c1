"""SLO rule engine: declarative alert rules over the in-process history.

Evaluated by the :class:`~mxnet_tpu_torch.telemetry.recorder.HistoryRecorder`
sampler thread after every sample, so the evaluation interval IS the
sampling interval — no external Prometheus, no alertmanager sidecar.
Four declarative rule kinds cover the serving SLO surface:

- ``threshold`` — compare one query (``latest`` gauge value, or
  ``delta``/``rate`` of a counter over ``window_s``) against a bound;
- ``burn_rate`` — the SRE-workbook multiwindow burn: the error ratio
  ``sum(delta(num)) / delta(den)`` must exceed ``factor * budget``
  over BOTH the short and the long window before firing (fast spikes
  alone don't page, slow leaks alone don't page late);
- ``absence`` — a series expected to exist stopped scraping (or never
  appeared): instrumentation rot is itself an incident;
- ``watchdog`` — a named heartbeat (recorder.heartbeats(): engine
  worker loops stamp ``last_progress``) is BUSY yet made no progress
  for ``threshold`` seconds — a wedged dispatch or starved queue,
  named, not inferred.

Each rule runs a Prometheus-style state machine:
``inactive -> pending (expr true, waiting out for_s) -> firing ->
inactive (resolved)``, with two flap suppressors: ``for_s`` keeps a
blip from firing, ``resolve_after_s`` keeps a brief dip from
resolve/refire churn.  Transitions are counted
(``mxnet_telemetry_alert_transitions_total{rule,state}``), the current
per-rule state and the process firing count are gauges, every
transition is pushed to SSE ``/events`` subscribers, and a transition
to *firing* triggers the flight recorder (recorder.py) when
``MXNET_FLIGHT_RECORDER_DIR`` is configured.

Engines register a default rule set at construction
(:func:`register_engine_default_rules`: queue-saturation and
deadline-miss-budget burn rates shared across engines with refcounts,
plus per-engine zero-progress watchdog and retrace-storm rules) and
remove it at ``close()`` — reload loops leak neither rules nor their
metric series.
"""
from __future__ import annotations

import json
import threading
import time
import warnings

from ..base import MXNetError
from ..locks import named_lock

__all__ = ["AlertRule", "AlertManager", "default_manager",
           "register_engine_default_rules", "load_rules_file"]

_KINDS = ("threshold", "burn_rate", "absence", "watchdog")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


class AlertRule(object):
    """One declarative rule.  Fields by kind (unused ones ignored):

    threshold: ``series``, ``labels`` (subset match), ``query`` in
        {"latest", "delta", "rate"}, ``window_s``, ``op``, ``threshold``
    burn_rate: ``num`` (series name or tuple of names, deltas summed),
        ``num_labels``, ``den``, ``den_labels``, ``budget`` (error
        budget fraction, e.g. 0.01), ``factor`` (burn multiple, 14.4 =
        the 1h/5m page tier), ``short_window_s``, ``long_window_s``
    absence: ``series``, ``labels`` — fires when the series is missing
        from the latest sample
    watchdog: ``heartbeat`` (name registered via
        recorder.register_heartbeat), ``threshold`` (stall seconds)

    Common: ``for_s`` (pending dwell before firing),
    ``resolve_after_s`` (false dwell before resolving), ``severity``,
    ``annotations`` (small JSON-able dict; engines stamp their label
    here so a firing rule names its engine).
    """
    __slots__ = ("name", "kind", "series", "labels", "query", "window_s",
                 "op", "threshold", "num", "num_labels", "den",
                 "den_labels", "budget", "factor", "short_window_s",
                 "long_window_s", "heartbeat", "for_s",
                 "resolve_after_s", "severity", "annotations")

    def __init__(self, name, kind, series=None, labels=None,
                 query="latest", window_s=60.0, op=">", threshold=0.0,
                 num=None, num_labels=None, den=None, den_labels=None,
                 budget=0.01, factor=14.4, short_window_s=60.0,
                 long_window_s=600.0, heartbeat=None, for_s=0.0,
                 resolve_after_s=0.0, severity="page", annotations=None):
        if kind not in _KINDS:
            raise MXNetError("unknown alert rule kind %r (use one of %s)"
                             % (kind, list(_KINDS)))
        if op not in _OPS:
            raise MXNetError("unknown alert rule op %r" % (op,))
        if kind == "threshold" and not series:
            raise MXNetError("threshold rule %r needs a series" % name)
        if kind == "burn_rate" and (not num or not den):
            raise MXNetError("burn_rate rule %r needs num and den" % name)
        if kind == "absence" and not series:
            raise MXNetError("absence rule %r needs a series" % name)
        if kind == "watchdog" and not heartbeat:
            raise MXNetError("watchdog rule %r needs a heartbeat" % name)
        self.name = name
        self.kind = kind
        self.series = series
        self.labels = dict(labels) if labels else None
        self.query = query
        self.window_s = float(window_s)
        self.op = op
        self.threshold = float(threshold)
        self.num = ((num,) if isinstance(num, str) else
                    tuple(num) if num else None)
        self.num_labels = dict(num_labels) if num_labels else None
        self.den = den
        self.den_labels = dict(den_labels) if den_labels else None
        self.budget = float(budget)
        self.factor = float(factor)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.heartbeat = heartbeat
        self.for_s = float(for_s)
        self.resolve_after_s = float(resolve_after_s)
        self.severity = severity
        self.annotations = dict(annotations) if annotations else {}

    # ------------------------------------------------------- serialization
    def to_dict(self):
        d = {"name": self.name, "kind": self.kind,
             "for_s": self.for_s, "resolve_after_s": self.resolve_after_s,
             "severity": self.severity}
        if self.annotations:
            d["annotations"] = dict(self.annotations)
        if self.kind == "threshold":
            d.update(series=self.series, query=self.query,
                     window_s=self.window_s, op=self.op,
                     threshold=self.threshold)
            if self.labels:
                d["labels"] = dict(self.labels)
        elif self.kind == "burn_rate":
            d.update(num=list(self.num), den=self.den,
                     budget=self.budget, factor=self.factor,
                     short_window_s=self.short_window_s,
                     long_window_s=self.long_window_s)
            if self.num_labels:
                d["num_labels"] = dict(self.num_labels)
            if self.den_labels:
                d["den_labels"] = dict(self.den_labels)
        elif self.kind == "absence":
            d.update(series=self.series)
            if self.labels:
                d["labels"] = dict(self.labels)
        elif self.kind == "watchdog":
            d.update(heartbeat=self.heartbeat, threshold=self.threshold)
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        return cls(d.pop("name"), d.pop("kind"), **d)

    # ----------------------------------------------------------- evaluation
    def evaluate(self, recorder, now=None, heartbeats=None):
        """(active, value, detail) against one recorder.  ``active`` is
        None when there is not yet enough history to decide — the
        state machine treats that as condition-false (a pending rule
        whose data window slides empty cancels, Prometheus-style).
        ``heartbeats`` lets the manager poll every heartbeat callback
        ONCE per evaluation cycle and share the snapshot across its
        watchdog rules (O(N) instead of O(N^2) with N engines)."""
        if self.kind == "threshold":
            if self.query == "latest":
                v = recorder.latest(self.series, self.labels)
            elif self.query == "delta":
                v = recorder.delta(self.series, self.labels,
                                   self.window_s, now)
            elif self.query == "rate":
                v = recorder.rate(self.series, self.labels,
                                  self.window_s, now)
            else:
                raise MXNetError("unknown threshold query %r"
                                 % (self.query,))
            if v is None:
                return None, None, None
            return _OPS[self.op](v, self.threshold), v, None
        if self.kind == "burn_rate":
            ratios = {}
            for tag, w in (("short", self.short_window_s),
                           ("long", self.long_window_s)):
                den = recorder.delta(self.den, self.den_labels, w, now)
                if den is None:
                    return None, None, None
                num = 0.0
                for series in self.num:
                    d = recorder.delta(series, self.num_labels, w, now)
                    if d:
                        num += d
                if den > 0:
                    ratios[tag] = num / den
                else:
                    ratios[tag] = 1.0 if num > 0 else 0.0
            bound = self.factor * self.budget
            active = all(r > bound for r in ratios.values())
            return active, ratios["short"], {
                "short_ratio": ratios["short"],
                "long_ratio": ratios["long"], "burn_bound": bound}
        if self.kind == "absence":
            v = recorder.latest(self.series, self.labels)
            return v is None, v, None
        if self.kind == "watchdog":
            if heartbeats is None:
                from . import recorder as _rec
                heartbeats = _rec.heartbeats()
            hb = heartbeats.get(self.heartbeat)
            if hb is None:
                return None, None, None
            stalled = bool(hb.get("busy")) and \
                float(hb.get("age_s", 0.0)) > self.threshold
            return stalled, float(hb.get("age_s", 0.0)), hb
        raise MXNetError("unreachable rule kind %r" % (self.kind,))


class _RuleState(object):
    __slots__ = ("rule", "state", "since", "pending_since", "false_since",
                 "value", "detail", "fired_count", "last_error",
                 "owners", "refs", "shared")

    def __init__(self, rule, owner, shared):
        self.rule = rule
        self.state = "inactive"
        self.since = time.monotonic()
        self.pending_since = None
        self.false_since = None
        self.value = None
        self.detail = None
        self.fired_count = 0
        self.last_error = None
        self.owners = {owner} if owner else set()
        self.refs = 1
        self.shared = shared


class AlertManager(object):
    """Rule set + state machines + transition accounting.

    Thread-safety: rules are added/removed from engine constructors and
    ``close()`` while the recorder thread evaluates; one lock guards
    the rule table, evaluation runs over a snapshot of it.
    """

    def __init__(self, registry=None):
        self._lock = named_lock("telemetry.alerts")
        self._states = {}
        self._registry = registry
        self.last_eval = None        # monotonic of the last evaluate()

    def _reg(self):
        if self._registry is not None:
            return self._registry
        from . import registry as _default
        return _default()

    # ------------------------------------------------------------- rules
    def add_rule(self, rule, owner=None, shared=False):
        """Register a rule.  ``shared=True`` refcounts by name: two
        engines adding the same shared rule hold one rule with two
        references, and it survives until the last owner removes it."""
        with self._lock:
            st = self._states.get(rule.name)
            if st is not None:
                if shared and st.shared:
                    st.refs += 1
                    if owner:
                        st.owners.add(owner)
                    return st.rule
                raise MXNetError("alert rule %r already registered"
                                 % rule.name)
            self._states[rule.name] = _RuleState(rule, owner, shared)
            return rule

    def remove_rule(self, name):
        """Drop one reference to a rule; the last reference removes it
        AND reclaims its per-rule metric series (reload loops must not
        grow scrapes).  No-op when absent."""
        with self._lock:
            st = self._states.get(name)
            if st is None:
                return
            st.refs -= 1
            if st.refs > 0:
                return
            del self._states[name]
        self._reclaim_series(name)

    def remove_owner(self, owner):
        """Drop every reference ``owner`` holds (engine close path)."""
        with self._lock:
            names = [n for n, st in self._states.items()
                     if owner in st.owners]
        for name in names:
            with self._lock:
                st = self._states.get(name)
                if st is None:
                    continue
                st.owners.discard(owner)
                st.refs -= 1
                if st.refs > 0:
                    continue
                del self._states[name]
            self._reclaim_series(name)

    def _reclaim_series(self, name):
        reg = self._reg()
        fam = reg.get("mxnet_telemetry_alert_transitions_total")
        if fam is not None:
            for values, _inst in fam.series():
                if values and values[0] == name:
                    fam.remove(*values)
        fam = reg.get("mxnet_telemetry_alert_state")
        if fam is not None:
            fam.remove(rule=name)

    def rules(self):
        with self._lock:
            return [st.rule for st in self._states.values()]

    def state_of(self, name):
        """One rule's current state machine position (``"inactive"`` /
        ``"pending"`` / ``"firing"``), or None when the rule is not
        registered — the overload regulator's per-cycle read."""
        with self._lock:
            st = self._states.get(name)
            return st.state if st is not None else None

    def __len__(self):
        with self._lock:
            return len(self._states)

    # -------------------------------------------------------- evaluation
    def evaluate(self, recorder, now=None):
        """Run every rule's state machine against ``recorder``.
        Called by the recorder thread after each sample; safe to call
        manually (tests drive time explicitly through ``now``)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            states = list(self._states.values())
        # one heartbeat sweep shared by every watchdog rule this cycle
        hbs = None
        if any(st.rule.kind == "watchdog" for st in states):
            from . import recorder as _rec
            hbs = _rec.heartbeats()
        firing = 0
        for st in states:
            try:
                active, value, detail = st.rule.evaluate(recorder, now,
                                                         heartbeats=hbs)
                st.last_error = None
            except Exception as e:
                st.last_error = repr(e)
                continue
            st.value = value
            if detail is not None:
                st.detail = detail
            self._step(st, bool(active), now, recorder)
            if st.state == "firing":
                firing += 1
        self.last_eval = now
        reg = self._reg()
        reg.gauge("mxnet_telemetry_alerts_firing",
                  "alert rules currently in the firing state").set(firing)
        state_fam = reg.gauge(
            "mxnet_telemetry_alert_state",
            "per-rule alert state: 0 inactive, 1 pending, 2 firing",
            labelnames=("rule",))
        code = {"inactive": 0, "pending": 1, "firing": 2}
        for st in states:
            with self._lock:
                live = st.rule.name in self._states
            if live:
                state_fam.labels(rule=st.rule.name).set(
                    code.get(st.state, 0))
        return firing

    def _step(self, st, active, now, recorder):
        rule = st.rule
        if st.state == "inactive":
            if active:
                if rule.for_s > 0:
                    st.state, st.since = "pending", now
                    st.pending_since = now
                    self._transition(st, "inactive", "pending", recorder)
                else:
                    self._fire(st, "inactive", now, recorder)
        elif st.state == "pending":
            if not active:
                st.state, st.since = "inactive", now
                st.pending_since = None
                self._transition(st, "pending", "cancelled", recorder)
            elif now - st.pending_since >= rule.for_s:
                self._fire(st, "pending", now, recorder)
        elif st.state == "firing":
            if active:
                st.false_since = None
            else:
                if st.false_since is None:
                    st.false_since = now
                if now - st.false_since >= rule.resolve_after_s:
                    st.state, st.since = "inactive", now
                    st.false_since = None
                    self._transition(st, "firing", "resolved", recorder)

    def _fire(self, st, prev, now, recorder):
        st.state, st.since = "firing", now
        st.pending_since = None
        st.false_since = None
        st.fired_count += 1
        self._transition(st, prev, "firing", recorder)
        # the black box: a firing rule (watchdog trips included) dumps
        # a post-mortem bundle while the process can still write one
        try:
            from .recorder import flight_recorder
            fr = flight_recorder()
            if fr is not None:
                fr.dump("alert:%s" % st.rule.name,
                        detail=self._state_dict(st, now),
                        recorder=recorder, alerts=self)
        except Exception:
            pass

    def _transition(self, st, prev, to, recorder):
        reg = self._reg()
        reg.counter(
            "mxnet_telemetry_alert_transitions_total",
            "alert state-machine transitions by rule and entered state "
            "(pending / firing / resolved / cancelled)",
            labelnames=("rule", "state")).labels(
                rule=st.rule.name, state=to).inc()
        from . import timeline
        timeline.instant("alert." + to, "alerts", "alerts",
                         args={"rule": st.rule.name, "from": prev,
                               "value": st.value})
        try:
            from .server import publish_event
            publish_event("alert", {
                "rule": st.rule.name, "from": prev, "to": to,
                "value": st.value, "detail": st.detail,
                "severity": st.rule.severity,
                "annotations": st.rule.annotations})
        except Exception:
            pass

    # ---------------------------------------------------------- rendering
    def _state_dict(self, st, now=None):
        now = time.monotonic() if now is None else now
        d = {"name": st.rule.name, "kind": st.rule.kind,
             "state": st.state, "since_s": round(now - st.since, 3),
             "value": st.value, "severity": st.rule.severity,
             "fired_count": st.fired_count,
             "rule": st.rule.to_dict()}
        if st.rule.annotations:
            d["annotations"] = dict(st.rule.annotations)
        if st.detail is not None:
            d["detail"] = st.detail
        if st.last_error is not None:
            d["error"] = st.last_error
        if st.shared:
            d["shared_refs"] = st.refs
        return d

    def states(self, now=None):
        """JSON-able state rows for every rule, firing first — what
        ``GET /alerts`` serves and the flight bundle embeds."""
        with self._lock:
            states = list(self._states.values())
        order = {"firing": 0, "pending": 1, "inactive": 2}
        rows = [self._state_dict(st, now) for st in states]
        rows.sort(key=lambda r: (order.get(r["state"], 3), r["name"]))
        return rows

    def firing(self):
        with self._lock:
            return sum(1 for st in self._states.values()
                       if st.state == "firing")


_DEFAULT = AlertManager()


def default_manager():
    """The process-wide manager engines register their default rules
    against and the recorder singleton evaluates."""
    return _DEFAULT


def load_rules_file(path=None, manager=None):
    """Load declarative AlertRules from a JSON file into ``manager``
    (default: the process manager) — the operator's no-redeploy SLO
    surface (``MXNET_TELEMETRY_ALERT_RULES``).

    The file is either a bare JSON list of :meth:`AlertRule.from_dict`
    dicts or a ``{"rules": [...]}`` document.  Loading is defensive by
    design — a typo'd rules file must never take down the serving
    process it monitors: a missing/malformed file warns and loads
    nothing, an invalid rule dict warns and skips that rule, and a
    rule whose name is already registered is skipped silently (the
    loader runs on every engine-driven recorder rebuild, so it must be
    idempotent).  Each loaded rule is stamped with a ``source``
    annotation naming the file, so ``GET /alerts`` and flight bundles
    show where an SLO came from.  Returns the rules actually added.
    """
    from .. import config
    if path is None:
        path = config.get("MXNET_TELEMETRY_ALERT_RULES")
    if not path:
        return []
    mgr = manager if manager is not None else default_manager()
    try:
        with open(path) as f:
            doc = json.load(f)
    except Exception as e:
        warnings.warn("MXNET_TELEMETRY_ALERT_RULES: cannot load %r "
                      "(%s); no operator rules registered" % (path, e))
        return []
    rows = doc.get("rules") if isinstance(doc, dict) else doc
    if not isinstance(rows, list):
        warnings.warn("MXNET_TELEMETRY_ALERT_RULES: %r must be a JSON "
                      "list of rule dicts (or {'rules': [...]}); got "
                      "%s" % (path, type(rows).__name__))
        return []
    added = []
    for i, row in enumerate(rows):
        try:
            rule = AlertRule.from_dict(row)
        except Exception as e:
            warnings.warn("MXNET_TELEMETRY_ALERT_RULES: rule %d in %r "
                          "is invalid (%s); skipped" % (i, path, e))
            continue
        rule.annotations.setdefault("source", path)
        try:
            mgr.add_rule(rule, owner="rules-file")
        except MXNetError:
            continue        # already registered: idempotent reload
        added.append(rule)
    return added


def register_engine_default_rules(kind, engine_label, watchdog_s=None,
                                  aot=False):
    """The default SLO rule set one engine contributes:

    - ``serve_queue_saturation_burn`` (shared): rejected+shed over
      submitted requests burning a 1% availability budget at 14.4x
      over 1m AND 10m — saturation that admission control is already
      paying for;
    - ``serve_deadline_miss_burn`` (shared): queued expiries + decode
      mid-generation evictions over requests against the same budget —
      the p99 deadline-miss SLO;
    - ``serve_goodput_collapse_burn`` (shared): padding + dead-slot
      FLOPs over total dispatched FLOPs (the efficiency
      ledger) burning a 5% waste budget at 14.4x — fires when more
      than ~72% of the fleet's compute is bucket padding and masked
      decode slots for a sustained window (collapsed occupancy,
      pathological bucket fit), NOT on speculative rejections, which
      are a deliberate latency trade;
    - ``<kind>_engine<N>_stalled``: zero-progress watchdog over this
      engine's worker heartbeat (busy + no progress for
      ``MXNET_TELEMETRY_WATCHDOG_SECS``);
    - ``serve_engine<N>_retrace_storm`` (one-shot engines): any
      post-warmup retrace delta in 2 minutes — the compile-once
      contract breaking under live traffic;
    - ``<kind>_engine<N>_aot_reject`` (``aot=True`` — engines with a
      persistent AOT program cache): any reject delta in 2 minutes —
      a cold start that should have been warm (cache entries present
      but unusable: corruption or fingerprint drift).  The flight
      bundle the firing dumps captures the engine's stats(), whose
      ``aot.last_reject`` block names the offending key.

    Returns the owner token to pass to
    ``default_manager().remove_owner(...)`` at close.
    """
    from .. import config
    if watchdog_s is None:
        watchdog_s = config.get("MXNET_TELEMETRY_WATCHDOG_SECS")
    mgr = default_manager()
    owner = "%s:%s" % (kind, engine_label)
    mgr.add_rule(AlertRule(
        "%s_engine%s_stalled" % (kind, engine_label), "watchdog",
        heartbeat="%s.%s" % (kind, engine_label), threshold=watchdog_s,
        annotations={"engine": engine_label, "kind": kind,
                     "summary": "worker busy with zero progress — "
                                "wedged dispatch or starved queue"}),
        owner=owner)
    if kind == "serve":
        mgr.add_rule(AlertRule(
            "serve_engine%s_retrace_storm" % engine_label, "threshold",
            series="mxnet_serve_retraces_total",
            labels={"engine": engine_label}, query="delta",
            window_s=120.0, op=">", threshold=0.0,
            annotations={"engine": engine_label,
                         "summary": "post-warmup program builds observed "
                                    "— compile-once contract broken"}),
            owner=owner)
    if aot:
        mgr.add_rule(AlertRule(
            "%s_engine%s_aot_reject" % (kind, engine_label),
            "threshold",
            series="mxnet_serve_aot_rejects_total",
            labels={"engine": engine_label}, query="delta",
            window_s=120.0, op=">", threshold=0.0,
            annotations={"engine": engine_label, "kind": kind,
                         "summary": "cold start that should have been "
                                    "warm: AOT-cache entries present "
                                    "but unusable (corruption or "
                                    "fingerprint drift); the bundle's "
                                    "engine stats aot.last_reject "
                                    "names the key"}),
            owner=owner)
    mgr.add_rule(AlertRule(
        "serve_queue_saturation_burn", "burn_rate",
        num=("mxnet_serve_rejected_total", "mxnet_serve_shed_total"),
        den="mxnet_serve_requests_total", budget=0.01, factor=14.4,
        short_window_s=60.0, long_window_s=600.0,
        annotations={"slo": "availability",
                     "summary": "admission queue saturated: requests "
                                "rejected/shed are burning the 1% "
                                "availability budget at page rate"}),
        owner=owner, shared=True)
    mgr.add_rule(AlertRule(
        "serve_deadline_miss_burn", "burn_rate",
        num=("mxnet_serve_expired_total",
             "mxnet_serve_decode_evictions_total"),
        den="mxnet_serve_requests_total", budget=0.01, factor=14.4,
        short_window_s=60.0, long_window_s=600.0,
        annotations={"slo": "deadline",
                     "summary": "deadline misses (queued expiries + "
                                "mid-generation evictions) are burning "
                                "the 1% latency budget at page rate"}),
        owner=owner, shared=True)
    mgr.add_rule(AlertRule(
        "serve_goodput_collapse_burn", "burn_rate",
        num=("mxnet_serve_flops_padding_total",
             "mxnet_serve_flops_dead_slot_total"),
        den="mxnet_serve_flops_total", budget=0.05, factor=14.4,
        short_window_s=60.0, long_window_s=600.0,
        annotations={"slo": "goodput",
                     "summary": "serving goodput collapsed: bucket "
                                "padding + dead decode slots are "
                                "burning the 5% waste-FLOPs budget at "
                                "page rate (collapsed occupancy or "
                                "pathological bucket fit — see "
                                "stats()[...]['efficiency'] and "
                                "tools/serve_report.py)"}),
        owner=owner, shared=True)
    return owner
