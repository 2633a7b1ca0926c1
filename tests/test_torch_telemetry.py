"""The port's telemetry plane (``mxnet_tpu_torch.telemetry``) and profiler
against the JAX package's, on the CPU.

Every check runs the same operations on one object of each package and
compares what comes out: the JAX side always on a fresh
``mxnet_tpu.telemetry.metrics.Registry()`` or on explicit objects, never
on its process-wide default registry, which other tests in the same
worker share.  Wall-clock fields (``scrape_ts``, ``scrape_monotonic``,
timestamps, durations, trace ids) are dropped before a comparison; every
other byte is held equal.
"""
import json

import pytest

import mxnet_tpu.profiler as jprof
from mxnet_tpu import telemetry as jt
from mxnet_tpu.telemetry import alerts as jalerts
from mxnet_tpu.telemetry import recorder as jrec
from mxnet_tpu.telemetry import sampling as jsamp
from mxnet_tpu.telemetry import timeline as jtl
from mxnet_tpu.telemetry import tracing as jtr
import mxnet_tpu_torch.profiler as tprof
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.telemetry import alerts as talerts
from mxnet_tpu_torch.telemetry import recorder as trec
from mxnet_tpu_torch.telemetry import sampling as tsamp
from mxnet_tpu_torch.telemetry import timeline as ttl
from mxnet_tpu_torch.telemetry import tracing as ttr

WALL = ("scrape_ts", "scrape_monotonic")


def _drive(pkg):
    """One scripted workload of every instrument kind on a fresh
    registry of ``pkg``: labeled and bare counters, gauges (set, inc,
    dec, NaN), histograms on each shared bucket table, a callback, a
    removed series."""
    reg = pkg.Registry()
    c = reg.counter("mxnet_test_requests_total", "requests \"seen\"\nnow",
                    ("engine", "kind"))
    c.labels(engine="0", kind="a").inc()
    c.labels(engine="0", kind="b").inc(2.5)
    c.labels("1", "a").inc(7)
    bare = reg.counter("mxnet_test_bare_total", "bare")
    bare.inc(3)
    g = reg.gauge("mxnet_test_depth", "queue depth", ("engine",))
    g.labels(engine="0").set(4)
    g.labels(engine="0").dec(1.5)
    g.labels(engine="1").set(float("nan"))
    g.labels(engine="2").set(1)
    g.remove(engine="2")
    for name, buckets, vals in (
            ("mxnet_test_latency_ms", pkg.LATENCY_MS_BUCKETS,
             (0.05, 0.3, 2.5, 7.0, 9000.0)),
            ("mxnet_test_latency_seconds", pkg.LATENCY_S_BUCKETS,
             (1e-5, 3e-3, 0.2)),
            ("mxnet_test_ratio", pkg.RATIO_BUCKETS, (0.0, 0.5, 0.99, 1.0)),
            ("mxnet_test_bytes", pkg.BYTES_BUCKETS, (100.0, 5e6, 1e9))):
        h = reg.histogram(name, name, ("bucket",), buckets)
        for i, v in enumerate(vals):
            h.labels(bucket=str(i % 2)).observe(v)
    reg.register_callback(
        lambda r: r.gauge("mxnet_test_refreshed", "set at collect").set(42))
    return reg


@pytest.fixture(scope="module")
def registries():
    return _drive(jt), _drive(tt)


def test_prometheus_text_is_byte_identical(registries):
    jreg, treg = registries
    jtext = jt.render_prometheus(jreg)
    assert "mxnet_test_latency_ms_bucket" in jtext
    assert tt.render_prometheus(treg) == jtext
    assert jreg.instrument_calls() == treg.instrument_calls()


def test_json_document_is_equal_but_wall_clock(registries):
    jreg, treg = registries
    jdoc = json.loads(jt.render_json(jreg, include_traces=False))
    tdoc = json.loads(tt.render_json(treg, include_traces=False))
    for d in (jdoc, tdoc):
        for k in WALL + ("timeline",):
            d.pop(k, None)
    assert tdoc == jdoc
    assert tdoc["format"] == "mxnet_tpu.telemetry/1"


@pytest.mark.parametrize("names", [
    ["mxnet_serve_requests_total", "mxnet_train_mfu"],
    ["serve_requests_total", "mxnet_Serve", "mxnet_ok_total", "x",
     "mxnet__", "mxnet_a-b"],
])
def test_lint_metric_names_agrees(names):
    text = "".join("# HELP %s doc\n# TYPE %s counter\n%s 1\n" % (n, n, n)
                   for n in names)
    assert tt.lint_metric_names(text) == jt.lint_metric_names(text)


def test_registry_lint_and_name_pattern_agree(registries):
    jreg, treg = registries
    assert tt.lint_metric_names(registry=treg) == \
        jt.lint_metric_names(registry=jreg) == []
    assert tt.METRIC_NAME_RE.pattern == jt.METRIC_NAME_RE.pattern


def test_sampler_chains_keep_the_same_requests():
    """The same latency sequence through each package's chain (periodic
    floor, tail top-K with its moving p99, error keep) keeps the same
    requests for the same reasons."""
    lat = [((i * 37) % 101) / 10.0 + (50.0 if i % 97 == 0 else 0.0)
           for i in range(400)]
    fails = {i: "ShedError" for i in range(3, 400, 61)}
    out = []
    for mod in (jsamp, tsamp):
        chain = mod.SamplerChain([mod.PeriodicSampler(16),
                                  mod.TailSampler(4), mod.ErrorSampler()])
        out.append([chain.decide(ms, fails.get(i))
                    for i, ms in enumerate(lat)])
    assert out[1] == out[0]
    assert sum(k for k, _ in out[0]) > 25


def _tree(node):
    """A span tree without times, ids or wall anchors."""
    return (node["name"], node.get("cat"),
            json.dumps(node.get("meta"), sort_keys=True),
            [_tree(c) for c in node.get("children", [])])


def _build_trace(tr):
    tc = tr.TraceContext("request", "serve")
    t = tc.root.t0
    with tc.span("queue-wait", "serve"):
        pass
    with tc.span("dispatch", "serve", meta={"bucket": 4}):
        with tc.span("compile", "serve"):
            pass
        tc.add("kernel", t, t + 1e-4, "op", meta={"n": 1})
    tc.add("unpad", t, t + 2e-4, "serve")
    tc.finish()
    return tc.to_dict()


def test_span_trees_have_the_same_names_and_parents():
    jd, td = _build_trace(jtr), _build_trace(ttr)
    assert sorted(td) == sorted(jd)
    assert sorted(td["root"]) == sorted(jd["root"])
    assert _tree(td["root"]) == _tree(jd["root"])


def _timeline_chrome(tl_mod):
    tl = tl_mod.Timeline(capacity=64)
    import time
    t0 = time.perf_counter()
    tl.complete("serve.dispatch", "serve", "replica:0", t0, t0 + 1e-3,
                args={"bucket": 4})
    tl.instant("decode.join", "decode", "decode:0", args={"slot": 1})
    tl.counter("serve.queue_depth", "serve", "serve", 3)
    doc = tl_mod.export_chrome_trace(tl.events())
    return doc


def test_timeline_chrome_traces_match():
    jd, td = _timeline_chrome(jtl), _timeline_chrome(ttl)
    assert sorted(td) == sorted(jd)
    assert td["otherData"] == jd["otherData"]
    assert [(e["ph"], e["name"], sorted(e)) for e in td["traceEvents"]] \
        == [(e["ph"], e["name"], sorted(e)) for e in jd["traceEvents"]]


def _profile(prof):
    prof.clear()
    prof.profiler_set_state("run")
    try:
        with prof.record_span("forward", "forward"):
            pass
        import time
        t = time.perf_counter()
        prof.add_span_event("dispatch", "serve", t, t + 1e-4,
                            args={"trace_id": "x"})
        prof.instant("epoch", "marker")
        prof.counter("serve.queue_depth", 2)
        return json.loads(prof.dumps())
    finally:
        prof.profiler_set_state("stop")
        prof.clear()


def test_profiler_chrome_traces_match():
    jd, td = _profile(jprof), _profile(tprof)
    assert sorted(td) == sorted(jd)
    assert sorted(td["otherData"]) == sorted(jd["otherData"])
    assert [(e["ph"], e["name"], e["cat"], sorted(e))
            for e in td["traceEvents"]] == \
        [(e["ph"], e["name"], e["cat"], sorted(e))
         for e in jd["traceEvents"]]


def test_profiler_dump_writes_the_ring(tmp_path):
    path = str(tmp_path / "profile.json")
    tprof.profiler_set_config(filename=path)
    tprof.profiler_set_state("run")
    try:
        with tprof.record_span("forward", "forward"):
            pass
        assert tprof.dump_profile() == path
    finally:
        tprof.profiler_set_state("stop")
        tprof.profiler_set_config(filename="profile.json")
    with open(path) as f:
        doc = json.load(f)
    assert [e["name"] for e in doc["traceEvents"]] == ["forward"]
    assert doc["otherData"]["dropped_events"] == 0


def test_device_capture_on_the_cpu_writes_a_chrome_trace(tmp_path):
    import torch
    tprof.start_xla_trace(str(tmp_path))
    (torch.ones(8) * 2).sum()
    path = tprof.stop_xla_trace()
    with open(path) as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(RuntimeError):
        tprof.stop_xla_trace()


def _alert_run(pkg, rec_mod, alerts_mod):
    """Four samples of one registry through each package's recorder and
    alert manager: a threshold rule on the latest value, a delta rule,
    an absence rule; returns every rule's state after each sample."""
    reg = pkg.Registry()
    depth = reg.gauge("mxnet_test_depth", "d", ("engine",))
    shed = reg.counter("mxnet_test_shed_total", "s")
    mgr = alerts_mod.AlertManager(registry=reg)
    mgr.add_rule(alerts_mod.AlertRule(
        "depth_high", "threshold", series="mxnet_test_depth",
        labels={"engine": "0"}, op=">", threshold=5.0))
    mgr.add_rule(alerts_mod.AlertRule(
        "shedding", "threshold", series="mxnet_test_shed_total",
        query="delta", window_s=3600.0, op=">=", threshold=2.0))
    mgr.add_rule(alerts_mod.AlertRule(
        "gone", "absence", series="mxnet_test_missing"))
    rec = rec_mod.HistoryRecorder(interval_s=1.0, window=16, registry=reg,
                                  alerts=mgr, start=False)
    out = []
    for d, s in ((1.0, 0), (9.0, 1), (9.0, 2), (2.0, 0)):
        depth.labels(engine="0").set(d)
        if s:
            shed.inc(s)
        rec.sample_now()
        out.append({st["name"]: st["state"] for st in mgr.states()})
    return out


def test_alert_rules_fire_on_the_same_samples():
    jout = _alert_run(jt, jrec, jalerts)
    tout = _alert_run(tt, trec, talerts)
    assert tout == jout
    assert any(s == "firing" for step in jout for s in step.values())


#: the reference's names the port leaves out: the flight recorder's ring
#: file, whose reader (tools/telemetry_dump.py) is not ported, and the
#: cross-host snapshot push, whose caller (KVStoreDist) is not ported
NOT_PORTED = {"RingFile", "ring_file", "start_rank_snapshotter"}


def test_public_names_match_the_reference():
    assert set(tt.__all__) == set(jt.__all__) - NOT_PORTED
    for name in ("profiler_set_config", "profiler_set_state",
                 "dump_profile", "clear", "start_xla_trace",
                 "stop_xla_trace", "record_span", "add_span_event",
                 "dumps", "set_max_events"):
        assert callable(getattr(tprof, name)) and hasattr(jprof, name)

