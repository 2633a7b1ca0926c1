"""The port's telemetry HTTP endpoint against the JAX package's: every
route, served on an ephemeral port (0), answers with the reference's
status code and the reference's JSON keys.

Each package's server reads its package's process-wide registry, alert
manager, recorder and ``/healthz`` sections; the test swaps those for
fresh objects holding the same scripted series, so neither side reads
state another test of the same worker left behind (an engine a test did
not close keeps its efficiency section).  Both servers are stopped in
the fixture.
"""
import json
import urllib.error
import urllib.request

import pytest

import mxnet_tpu.telemetry as jt
import mxnet_tpu_torch.telemetry as tt


def _script(pkg):
    """A fresh registry with one series of every family the health
    summary reads, a recorder with two samples of it, an alert manager
    with one rule, and one retained trace; returns (registry, recorder,
    manager, trace id)."""
    reg = pkg.Registry()
    reg.gauge("mxnet_serve_queue_depth", "d", ("engine",)).labels(
        engine="0").set(2)
    occ = reg.histogram("mxnet_serve_batch_occupancy", "o",
                        ("engine", "replica"), pkg.RATIO_BUCKETS)
    occ.labels(engine="0", replica="0").observe(0.5)
    reg.counter("mxnet_serve_requests_total", "r").inc(5)
    reg.gauge("mxnet_serve_decode_slots", "s", ("engine", "replica")) \
        .labels(engine="1", replica="0").set(4)
    reg.counter("mxnet_serve_decode_tokens_total", "t").inc(9)
    reg.counter("mxnet_train_steps_total", "s", ("loop",)).labels(
        loop="fit").inc(3)
    reg.gauge("mxnet_train_mfu", "m", ("loop",)).labels(loop="fit").set(0.1)
    mgr = pkg.AlertManager(registry=reg)
    mgr.add_rule(pkg.AlertRule("depth", "threshold",
                               series="mxnet_serve_queue_depth", op=">",
                               threshold=1.0))
    rec = pkg.HistoryRecorder(interval_s=1.0, window=8, registry=reg,
                              alerts=mgr, start=False)
    rec.sample_now()
    reg.counter("mxnet_serve_requests_total", "r").inc(2)
    rec.sample_now()
    tc = pkg.TraceContext("request", "serve")
    with tc.span("dispatch", "serve"):
        pass
    tc.finish()
    return reg, rec, mgr, tc.trace_id


@pytest.fixture
def servers(monkeypatch):
    """(JAX port, port's port, JAX trace id, port's trace id)."""
    out = []
    for pkg in (jt, tt):
        reg, rec, mgr, tid = _script(pkg)
        monkeypatch.setattr(pkg, "registry", lambda reg=reg: reg)
        monkeypatch.setattr(pkg.recorder, "get_recorder",
                            lambda rec=rec: rec)
        monkeypatch.setattr(pkg.alerts, "default_manager",
                            lambda mgr=mgr: mgr)
        monkeypatch.setattr(pkg.server, "_HEALTHZ_SECTIONS", {})
        pkg.stop_server()
        srv = pkg.start_server(0, host="127.0.0.1")
        out.append((srv.port, tid))
    try:
        yield out[0][0], out[1][0], out[0][1], out[1][1]
    finally:
        jt.stop_server()
        tt.stop_server()


def _get(port, path):
    """(status, content type, body) of one GET."""
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                    timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


ROUTES = ["/metrics", "/metrics.json", "/traces", "/traces/{tid}",
          "/traces/not-a-trace", "/alerts", "/history",
          "/history?series=mxnet_serve_requests_total",
          "/history?series=mxnet_serve_batch_occupancy&q=0.5",
          "/history?series=mxnet_no_such_series",
          "/history?series=mxnet_serve_requests_total&window=x",
          "/timeline", "/timeline?format=chrome", "/timeline?window=x",
          "/healthz", "/", "/no/such/route"]


def _keys(doc):
    """Top-level keys, and the keys of the first row of each list."""
    if isinstance(doc, list):
        return ["[]"] + (_keys(doc[0]) if doc else [])
    if not isinstance(doc, dict):
        return []
    out = sorted(doc)
    for k in sorted(doc):
        if isinstance(doc[k], (dict, list)) and k not in (
                "metrics", "series", "samples", "events", "traceEvents",
                "traces"):
            out.append((k, tuple(map(str, _keys(doc[k])))))
    return out


def test_every_route_answers_as_the_reference(servers):
    jport, tport, jtid, ttid = servers
    for route in ROUTES:
        js, jct, jbody = _get(jport, route.format(tid=jtid))
        ts, tct, tbody = _get(tport, route.format(tid=ttid))
        assert (ts, tct) == (js, jct), route
        if route == "/metrics":
            assert tbody == jbody
            continue
        jdoc, tdoc = json.loads(jbody), json.loads(tbody)
        assert _keys(tdoc) == _keys(jdoc), route
        if route == "/metrics.json":
            assert tdoc["metrics"] == jdoc["metrics"]


def test_health_summary_numbers_match(servers):
    jport, tport, _, _ = servers
    docs = [json.loads(_get(p, "/healthz")[2]) for p in (jport, tport)]
    for d in docs:
        for k in ("uptime_s", "scrape_ts", "scrape_monotonic", "port",
                  "traces_stored"):
            d.pop(k)
    assert docs[1] == docs[0]
    assert docs[1]["queue_depth"] == 2 and docs[1]["decode"]["tokens"] == 9


def test_history_and_alert_values_match(servers):
    jport, tport, _, _ = servers
    route = "/history?series=mxnet_serve_requests_total"
    h = [json.loads(_get(p, route)[2]) for p in (jport, tport)]
    assert [d["delta"] for d in h] == [2.0, 2.0]
    assert [[v for _t, v in d["samples"]] for d in h] == [[5.0, 7.0]] * 2
    a = [json.loads(_get(p, "/alerts")[2]) for p in (jport, tport)]
    assert a[1]["firing"] == a[0]["firing"] == 1
    assert [(s["name"], s["state"]) for s in a[1]["alerts"]] == \
        [(s["name"], s["state"]) for s in a[0]["alerts"]] == \
        [("depth", "firing")]


def test_event_stream_opens_as_the_reference(servers):
    jport, tport, _, _ = servers
    heads = []
    for port in (jport, tport):
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/events?keepalive=0.05" % port,
                timeout=10) as r:
            heads.append((r.status, r.headers.get("Content-Type"),
                          r.read(len(b"retry: 3000\n\n"))))
    assert heads[1] == heads[0] == (200, "text/event-stream",
                                    b"retry: 3000\n\n")
