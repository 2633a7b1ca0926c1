"""The telemetry plane's off-by-default knobs, turned on in the port and in
the JAX package alike, on the CPU: the periodic snapshot file
(``MXNET_TELEMETRY_SNAPSHOT_*``), the flight recorder's bundles
(``MXNET_FLIGHT_RECORDER_DIR``), the server an engine starts
(``MXNET_TELEMETRY_PORT``), the operator's rules file
(``MXNET_TELEMETRY_ALERT_RULES``) and the profiler's autostart
(``MXNET_PROFILER_AUTOSTART``).  Each package runs on a fresh registry
of its own; what one writes must match what the other writes.
"""
import itertools
import json
import os

import pytest

from mxnet_tpu import profiler as jprof
from mxnet_tpu import telemetry as jt
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as tt

_GENERATIONS = itertools.count(7 * 10 ** 6)
#: wall-clock stamps, which differ between any two renders
_WALL = ("scrape_ts", "scrape_monotonic", "wall_time", "pid",
         "thread_stacks")


@pytest.fixture
def fresh(monkeypatch):
    """Each package's telemetry on a fresh registry, alert rules off."""
    monkeypatch.setenv("MXNET_TELEMETRY_ALERTS", "0")
    for pkg in (jt, tt):
        reg = pkg.Registry()
        reg.generation = next(_GENERATIONS)
        monkeypatch.setattr(pkg, "_REGISTRY", reg)
        c = pkg.counter("mxnet_knob_requests_total", "requests",
                        ("engine",))
        c.labels(engine="e0").inc(3)
        pkg.histogram("mxnet_knob_latency_ms", "latency").observe(2.5)
    yield


@pytest.mark.parametrize("fmt", ["prom", "json"])
def test_snapshot_knobs_write_the_reference_document(fresh, monkeypatch,
                                                     tmp_path, fmt):
    docs = {}
    for name, pkg in (("jax", jt), ("torch", tt)):
        path = str(tmp_path / ("%s.%s" % (name, fmt)))
        monkeypatch.setenv("MXNET_TELEMETRY_SNAPSHOT_SECS", "3600")
        monkeypatch.setenv("MXNET_TELEMETRY_SNAPSHOT_PATH", path)
        monkeypatch.setenv("MXNET_TELEMETRY_SNAPSHOT_FORMAT", fmt)
        assert pkg.start_snapshotter() is not None
        pkg.stop_snapshotter()          # writes the final snapshot
        with open(path) as f:
            docs[name] = f.read()
    if fmt == "prom":
        assert docs["torch"] == docs["jax"]
        assert "mxnet_knob_requests_total" in docs["torch"]
    else:
        j, t = (json.loads(docs[k]) for k in ("jax", "torch"))
        for doc in (j, t):
            for key in _WALL:
                doc.pop(key, None)
        assert sorted(t) == sorted(j)
        assert t["metrics"] == j["metrics"]


def test_flight_recorder_dir_writes_the_reference_bundle(fresh, monkeypatch,
                                                         tmp_path):
    bundles = {}
    for name, pkg in (("jax", jt), ("torch", tt)):
        d = str(tmp_path / name)
        monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", d)
        fr = pkg.flight_recorder()
        path = fr.dump("knob-test", detail={"why": "test"})
        assert os.path.dirname(path) == d
        # a second dump of one reason inside the interval is rate-limited
        assert fr.dump("knob-test") is None
        with open(path) as f:
            bundles[name] = json.load(f)
        monkeypatch.delenv("MXNET_FLIGHT_RECORDER_DIR")
        assert pkg.flight_recorder() is None
    j, t = bundles["jax"], bundles["torch"]
    assert sorted(t) == sorted(j)
    for key in ("format", "reason", "detail", "alerts", "metrics"):
        assert t[key] == j[key], key


def test_port_knob_lets_an_engine_own_the_server(fresh, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY_PORT", "0")
    for pkg in (jt, tt):
        pkg.stop_server()
        try:
            assert pkg.server.engine_acquire() is True
            assert pkg.server.engine_acquire() is True
            host, port = pkg.server_address()
            assert port > 0
            pkg.server.engine_release()
            assert pkg.server_address() == (host, port)
            pkg.server.engine_release()     # the last one out stops it
            assert pkg.server_address() is None
        finally:
            pkg.stop_server()


def test_alert_rules_file_loads_as_in_the_reference(monkeypatch, tmp_path):
    rules = [{"name": "knob_depth", "kind": "threshold",
              "series": "mxnet_serve_queue_depth", "op": ">",
              "threshold": 8.0, "for_s": 5.0},
             {"name": "knob_broken", "kind": "nope"},
             {"name": "knob_depth", "kind": "threshold",
              "series": "mxnet_serve_queue_depth"}]
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": rules}))
    monkeypatch.setenv("MXNET_TELEMETRY_ALERT_RULES", str(path))
    states = {}
    for name, pkg in (("jax", jt), ("torch", tt)):
        mgr = pkg.AlertManager()
        with pytest.warns(UserWarning):
            added = pkg.load_rules_file(manager=mgr)
        assert [r.name for r in added] == ["knob_depth"]
        with pytest.warns(UserWarning):
            assert pkg.load_rules_file(manager=mgr) == []   # idempotent
        # since_s is the wall time since the rule was added (rounded to
        # the millisecond), which a loaded host moves between packages
        rows = mgr.states()
        assert all(0 <= r["since_s"] < 60 for r in rows)
        states[name] = [{k: v for k, v in r.items() if k != "since_s"}
                        for r in rows]
    assert states["torch"] == states["jax"]


def test_profiler_autostart_knob(monkeypatch):
    monkeypatch.setenv("MXNET_PROFILER_AUTOSTART", "1")
    for prof in (jprof, tprof):
        registered = []
        monkeypatch.setattr(prof.atexit, "register", registered.append)
        was = prof.is_running()
        prof.profiler_set_state("stop")
        try:
            prof._maybe_autostart()
            assert prof.is_running()
            assert registered == [prof.dump_profile]
        finally:
            prof.profiler_set_state("run" if was else "stop")
