"""The serving engines' telemetry in the port against the JAX package, on
the CPU: a small ``ServingEngine`` (an MLP with a softmax head) and a
small ``DecodeEngine`` (``perf/decode_bench.build_spec_models``' decoder at
one block) in both packages, fed the same requests, each package on a
fresh registry of its own.

Held: the same metric families (apart from ``UNPORTED``, the families of
machinery the port does not have: the AOT program cache and the replica
set), the same label sets, and equal counts of requests, admissions,
sheds, batches, bucket elements, tokens, steps, joins and leaves.  Within
the port, telemetry off leaves ``instrument_calls()`` where it was across
a served request and a decode step, and outputs and tokens are bit-equal
with it on and off.
"""
import importlib.util
import itertools
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jt
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as tt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: families of machinery the port lacks (ROADMAP Queue A item 7)
UNPORTED = {"mxnet_serve_aot_hits_total", "mxnet_serve_aot_misses_total",
            "mxnet_serve_aot_writes_total", "mxnet_serve_aot_rejects_total",
            "mxnet_serve_aot_prunes_total", "mxnet_serve_replicas",
            "mxnet_serve_replica_healthy", "mxnet_serve_replica_inflight",
            "mxnet_serve_replica_failures_total",
            "mxnet_serve_replica_shards"}

COUNTED = ("mxnet_serve_requests_total", "mxnet_serve_admitted_total",
           "mxnet_serve_rejected_total", "mxnet_serve_shed_total",
           "mxnet_serve_regulator_shed_total", "mxnet_serve_batches_total",
           "mxnet_serve_replica_batches_total",
           "mxnet_serve_padded_elements_total",
           "mxnet_serve_live_elements_total",
           "mxnet_serve_shape_signature_total",
           "mxnet_serve_decode_tokens_total",
           "mxnet_serve_decode_steps_total", "mxnet_serve_decode_joins_total",
           "mxnet_serve_decode_leaves_total",
           "mxnet_serve_decode_live_slot_steps_total",
           "mxnet_serve_decode_dead_slot_steps_total",
           "mxnet_serve_flops_total", "mxnet_serve_flops_useful_total",
           "mxnet_serve_flops_padding_total",
           "mxnet_serve_flops_dead_slot_total")

_GENERATIONS = itertools.count(2 * 10 ** 6)
FEATURE, HIDDEN, CLASSES = 6, 16, 3
SLOTS, MAX_LEN = 4, 32
PROMPTS = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10], [11], [12, 13]]
NEW = [3, 5, 2, 4, 6, 3]


@pytest.fixture
def fresh(monkeypatch):
    """Fresh registries (generations no memoized child has seen), alert
    rules and the history recorder off, so nothing lands in either
    package's process-wide state."""
    monkeypatch.setenv("MXNET_TELEMETRY_ALERTS", "0")
    monkeypatch.setenv("MXNET_TELEMETRY_HISTORY_SECS", "0")
    regs = []
    for pkg in (jt, tt):
        reg = pkg.Registry()
        reg.generation = next(_GENERATIONS)
        monkeypatch.setattr(pkg, "_REGISTRY", reg)
        regs.append(reg)
    yield regs


def _counts(reg):
    out = {}
    for name, fam in reg.collect().items():
        out[name] = {tuple(sorted(s["labels"].items())):
                     s["count"] if fam["kind"] == "histogram"
                     else s["value"] for s in fam["series"]}
    return out


def _mlp():
    rng = np.random.default_rng(0)
    return {"fc1_weight": rng.standard_normal((HIDDEN, FEATURE)),
            "fc1_bias": np.zeros(HIDDEN),
            "fc2_weight": rng.standard_normal((CLASSES, HIDDEN)),
            "fc2_bias": np.zeros(CLASSES)}


def _net(pkg):
    s = pkg.sym
    net = s.FullyConnected(s.Variable("data"), num_hidden=HIDDEN,
                           name="fc1")
    net = s.Activation(net, act_type="relu", name="relu1")
    net = s.FullyConnected(net, num_hidden=CLASSES, name="fc2")
    return s.SoftmaxOutput(net, name="softmax")


def _serve(pkg, serving):
    """Stage nine requests on a stopped engine whose queue holds four
    (shed-oldest), then serve: four batches' worth of traffic at two
    batch buckets.  Returns (outputs, stats)."""
    params = {k: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
              for k, v in _mlp().items()}
    eng = serving.ServingEngine(
        _net(pkg), params, {}, {"data": (FEATURE,)}, ctx=pkg.cpu(),
        policy=serving.BucketPolicy(4), max_queue=4,
        overload_policy="shed-oldest", batch_timeout_ms=1.0, start=False)
    try:
        eng.warmup()
        rng = np.random.default_rng(1)
        xs = rng.standard_normal((9, FEATURE)).astype(np.float32)
        futs = [eng.submit(x) for x in xs]
        eng.start()
        outs = []
        for f in futs:
            try:
                outs.append(np.asarray(f.result(timeout=60)))
            except jserving.ServerOverloadError:
                outs.append(None)
            except tserving.ServerOverloadError:
                outs.append(None)
        more = [eng.submit(x) for x in xs[:3]]
        outs += [np.asarray(f.result(timeout=60)) for f in more]
        return outs, eng.stats()
    finally:
        eng.close()


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def decoder():
    bench = _load("decode_bench", os.path.join(ROOT, "perf",
                                               "decode_bench.py"))
    with mx.base.NameManager():
        jsym, info, _d, _di, jp = bench.build_spec_models(
            vocab=32, d=16, max_len=MAX_LEN, layers=1, seed=0)
    return jsym, info, {k: v.asnumpy() for k, v in jp.items()}


def _decode(pkg, serving, decoder):
    jsym, info, params = decoder
    sym = jsym if pkg is mx else mt.sym.load_json(jsym.tojson())
    nd = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in params.items()}
    eng = serving.DecodeEngine(sym, nd, {}, info, num_slots=SLOTS,
                               max_len=MAX_LEN, ctx=pkg.cpu(),
                               default_deadline_ms=0, start=False)
    try:
        futs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(PROMPTS, NEW)]
        eng.start()
        res = [f.result(timeout=120) for f in futs]
        return [list(r.tokens) for r in res], eng.stats()
    finally:
        eng.close()


def _families(reg):
    return set(reg.collect())


def test_serving_engine_series_match(fresh):
    jreg, treg = fresh
    jouts, jstats = _serve(mx, jserving)
    touts, tstats = _serve(mt, tserving)
    assert [o is None for o in touts] == [o is None for o in jouts]
    assert tstats["shed"] == jstats["shed"] == 5
    jc, tc = _counts(jreg), _counts(treg)
    assert set(tc) == set(jc) - UNPORTED
    assert set(jc) & UNPORTED, "the reference registered none of UNPORTED"
    for name in tc:
        assert sorted(tc[name]) == sorted(jc[name]), name
    for name in COUNTED:
        if name in jc:
            assert tc[name] == jc[name], name
    req = tc["mxnet_serve_requests_total"][()]
    assert req == jstats["admitted"] + jstats["rejected"] == 12
    assert tc["mxnet_serve_batches_total"][()] == tstats["batches"]
    assert tc["mxnet_serve_request_latency_ms"][()] == \
        tstats["requests_served"]
    assert tt.lint_metric_names(registry=treg) == []


def test_decode_engine_series_match(fresh, decoder):
    jreg, treg = fresh
    jtoks, jstats = _decode(mx, jserving, decoder)
    ttoks, tstats = _decode(mt, tserving, decoder)
    assert [len(t) for t in ttoks] == [len(t) for t in jtoks] == NEW
    jc, tc = _counts(jreg), _counts(treg)
    assert set(tc) == set(jc) - UNPORTED
    for name in tc:
        assert sorted(tc[name]) == sorted(jc[name]), name
    for name in COUNTED:
        if name in jc:
            assert tc[name] == jc[name], name
    assert tc["mxnet_serve_decode_tokens_total"][()] == sum(NEW) == \
        tstats["decode"]["tokens_generated"]
    assert tc["mxnet_serve_decode_steps_total"][()] == \
        tstats["decode"]["steps"]
    eff = tstats["decode"]["efficiency"]["flops"]
    assert eff["total"] == eff["useful"] + eff["dead_slot"] > 0


def test_telemetry_off_moves_no_instrument_and_changes_no_bit(
        fresh, decoder):
    _jreg, treg = fresh
    on_outs, _ = _serve(mt, tserving)
    on_toks, _ = _decode(mt, tserving, decoder)
    tt.set_enabled(False)
    try:
        params = {k: mt.nd.array(v.astype(np.float32), ctx=mt.cpu())
                  for k, v in _mlp().items()}
        with tserving.ServingEngine(_net(mt), params, {},
                                    {"data": (FEATURE,)},
                                    ctx=mt.cpu()) as eng:
            eng.warmup()
            x = np.ones(FEATURE, np.float32)
            calls = treg.instrument_calls()
            eng.predict(x, timeout=60)
            assert treg.instrument_calls() == calls
        jsym, info, p = decoder
        with tserving.DecodeEngine(
                mt.sym.load_json(jsym.tojson()),
                {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in p.items()},
                {}, info, num_slots=SLOTS, max_len=MAX_LEN,
                ctx=mt.cpu()) as dec:
            dec.warmup()
            calls = treg.instrument_calls()
            dec.generate([1, 2], max_new_tokens=2, timeout=60)
            assert treg.instrument_calls() == calls
        off_outs, _ = _serve(mt, tserving)
        off_toks, _ = _decode(mt, tserving, decoder)
    finally:
        tt.set_enabled(None)
    for a, b in zip(on_outs, off_outs):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert on_toks == off_toks
