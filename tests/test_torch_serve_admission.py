"""Overload, the pad probe and the memory preflight of the PyTorch port's
ServingEngine, on the CPU, against the JAX package's engine.

Held bitwise against ``mxnet_tpu``: shed, reject and pressure outcomes
(which requests, and the counts), the pad probe's outcome, the memory
preflight's programs and bytes.  Served answers are held bitwise against
the port's Predictor.
"""
import re
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serving import (AdmissionController, BucketPolicy,
                                     QueueFullError, Request,
                                     ServerOverloadError, ServingEngine)

torch.set_num_threads(1)

ADMISSION_KEYS = ("queue_depth", "max_queue", "pressure", "overload_policy",
                  "admitted", "rejected", "shed", "pressure_shed", "expired")


def _mlp(S):
    h = S.Activation(S.FullyConnected(S.Variable("data"), num_hidden=16,
                                      name="fc1"), act_type="relu")
    return S.softmax(S.FullyConnected(h, num_hidden=4, name="fc2"), axis=-1)


def _mlp_params():
    rng = np.random.default_rng(7)
    return {"fc1_weight": rng.standard_normal((16, 6)).astype(np.float32),
            "fc1_bias": rng.standard_normal(16).astype(np.float32),
            "fc2_weight": rng.standard_normal((4, 16)).astype(np.float32),
            "fc2_bias": np.zeros(4, np.float32)}


def _engines(sym, jsym, params, **kw):
    targs = mt.convert.params_from_numpy(params, {}, device=mt.cpu())[0]
    jargs = {k: mj.nd.array(v) for k, v in params.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = ServingEngine(sym, targs, {}, {"data": (6,)}, ctx=mt.cpu(),
                            policy=BucketPolicy(4), start=False, **kw)
        jeng = mj.serving.ServingEngine(
            jsym, jargs, {}, {"data": (6,)},
            policy=mj.serving.BucketPolicy(4), start=False, **kw)
    return eng, jeng, targs


@pytest.mark.parametrize("policy", ["shed-oldest", "reject"])
def test_overload_policies_match_jax(policy):
    """32 requests staged on stopped engines with max_queue 4: under
    shed-oldest the first 28 fail with ServerOverloadError and the last 4
    are served (each bitwise a batch-1 Predictor's answer); under reject
    the last 28 submits raise QueueFullError.  The admission counters
    equal the JAX engine's."""
    xs = np.random.default_rng(8).standard_normal((32, 6)).astype(
        np.float32)
    eng, jeng, targs = _engines(_mlp(mt.sym), _mlp(mj.sym), _mlp_params(),
                                max_queue=4, overload_policy=policy,
                                batch_timeout_ms=20.0)
    outcomes = []
    for e, shed_exc, full_exc in ((eng, ServerOverloadError, QueueFullError),
                                  (jeng, mj.serving.ServerOverloadError,
                                   mj.serving.QueueFullError)):
        futs, refused = [], []
        for i, x in enumerate(xs):
            try:
                futs.append((i, e.submit(x)))
            except full_exc:
                refused.append(i)
        e.start()
        shed = [i for i, f in futs
                if isinstance(f.exception(timeout=60), shed_exc)]
        served = {i: f.result() for i, f in futs if i not in shed}
        st = e.stats()
        e.close()
        outcomes.append((shed, refused, served,
                         {k: st[k] for k in ADMISSION_KEYS}))
    (shed, refused, served, st), (jshed, jrefused, jserved, jst) = outcomes
    assert (shed, refused, st) == (jshed, jrefused, jst)
    assert sorted(served) == sorted(jserved) == list(range(4)) \
        if policy == "reject" else list(range(28, 32))
    if policy == "shed-oldest":
        assert shed == list(range(28)) and st["shed"] == 28
        assert st["rejected"] == 0
    else:
        assert refused == list(range(4, 32)) and st["rejected"] == 28
    pred = mt.Predictor(_mlp(mt.sym), targs, {}, {"data": (1, 6)},
                        ctx=mt.cpu())
    for i, out in served.items():
        np.testing.assert_array_equal(
            out, pred.forward(data=xs[i:i + 1]).get_output(0)[0])


def _staged(adm_cls, req_cls, costs):
    from concurrent.futures import Future
    adm = adm_cls(max_queue=8)
    reqs = [req_cls({}, ("g",), Future(), cost=c) for c in costs]
    return adm, reqs


def test_apply_pressure_and_expire_match_jax():
    """Cost-ranked shedding under pressure: ``apply_pressure`` sheds the
    highest-cost queued requests down to the limit at once, a later
    admit at the limit sheds the most expensive (itself, when it is),
    pressure sheds are counted apart from policy sheds, and
    ``expire_request`` counts an expiry after the pop; the same requests
    in the same order as the JAX package's controller."""
    costs = [5, 9, 1, 9, 3, 7]
    runs = []
    for adm_cls, req_cls, over in (
            (AdmissionController, Request, ServerOverloadError),
            (mj.serving.AdmissionController, mj.serving.Request,
             mj.serving.ServerOverloadError)):
        adm, reqs = _staged(adm_cls, req_cls, costs)
        for r in reqs:
            adm.admit(r)
        adm.apply_pressure(3)
        extra = req_cls({}, ("g",), reqs[0].future.__class__(), cost=8)
        try:
            adm.admit(extra)
            refused = False
        except over:
            refused = True
        cheap = req_cls({}, ("g",), reqs[0].future.__class__(), cost=2)
        adm.admit(cheap)
        popped = adm.poll(8)
        adm.expire_request(popped[0], detail="routed")
        adm.apply_pressure(None)
        shed = [i for i, r in enumerate(reqs) if r.future.done()
                and isinstance(r.future.exception(), over)]
        runs.append((shed, refused, [r.cost for r in popped],
                     isinstance(popped[0].future.exception(),
                                (mt.serving.DeadlineExceededError,
                                 mj.serving.DeadlineExceededError)),
                     {k: v for k, v in adm.stats().items()
                      if k in ADMISSION_KEYS}))
    assert runs[0] == runs[1]
    shed, refused, popped, expired, st = runs[0]
    assert shed == [0, 1, 3, 5] and refused and popped == [1, 3, 2]
    assert expired and st["pressure_shed"] == 5 and st["shed"] == 0
    assert st["expired"] == 1 and st["pressure"] is None


def test_unknown_overload_policy_raises():
    with pytest.raises(mt.base.MXNetError, match="overload policy"):
        AdmissionController(overload_policy="drop")


def test_pad_probe_catches_batch_softmax_and_is_silent_on_mlp(monkeypatch):
    """MXNET_SERVE_PAD_CHECK=1 with the analysis off: softmax over the
    batch axis changes live rows when pad slots are perturbed, and the
    batch fails with "contamination" in both packages; an MLP is served
    through the probe unchanged."""
    monkeypatch.setenv("MXNET_SERVE_PAD_CHECK", "1")
    monkeypatch.setenv("MXNET_ANALYSIS_ON", "0")
    xs = np.random.default_rng(9).standard_normal((3, 6)).astype(np.float32)

    def mix(S):
        return S.softmax(S.Variable("data"), axis=0, name="mix")
    for build, params, contaminated in ((mix, {}, True),
                                        (_mlp, _mlp_params(), False)):
        eng, jeng, targs = _engines(build(mt.sym), build(mj.sym), params,
                                    batch_timeout_ms=50.0)
        got, outs = [], None
        for e in (eng, jeng):
            futs = [e.submit(x) for x in xs]
            e.start()
            errs = [f.exception(timeout=60) for f in futs]
            got.append([str(x) if x is not None else None for x in errs])
            if e is eng and not contaminated:
                outs = [f.result() for f in futs]
            e.close()
        for errs in got:
            if contaminated:
                assert all("contamination" in m for m in errs), errs
            else:
                assert errs == [None] * 3
        if not contaminated:
            pred = mt.Predictor(build(mt.sym), targs, {}, {"data": (1, 6)},
                                ctx=mt.cpu())
            for x, o in zip(xs, outs):
                np.testing.assert_array_equal(
                    o, pred.forward(data=x[None]).get_output(0)[0])


_PRICE = re.compile(r"program '(\w+)' predicts peak ([\d.]+\w+) \(params "
                    r"([\d.]+\w+) \+ transient ([\d.]+\w+)\) but the device "
                    r"budget is ([\d.]+\w+)")


@pytest.mark.parametrize("seq", [False, True])
def test_memory_preflight_at_a_forced_budget_matches_jax(monkeypatch, seq):
    """MXNET_MEMORY_BUDGET_BYTES=1000: both engines price the same warm
    programs (one per seq bucket at the largest batch bucket) to the
    byte, warn naming the same program and bytes, and raise under
    MXNET_ANALYSIS_STRICT=1."""
    monkeypatch.setenv("MXNET_MEMORY_BUDGET_BYTES", "1000")
    kw = {}
    shape = (6,)
    if seq:
        shape = (8, 6)
        kw = dict(policy=BucketPolicy(4, seq_axis=0, seq_buckets=(4, 8)))
        jkw = dict(policy=mj.serving.BucketPolicy(4, seq_axis=0,
                                                   seq_buckets=(4, 8)))
    else:
        kw = dict(policy=BucketPolicy(4))
        jkw = dict(policy=mj.serving.BucketPolicy(4))

    def graph(S):
        if seq:     # row-local along seq: the seq buckets stay
            x = S.Variable("data")
            return S.relu(x) * 3.0 + S.sin(x)
        fc = S.FullyConnected(S.Variable("data"), num_hidden=16,
                              name="fc1")
        return S.relu(fc)
    params = {k: v for k, v in _mlp_params().items()
              if k.startswith("fc1") and not seq}
    targs = mt.convert.params_from_numpy(params, {}, device=mt.cpu())[0]
    jargs = {k: mj.nd.array(v) for k, v in params.items()}
    msgs = []
    for make in (lambda: ServingEngine(graph(mt.sym), targs, {},
                                       {"data": shape}, ctx=mt.cpu(),
                                       start=False, **kw),
                 lambda: mj.serving.ServingEngine(
                     graph(mj.sym), jargs, {}, {"data": shape},
                     start=False, **jkw)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = make()
        eng.close()
        found = [_PRICE.search(str(w.message)) for w in caught]
        found = [m.groups() for m in found if m]
        assert len(found) == 1, [str(w.message) for w in caught]
        msgs.append((found[0], eng.memory_plan["programs"],
                     eng.memory_plan["predicted_peak_bytes"],
                     eng.memory_plan["offender"]))
    assert msgs[0] == msgs[1]
    assert msgs[0][0][0] == ("b4s8" if seq else "b4")
    monkeypatch.setenv("MXNET_ANALYSIS_STRICT", "1")
    with pytest.raises(mt.analysis.AnalysisError, match=r"\[memory\]"):
        ServingEngine(graph(mt.sym), targs, {}, {"data": shape},
                      ctx=mt.cpu(), start=False, **kw)
    with pytest.raises(mj.analysis.AnalysisError, match=r"\[memory\]"):
        mj.serving.ServingEngine(graph(mj.sym), jargs, {}, {"data": shape},
                                 start=False, **jkw)
