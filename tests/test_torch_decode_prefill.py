"""Bucketed prefill in the PyTorch port's decode engine, on the CPU.

The model is the JAX package's ``perf/decode_bench.build_prefill_model``
(an additive state ``s' = s + emb(token)``; its prefill graph masks the
padded prompt with the live length and sums), serialized to JSON and
loaded by the port, with the same numpy weights.  Within the port the
coalesced, serial and teacher-forced engines must give the same tokens,
and prefill under spec k = 2 the ``greedy_decode`` tokens; against the
JAX package's DecodeEngine with ``prefill_sym``, the same tokens (the
smallest top-1 logit margin of the run is checked to be far above the
two packages' rounding, as ``test_torch_decode.py`` does), and the same
decode memory plan to the byte.
"""
import importlib.util
import os
import re
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serving import DecodeEngine, StepProgram, greedy_decode

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D = 24, 16
SLOTS, MAX_LEN = 4, 16
JOBS = [([3, 7, 1], 5), ([5, 2, 9, 9], 4), ([9, 2, 8], 6), ([1, 1, 0, 4], 3),
        ([4, 12, 0, 3, 3], 5), ([2, 2, 2, 2, 2, 2, 2, 2, 2], 4),
        ([11], 6), ([6, 5, 4, 1, 1, 7], 5)]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model():
    bench = _load("decode_bench", os.path.join(ROOT, "perf",
                                               "decode_bench.py"))
    with mj.base.NameManager():
        step, prefill, params, info = bench.build_prefill_model(
            vocab=VOCAB, d=D, seed=0)
    load = lambda s: mt.sym.load_json(s.tojson())  # noqa: E731
    np_params = {k: np.array(v.asnumpy()) for k, v in params.items()}
    return dict(jstep=step, jprefill=prefill, jparams=params, info=info,
                step=load(step), prefill=load(prefill), params=np_params)


def _nd(params):
    return mt.convert.params_from_numpy(params, {}, device=mt.cpu())[0]


def _engine(m, prefill=True, **kw):
    kw.setdefault("start", False)
    return DecodeEngine(m["step"], _nd(m["params"]), {}, m["info"],
                        num_slots=SLOTS, max_len=MAX_LEN, ctx=mt.cpu(),
                        default_deadline_ms=0,
                        prefill_sym=m["prefill"] if prefill else None, **kw)


def _run(eng, jobs=JOBS):
    """Warm, stage every job on the stopped engine, then start it: the
    first iteration seats a full pool of joiners at once."""
    try:
        built = eng.warmup()
        futs = [eng.submit(p, max_new_tokens=n) for p, n in jobs]
        eng.start()
        toks = [list(f.result(timeout=60).tokens) for f in futs]
        st = eng.stats()["decode"]
    finally:
        eng.close()
    return toks, st, built


def test_coalesced_serial_and_teacher_forced_give_the_same_tokens(
        model, monkeypatch):
    """One dispatch per prompt bucket (coalesced), one per joiner
    (serial) and no prefill at all give the same tokens; the prefill
    engines need fewer step dispatches, warm the whole (prompt bucket x
    batch bucket) grid and build nothing after warmup."""
    co, st_co, built_co = _run(_engine(model))
    monkeypatch.setenv("MXNET_DECODE_COALESCE_PREFILL", "0")
    se, st_se, built_se = _run(_engine(model))
    monkeypatch.delenv("MXNET_DECODE_COALESCE_PREFILL")
    tf, st_tf, _ = _run(_engine(model, prefill=False))
    assert co == se == tf
    assert [len(t) for t in co] == [n for _p, n in JOBS]
    assert st_co["prefill"] == st_se["prefill"] == "bucket"
    assert st_tf["prefill"] == "step"
    assert st_co["prefill_buckets"] == [1, 2, 4, 8, 16]
    assert st_co["prefill_batch_buckets"] == [1, 2, 4]
    assert st_se["prefill_batch_buckets"] == [1]
    assert st_se["prefill_dispatches"] == len(JOBS)
    assert st_co["prefill_dispatches"] < len(JOBS)
    assert st_co["steps"] < st_tf["steps"] and st_se["steps"] < st_tf["steps"]
    # the step program + one program per (prompt, batch) bucket
    assert built_co == st_co["programs_built"] == 1 + 5 * 3
    assert built_se == st_se["programs_built"] == 1 + 5


def test_prefill_with_spec_k2_equals_greedy_decode(model):
    """Prefill in front of speculative decode (a draft with perturbed
    weights, so that some proposals fail): the draft's rows start cold and
    the streams are ``greedy_decode``'s."""
    p = model["params"]
    rng = np.random.default_rng(1)
    dparams = {k: (v + rng.standard_normal(v.shape).astype(np.float32)
                   * 0.3) for k, v in p.items()}
    eng = _engine(model, spec_k=2, draft_sym=model["step"],
                  draft_arg_params=_nd(dparams),
                  draft_state_info=model["info"])
    got, st, _ = _run(eng)
    prog = StepProgram(model["step"], _nd(p), {}, model["info"], SLOTS,
                       ctx=mt.cpu())
    want = [list(greedy_decode(prog, pr, n)) for pr, n in JOBS]
    assert got == want
    spec = st["spec"]
    assert 0.0 < spec["accept_rate"] < 1.0


def test_failed_prefill_dispatch_fails_only_its_group(model):
    """A prefill dispatch that raises fails the requests of its group (its
    prompt bucket) and nothing else: a request generating in another slot
    and the joiners of other buckets keep their tokens."""
    ref, _st, _b = _run(_engine(model))
    eng = _engine(model)
    rep = eng._rep
    real = rep.prefill_caches[4]

    class Broken(object):
        def run(self, feeds, host=True):
            raise RuntimeError("planted prefill failure")
    try:
        eng.warmup()
        rep.prefill_caches[4] = Broken()
        futs = [eng.submit(pr, max_new_tokens=n) for pr, n in JOBS]
        eng.start()
        outs = [f.exception(timeout=60) or f.result() for f in futs]
    finally:
        eng.close()
        rep.prefill_caches[4] = real
    for (prompt, _n), out, want in zip(JOBS, outs, ref):
        if 2 < len(prompt) <= 4:
            assert isinstance(out, RuntimeError) and "planted" in str(out)
        else:
            assert list(out.tokens) == want


def test_prefill_tokens_and_memory_plan_match_jax(model, monkeypatch):
    """The JAX package's DecodeEngine with the same prefill graph gives
    the same tokens (the run's smallest top-1 margin is far above the
    packages' rounding), and its memory preflight the same programs and
    bytes; at a forced budget both warn naming the same program."""
    jeng = mj.serving.DecodeEngine(
        model["jstep"], model["jparams"], {}, model["info"],
        num_slots=SLOTS, max_len=MAX_LEN, prefill_sym=model["jprefill"],
        default_deadline_ms=0)
    try:
        jeng.warmup()
        jfuts = [jeng.submit(p, max_new_tokens=n) for p, n in JOBS]
        want = [list(f.result(timeout=120).tokens) for f in jfuts]
        jplan = jeng.memory_plan
    finally:
        jeng.close()
    eng = _engine(model)
    plan = eng.memory_plan
    got, _st, _b = _run(eng)
    assert got == want
    # margins: every emitted token's logits, in numpy float64
    W = model["params"]["out_fc_weight"].astype(np.float64)
    E = model["params"]["emb_weight"].astype(np.float64)
    margin = np.inf
    for (prompt, _n), toks in zip(JOBS, got):
        s = E[prompt].sum(0)
        for t in toks:
            top2 = np.sort(W @ s)[-2:]
            margin = min(margin, top2[1] - top2[0])
            s = s + E[t]
    assert margin > 1e-3
    for key in ("programs", "predicted_peak_bytes", "pool_bytes",
                "per_slot_bytes", "offender", "param_bytes"):
        assert plan[key] == jplan[key], key
    assert plan["donation"]["step"]["accepted"] \
        == jplan["donation"]["step"]["accepted"] is True
    monkeypatch.setenv("MXNET_MEMORY_BUDGET_BYTES", "4096")
    price = re.compile(r"program '([^']+)' predicts peak (\S+) \(slot pool "
                       r"(\S+) for (\d+) slots \+ params (\S+)\) but the "
                       r"device budget is (\S+) — the warm set cannot "
                       r"fit \(at most (\d+) slots fit\)")
    found = []
    for make in (lambda: _engine(model),
                 lambda: mj.serving.DecodeEngine(
                     model["jstep"], model["jparams"], {}, model["info"],
                     num_slots=SLOTS, max_len=MAX_LEN,
                     prefill_sym=model["jprefill"], start=False)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            make().close()
        found.append([price.search(str(w.message)).groups()
                      for w in caught if price.search(str(w.message))])
    assert len(found[0]) == 1 and found[0] == found[1]
    monkeypatch.setenv("MXNET_ANALYSIS_STRICT", "1")
    with pytest.raises(mt.analysis.AnalysisError, match=r"\[memory\]"):
        _engine(model)


def test_decode_request_cost_and_shed_oldest_match_jax(model):
    """A decode request's shed price (its pow2 prompt bucket plus its
    generation budget) and shed-oldest admission, against the JAX
    package's DecodeEngine: with ``max_queue`` 2, staging four requests
    sheds the first two in both."""
    jeng = mj.serving.DecodeEngine(
        model["jstep"], model["jparams"], {}, model["info"],
        num_slots=SLOTS, max_len=MAX_LEN, prefill_sym=model["jprefill"],
        max_queue=2, overload_policy="shed-oldest", start=False)
    eng = _engine(model, max_queue=2, overload_policy="shed-oldest")
    got = []
    for e, over in ((eng, mt.serving.ServerOverloadError),
                    (jeng, mj.serving.ServerOverloadError)):
        futs = [e.submit(p, max_new_tokens=n) for p, n in JOBS[:4]]
        shed = [isinstance(f.exception(timeout=0) if f.done() else None,
                           over) for f in futs]
        got.append((shed, [r.cost for r in e._adm._queue],
                    e.stats()["shed"]))
        e.close(drain=False)
    assert got[0] == got[1]
    assert got[0][0] == [True, True, False, False] and got[0][2] == 2
