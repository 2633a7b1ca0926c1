"""Continuous-batching decode in the PyTorch port (``serving/decode.py``,
``serving/spec.py``, the ``select`` pass) against the JAX package, and the
engine's own contracts, on the CPU at a small size.

The graphs are the JAX package's: ``perf/decode_bench.build_spec_models``
(the attention decoder chip_smoke.py serves at full width) and
``tests/test_decode._attn_step``, serialized to JSON and loaded by the
port; the weights are the same numpy arrays.  JAX runs its scatter as the
Pallas kernel in interpret mode (``MXNET_CACHE_SCATTER_IMPL=interpret``).

Tolerances: the two packages round the attention step differently (sums
in another order, another exp), so logits and cache rows are held at
``TOL`` (2e-5 of the largest magnitude); token streams are compared
exactly only where the run's smallest top-1 logit margin is checked to be
far above that.  Within the port everything is exact: the engine against
``greedy_decode``, speculative against single-token, selection on
against off, and caches after a speculative step (``torch.equal``: a
blend would turn ``-0.0`` into ``+0.0``, the scatter keeps it).
"""
import importlib.util
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu.analysis import optimize_graph as j_optimize_graph
from mxnet_tpu.analysis import SELECT_OPT_PASSES as J_SELECT
from mxnet_tpu.serving.decode import StepProgram as JStepProgram
from mxnet_tpu.serving.spec import SpecConfig as JSpecConfig
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.analysis import optimize_graph, SELECT_OPT_PASSES
from mxnet_tpu_torch.serving import (DecodeEngine, StepProgram,
                                     greedy_decode)
from mxnet_tpu_torch.serving import spec as tspec
from mxnet_tpu_torch.symbol.symbol import _topo

from test_decode import _attn_step  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=32, d=16, max_len=32, layers=2, tail_scale=0.05)
SLOTS = 4
TOL = 2e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(params):
    return {k: np.array(v.asnumpy()) for k, v in params.items()}


@pytest.fixture(scope="module")
def models():
    """(JAX graphs and params, the port's loads of their JSON, numpy
    params), built once under fresh name counters."""
    bench = _load("decode_bench", os.path.join(ROOT, "perf",
                                               "decode_bench.py"))
    with mj.base.NameManager():
        jt, t_info, jd, d_info, jp = bench.build_spec_models(seed=0,
                                                             **SMALL)
        js, jsp, s_info = _attn_step(vocab=32, d=16, max_len=32)
    load = lambda s: mt.sym.load_json(s.tojson())  # noqa: E731
    return dict(jt=jt, jd=jd, js=js, t=load(jt), d=load(jd), s=load(js),
                t_info=t_info, d_info=d_info, s_info=s_info,
                params=_np(jp), s_params=_np(jsp))


def _nd(params):
    return mt.convert.params_from_numpy(params, {}, device=mt.cpu())[0]


def _ops(symbol):
    return [n.op.name for n in _topo(symbol._outputs) if n.op is not None]


def _shapes(info, extra=("token", "pos")):
    out = {n: (SLOTS,) for n in extra}
    out.update({s["name"]: (SLOTS,) + tuple(s["shape"]) for s in info})
    return out


def _gated(symbol, info):
    """The decode engine's selection: SELECT_OPT_PASSES through the
    verdict gate, slot axis padded, state pad-dirty."""
    shapes = _shapes(info)
    return optimize_graph(symbol, data_shapes=shapes,
                          pad_axes={"slot": {n: 0 for n in shapes}},
                          pad_dirty=tuple(s["name"] for s in info),
                          passes=SELECT_OPT_PASSES, device="cpu")


def _engine(m, k=0, draft=None, draft_params=None, **kw):
    p = _nd(m["params"])
    spec = {}
    if k:
        spec = dict(draft_sym=draft or m["d"], spec_k=k,
                    draft_arg_params=_nd(draft_params or m["params"]),
                    draft_state_info=m["d_info"])
    return DecodeEngine(m["t"], p, {}, m["t_info"], num_slots=SLOTS,
                        max_len=SMALL["max_len"], ctx=mt.cpu(),
                        default_deadline_ms=0, **spec, **kw)


# ---------------------------------------------------------------------------
# graphs: JSON and the select pass
# ---------------------------------------------------------------------------

def test_chip_smoke_builder_gives_build_spec_models_json(models):
    """chip_smoke.py's copy of the decoder builder (chip_smoke.py runs
    where JAX is not installed): the same JSON, state info and weights at
    the same parameters."""
    smoke = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    with mt.base.NameManager():
        t, t_info, d, d_info, params = smoke.build_spec_models(
            mt, seed=0, **SMALL)
    assert t.tojson() == models["jt"].tojson()
    assert d.tojson() == models["jd"].tojson()
    assert (t_info, d_info) == (models["t_info"], models["d_info"])
    assert sorted(params) == sorted(models["params"])
    for k, v in params.items():
        assert np.array_equal(v, models["params"][k]), k


@pytest.mark.parametrize("graph,info,writes", [
    ("s", "s_info", 2), ("t", "t_info", 2 * SMALL["layers"]),
    ("d", "d_info", 2)])
def test_select_pass_swaps_every_blend_write(models, graph, info, writes):
    plan = _gated(models[graph], models[info])
    assert plan.accepted, plan.reason
    ops = _ops(plan.symbol)
    assert ops.count("_cache_write_row") == writes
    assert "one_hot" not in ops
    assert [a.kind for a in plan.actions
            if a.pass_name == "select"] == ["select"] * writes
    assert plan.verdicts_after == {"slot": "row-local"}
    assert "_cache_write_row" not in _ops(models[graph])   # input untouched


@pytest.mark.parametrize("K", [3, 5])
def test_select_pass_swaps_the_commit_chains(models, K):
    specs = [(s["name"], (SLOTS,) + s["shape"], np.float32)
             for s in models["t_info"]]
    commit, shapes, cnames, rnames = tspec.build_commit_sym(specs, K)
    served, sel, plan = tspec.select_commit(commit, shapes, cnames, rnames,
                                            device="cpu")
    ops = _ops(served)
    assert plan.accepted and len(sel) == len(specs)
    assert ops.count("_cache_write_rows") == len(specs)
    assert "one_hot" not in ops and "_cache_write_row" not in ops


# ---------------------------------------------------------------------------
# StepProgram against the JAX package's
# ---------------------------------------------------------------------------

def _selected_both(m, name, info):
    shapes = _shapes(m[info])
    jplan = j_optimize_graph(m["j" + name], data_shapes=shapes,
                             pad_axes={"slot": {n: 0 for n in shapes}},
                             pad_dirty=tuple(s["name"] for s in m[info]),
                             passes=J_SELECT)
    assert jplan.accepted
    plan = _gated(m[name], m[info])
    assert plan.accepted
    return jplan.symbol, plan.symbol


def _feeds(m, info, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, SMALL["vocab"], SLOTS).astype(np.float32)
    pos = np.array([0, 5, 17, 31], np.float32)
    states = {s["name"]: (rng.standard_normal((SLOTS,) + s["shape"])
                          * 0.5).astype(np.float32) for s in m[info]}
    return tokens, pos, states


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale


def _margin(logits):
    top2 = np.sort(np.asarray(logits), axis=1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def test_step_matches_jax(models, monkeypatch):
    """Logits, sampled ids and every cache after one step of the selected
    2-block target, port against JAX, from the same states."""
    monkeypatch.setenv("MXNET_CACHE_SCATTER_IMPL", "interpret")
    m = models
    jsym, tsym = _selected_both(m, "t", "t_info")
    tokens, pos, states = _feeds(m, "t_info", 1)
    jp = {k: mj.nd.array(v) for k, v in m["params"].items()}
    jprog = JStepProgram(jsym, jp, {}, m["t_info"], SLOTS)
    jsampled, jstates = jprog.step(
        tokens, pos, np.ones(SLOTS, np.float32),
        {k: mj.nd.array(v)._data for k, v in states.items()})
    prog = StepProgram(tsym, _nd(m["params"]), {}, m["t_info"], SLOTS,
                       ctx=mt.cpu())
    tstates = {k: torch.from_numpy(v.copy()) for k, v in states.items()}
    sampled, new = prog.step(tokens, pos, np.ones(SLOTS, np.float32),
                             tstates)
    for k in states:
        assert new[k] is tstates[k]          # donated: written in place
        _close(new[k].numpy(), np.asarray(jstates[k]))
    # logits of the same step: the raw graph through both executors
    args = dict(m["params"], token=tokens, pos=pos, **states)
    jex = jsym.bind(mj.cpu(), {k: mj.nd.array(v) for k, v in args.items()})
    jlogits = jex.forward()[0].asnumpy()
    tex = tsym.bind(mt.cpu(), {k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in args.items()})
    logits = tex.forward()[0].asnumpy()
    _close(logits, jlogits)
    assert _margin(logits) > 1e3 * TOL
    assert np.array_equal(sampled, jsampled)
    assert np.array_equal(sampled, logits.argmax(1).astype(np.float32))


def test_step_spec_matches_jax(models, monkeypatch):
    """One speculative step (k = 2, the 1-block draft) from the same
    states: tokens and counts exactly (margin checked), caches at TOL."""
    monkeypatch.setenv("MXNET_CACHE_SCATTER_IMPL", "interpret")
    m = models
    jt, tt = _selected_both(m, "t", "t_info")
    jd, td = _selected_both(m, "d", "d_info")
    tokens, pos, states = _feeds(m, "t_info", 2)
    rng = np.random.default_rng(3)
    dstates = {"draft:" + s["name"]: (rng.standard_normal(
        (SLOTS,) + s["shape"]) * 0.5).astype(np.float32)
        for s in m["d_info"]}
    spec_m = np.array([1, 1, 0, 1], np.float32)
    ones = np.ones(SLOTS, np.float32)
    jp = {k: mj.nd.array(v) for k, v in m["params"].items()}
    jcfg = JSpecConfig(2, jd, draft_arg_params=jp,
                       draft_state_info=m["d_info"])
    jprog = JStepProgram(jt, jp, {}, m["t_info"], SLOTS, spec=jcfg)
    all_states = dict(states, **dstates)
    jtoks, jcounts, jnew = jprog.step_spec(
        tokens, pos, ones, spec_m,
        {k: mj.nd.array(v)._data for k, v in all_states.items()})
    p = _nd(m["params"])
    cfg = tspec.SpecConfig(2, td, draft_arg_params=p,
                           draft_state_info=m["d_info"])
    prog = StepProgram(tt, p, {}, m["t_info"], SLOTS, ctx=mt.cpu(),
                       spec=cfg)
    margins = []
    real_accept = tspec.greedy_accept

    def recording(xs, tlogits):
        margins.extend(_margin(t.numpy()) for t in tlogits)
        return real_accept(xs, tlogits)
    monkeypatch.setattr(tspec, "greedy_accept", recording)
    toks, counts, new = prog.step_spec(
        tokens, pos, ones, spec_m,
        {k: torch.from_numpy(v.copy()) for k, v in all_states.items()})
    assert min(margins) > 1e3 * TOL
    assert np.array_equal(toks, np.asarray(jtoks))
    assert np.array_equal(counts, np.asarray(jcounts))
    for k in all_states:
        _close(new[k].numpy(), np.asarray(jnew[k]))


def _logit_stream(m, prompt, n):
    """Greedy decode of one prompt through the port's raw step graph,
    tracking the smallest top-1 margin: (tokens, margin)."""
    ex = m["t"].simple_bind(mt.cpu(), token=(SLOTS,), pos=(SLOTS,),
                            **{s["name"]: (SLOTS,) + s["shape"]
                               for s in m["t_info"]})
    ex.copy_params_from(_nd(m["params"]))
    toks, margin, tok = [], np.inf, prompt[0]
    names = [s["name"] for s in m["t_info"]]
    for p in range(len(prompt) + n - 1):
        outs = ex.forward(token=np.full(SLOTS, tok, np.float32),
                          pos=np.full(SLOTS, p, np.float32))
        for name, o in zip(names, outs[1:]):
            ex.arg_dict[name]._data.copy_(o._data)
        logits = outs[0].asnumpy()
        if p + 1 < len(prompt):
            tok = prompt[p + 1]
            continue
        margin = min(margin, _margin(logits[:1]))
        tok = int(logits[0].argmax())
        toks.append(tok)
    return toks, margin


def test_token_streams_match_jax_where_margins_allow(models):
    """Whole greedy streams, port against the JAX package, for prompts
    whose every step's top-1 margin is far above the logits' tolerance."""
    from mxnet_tpu.serving.decode import greedy_decode as j_greedy_decode
    m = models
    jp = {k: mj.nd.array(v) for k, v in m["params"].items()}
    jprog = JStepProgram(m["jt"], jp, {}, m["t_info"], SLOTS)
    prog = StepProgram(m["t"], _nd(m["params"]), {}, m["t_info"], SLOTS,
                       ctx=mt.cpu())
    for prompt in ([1], [4, 9, 2]):
        toks, margin = _logit_stream(m, prompt, 12)
        assert margin > 1e3 * TOL, (prompt, margin)
        want = list(j_greedy_decode(jprog, prompt, 12))
        assert list(greedy_decode(prog, prompt, 12)) == toks == want


# ---------------------------------------------------------------------------
# the engine's contracts, within the port
# ---------------------------------------------------------------------------

PROMPTS = [[1], [2, 3], [5, 1, 4], [7], [9, 9], [3], [4, 5, 6, 7], [8],
           [11, 2], [6]]


def _want(m, prompts, n_of, eos_id=None):
    prog = StepProgram(m["t"], _nd(m["params"]), {}, m["t_info"], SLOTS,
                       ctx=mt.cpu())
    return [list(greedy_decode(prog, p, n_of(i), eos_id=eos_id,
                               max_len=SMALL["max_len"]))
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def reference(models):
    return _want(models, PROMPTS, lambda i: 5 + 2 * i)


def _serve(eng, prompts=PROMPTS, n_of=lambda i: 5 + 2 * i, **kw):
    futs = [eng.submit(p, max_new_tokens=n_of(i), **kw)
            for i, p in enumerate(prompts)]
    return [f.result(timeout=120) for f in futs]


def test_engine_matches_greedy_decode_under_churn(models, reference):
    """More requests than slots, mixed prompt and output lengths: every
    stream is greedy_decode's (slot 0 alone) bit for bit, each on_token
    stream is its exact prefix, and churn builds no program."""
    eng = _engine(models)
    assert eng.stats()["decode"]["optimizer"]["selection"]
    assert "verdict gate" in eng.stats()["decode"]["optimizer"]["gate"]
    assert eng.step_verdict == "row-local"
    built = eng.warmup()
    streams = {}
    lock = threading.Lock()

    def on_token(i):
        def cb(tok):
            with lock:
                streams.setdefault(i, []).append(tok)
        return cb
    futs = [eng.submit(p, max_new_tokens=5 + 2 * i, on_token=on_token(i))
            for i, p in enumerate(PROMPTS)]
    res = [f.result(timeout=120) for f in futs]
    st = eng.stats()["decode"]
    eng.close()
    assert [list(r.tokens) for r in res] == reference
    assert [streams[i] for i in range(len(PROMPTS))] == reference
    assert all(r.finish_reason == "length" for r in res)
    assert st["programs_built"] == built == 1
    assert st["joins"] == len(PROMPTS) and st["requests_served"] == 10
    assert st["tokens_generated"] == sum(len(r) for r in reference)


def test_selection_off_serves_the_same_tokens(models, reference,
                                              monkeypatch):
    monkeypatch.setenv("MXNET_OPT_SELECT_KERNELS", "0")
    eng = _engine(models)
    assert eng.selection is None
    assert "_cache_write_row" not in _ops(eng.served_sym)
    res = _serve(eng)
    eng.close()
    assert [list(r.tokens) for r in res] == reference


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_streams_equal_single_token(models, reference, k):
    eng = _engine(models, k=k)
    res = _serve(eng)
    st = eng.stats()["decode"]["spec"]
    eng.close()
    assert [list(r.tokens) for r in res] == reference
    assert st["enabled"] and st["k"] == k and st["drafted"] > 0
    assert len(st["commit_selection"]) == 2 * SMALL["layers"] + 2


def test_all_accepted_and_zero_accepted_edges(models, reference):
    """The target as its own draft accepts every proposal (k+1 tokens per
    step); a draft with unrelated weights accepts (almost) none.  Both
    give the single-token streams."""
    m = models
    rng = np.random.default_rng(99)
    other = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
             for k, v in m["params"].items()}
    for draft, dparams, info in ((m["t"], m["params"], m["t_info"]),
                                 (m["d"], other, m["d_info"])):
        eng = _engine(dict(m, d_info=info), k=2, draft=draft,
                      draft_params=dparams)
        res = _serve(eng, n_of=lambda i: 9)
        st = eng.stats()["decode"]["spec"]
        eng.close()
        want = _want(m, PROMPTS, lambda i: 9)
        assert [list(r.tokens) for r in res] == want
        if draft is m["t"]:
            assert st["accepted"] == st["drafted"] > 0
            assert st["accept_rate"] == 1.0
            # every spec step commits k+1, capped where max_new_tokens cut
            assert st["tokens_per_step"] > 2.5
        else:
            assert st["rejected"] > 0 and st["accept_rate"] < 0.5


def test_cache_after_speculative_step_keeps_unaccepted_rows(models):
    """After one speculative step every cache row other than the accepted
    ones is bit for bit what it was, the reset slot's rows are zeros, and
    the accepted rows are the chains' rows."""
    m = models
    p = _nd(m["params"])
    cfg = tspec.SpecConfig(2, _gated(m["d"], m["d_info"]).symbol,
        draft_arg_params=p, draft_state_info=m["d_info"])
    tsym = _gated(m["t"], m["t_info"]).symbol
    prog = StepProgram(tsym, p, {}, m["t_info"], SLOTS, ctx=mt.cpu(),
                       spec=cfg)
    tokens, pos, states = _feeds(m, "t_info", 4)
    pos = np.array([0, 5, 29, 30], np.float32)   # windows straddle T
    rng = np.random.default_rng(5)
    states.update({"draft:" + s["name"]: rng.standard_normal(
        (SLOTS,) + s["shape"]).astype(np.float32) for s in m["d_info"]})
    states = {k: torch.from_numpy(v) for k, v in states.items()}
    states["blk0_k"][1, 3, 0] = -0.0
    before = {k: v.clone() for k, v in states.items()}
    reset = np.array([0, 0, 1, 0], np.float32)
    spec_m = np.array([1, 1, 1, 0], np.float32)
    toks, counts, new = prog.step_spec(tokens, pos, np.ones(SLOTS,
                                                            np.float32),
                                       spec_m, states, reset=reset)
    assert counts[3] == 1 and counts.min() >= 1
    T = SMALL["max_len"]
    for k, v in new.items():
        assert v is states[k]                # committed in place
        want = before[k].clone()
        want[2] = 0.0                        # the joining slot
        for i in range(SLOTS):
            lo, hi = int(pos[i]), min(int(pos[i] + counts[i]), T)
            keep = torch.ones(T, dtype=torch.bool)
            keep[lo:hi] = False
            assert torch.equal(v[i][keep], want[i][keep]), (k, i)
            assert not torch.equal(v[i][lo:hi], want[i][lo:hi])


def test_eos_ends_a_request(models, reference):
    i = next(i for i, r in enumerate(reference) if len(set(r)) > 1)
    eos = reference[i][1]
    cut = reference[i][:reference[i].index(eos) + 1]
    eng = _engine(models, eos_id=eos)
    res = eng.submit(PROMPTS[i], max_new_tokens=5 + 2 * i).result(timeout=60)
    eng.close()
    assert list(res.tokens) == cut and res.finish_reason == "eos"


def test_deadline_mid_generation_returns_the_partial_prefix(models):
    want = _want(models, [[3]], lambda i: 25)[0]
    eng = _engine(models)
    eng.warmup()
    res = eng.submit([3], max_new_tokens=25, deadline_ms=150,
                     on_token=lambda t: time.sleep(0.02)).result(timeout=60)
    queued = eng.submit([3], max_new_tokens=5, deadline_ms=1e-3)
    late = queued.result(timeout=60)
    st = eng.stats()["decode"]
    eng.close()
    assert res.expired and res.finish_reason == "deadline"
    assert 0 < len(res) < 25 and list(res.tokens) == want[:len(res)]
    assert late.expired and len(late) == 0
    assert st["evictions"] >= 1


def test_closed_engine_and_bad_requests_raise(models):
    eng = _engine(models, start=False)
    with pytest.raises(mt.MXNetError, match="non-empty"):
        eng.submit([])
    with pytest.raises(mt.MXNetError, match="no room"):
        eng.submit(list(range(SMALL["max_len"])))
    fut = eng.submit([1], max_new_tokens=3)
    eng.close()                    # never started: drains on this thread
    assert len(fut.result(timeout=60)) == 3
    with pytest.raises(mt.serving.EngineClosedError):
        eng.submit([1])


@pytest.mark.parametrize("k", [0, 2])
def test_probe_step_agrees_between_programs(models, k):
    """Two programs built from the same graph give equal bits on the
    fixed all-zero probe, and probing touches no live state."""
    m = models
    p = _nd(m["params"])

    def program():
        spec = tspec.SpecConfig(k, m["d"], draft_arg_params=p,
                                draft_state_info=m["d_info"]) if k else None
        return StepProgram(m["t"], p, {}, m["t_info"], SLOTS, ctx=mt.cpu(),
                           spec=spec)
    a, b = program(), program()
    live = a.init_states()
    pa, pb = a.probe_step(), b.probe_step()
    assert len(pa) == len(pb) == (2 if k else 1) + len(live)
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    assert all(not v.any() for v in live.values())
