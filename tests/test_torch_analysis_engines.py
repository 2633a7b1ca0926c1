"""The gates the analysis drives in the port's engines, on the CPU:
``Predictor``'s verifier, ``ServingEngine``'s batch-axis preflight and
graph optimizer, and ``DecodeEngine``'s slot-axis preflight and
verdict-gated kernel selection.

Held: a malformed graph warns, and raises under
``MXNET_ANALYSIS_STRICT=1``; a graph that mixes rows along the batch
axis serves one request per batch, each answer bit for bit a batch-1
Predictor's; the optimizer on and off serve the same bits; a decode
step that mixes slots refuses to build under strict; and the gated
selection serves the tokens of ``greedy_decode`` over the unoptimized
step.
"""
import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu import analysis as ja
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as ta
from mxnet_tpu_torch.ops.registry import OpDef
from mxnet_tpu_torch.serving import (BucketPolicy, DecodeEngine,
                                     ServingEngine, StepProgram,
                                     greedy_decode)
from mxnet_tpu_torch.symbol.symbol import SymNode, Symbol, _topo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rogue_graph():
    """A graph whose op the registry does not know: it runs, but the
    verifier calls it an error (it cannot round-trip through JSON)."""
    rogue = OpDef("not_a_real_op", lambda attrs, x: x * 2.0)
    node = SymNode(rogue, "rogue0", {},
                   [(mt.sym.Variable("data")._outputs[0][0], 0)])
    return Symbol([(node, 0)])


def test_predictor_warns_on_a_malformed_graph():
    with pytest.warns(UserWarning, match="not in the registry"):
        pred = mt.Predictor(_rogue_graph(), {}, {}, {"data": (2, 3)},
                            ctx=mt.cpu())
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(pred.forward(data=x).get_output(0),
                                  x * 2.0)


def test_predictor_raises_under_strict(monkeypatch):
    monkeypatch.setenv("MXNET_ANALYSIS_STRICT", "1")
    with pytest.raises(ta.AnalysisError, match="verify"):
        mt.Predictor(_rogue_graph(), {}, {}, {"data": (2, 3)},
                     ctx=mt.cpu())


def test_predictor_analysis_off_is_silent(monkeypatch):
    monkeypatch.setenv("MXNET_ANALYSIS_ON", "0")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mt.Predictor(_rogue_graph(), {}, {}, {"data": (2, 3)},
                     ctx=mt.cpu())


def _batch_mixing(name="sm0"):
    return mt.sym.softmax(mt.sym.Variable("data"), axis=0, name=name)


def test_serving_engine_degrades_a_batch_mixing_graph():
    """softmax over axis 0 mixes requests: the engine warns, serves one
    request per batch, and every answer is a batch-1 Predictor's."""
    net = _batch_mixing()
    with pytest.warns(UserWarning, match="max_batch=1"):
        eng = ServingEngine(net, {}, {}, {"data": (5,)}, ctx=mt.cpu(),
                            policy=BucketPolicy(max_batch=4),
                            batch_timeout_ms=20.0, start=False)
    assert eng._verdicts == {"batch": "cross-position"}
    assert eng.stats()["max_batch"] == 1
    xs = np.random.default_rng(0).standard_normal((6, 5)).astype(
        np.float32)
    futs = [eng.submit(x) for x in xs]
    eng.start()
    got = [f.result(timeout=60) for f in futs]
    st = eng.stats()
    eng.close()
    assert st["batches"] == len(xs)
    pred = mt.Predictor(net, {}, {}, {"data": (1, 5)}, ctx=mt.cpu())
    for x, g in zip(xs, got):
        np.testing.assert_array_equal(
            g, pred.forward(data=x[None]).get_output(0)[0])


def test_serving_engine_strict_refuses_a_batch_mixing_graph(monkeypatch):
    monkeypatch.setenv("MXNET_ANALYSIS_STRICT", "1")
    with pytest.raises(ta.AnalysisError, match=r"\[padding\]"):
        ServingEngine(_batch_mixing(), {}, {}, {"data": (5,)},
                      ctx=mt.cpu(), policy=BucketPolicy(max_batch=4),
                      start=False)


def _redundant():
    """tests/test_optimize.py's acceptance graph, per example (4,)."""
    d = mt.sym.Variable("data")
    a2 = mt.sym.tanh(mt.sym.exp(d, name="a1"), name="a2")
    b2 = mt.sym.tanh(mt.sym.exp(d, name="b1"), name="b2")
    s = (a2 + b2) + mt.sym.zeros((4,))
    c = (mt.sym.ones((4,)) * 2.0) + mt.sym.ones((4,))
    return (s * 1.0) + c


def _serve_all(net, xs, monkeypatch, optimize, params=({}, {})):
    monkeypatch.setenv("MXNET_SERVE_OPTIMIZE", "1" if optimize else "0")
    eng = ServingEngine(net, params[0], params[1],
                        {"data": xs.shape[1:]}, ctx=mt.cpu(),
                        policy=BucketPolicy(max_batch=4),
                        batch_timeout_ms=20.0, start=False)
    futs = [eng.submit(x) for x in xs]
    eng.start()
    out = np.stack([f.result(timeout=60) for f in futs])
    st = eng.stats()
    eng.close()
    return eng, out, st


def test_serving_optimizer_on_against_off_bit_for_bit(monkeypatch):
    with mt.base.NameManager():
        net = _redundant()
    xs = np.random.default_rng(1).standard_normal((7, 4)).astype(
        np.float32)
    on, out_on, st_on = _serve_all(net, xs, monkeypatch, True)
    off, out_off, st_off = _serve_all(net, xs, monkeypatch, False)
    assert on.opt_plan.accepted and on.opt_plan.rewrites
    assert "verdict gate" in on.opt_plan.gate
    assert off.opt_plan is None and off.served_sym is net
    assert len(_topo(on.served_sym._outputs)) < len(_topo(net._outputs))
    assert st_on["optimizer"]["rewrites"] == len(on.opt_plan.rewrites)
    assert st_on["max_batch"] == st_off["max_batch"] == 4
    np.testing.assert_array_equal(out_on, out_off)


def test_serving_fused_resnet_stays_batched(monkeypatch):
    """A fused-unit ResNet (rows layout) is row-local along the batch
    axis in the port, so the engine keeps its bucket grid, and the
    optimizer on and off serve the same bits."""
    from mxnet_tpu_torch.models.resnet import _resnet
    sym = _resnet([2, 2], 2, [16, 32, 64], 10, (3, 32, 32), True,
                  layout="NHWC", unit_impl="fused")
    args, aux = mt.convert.random_params(sym, {"data": (1, 32, 32, 3)},
                                         seed=5)
    params = mt.convert.params_from_numpy(args, aux, device=mt.cpu())
    xs = np.random.default_rng(2).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    on, out_on, st_on = _serve_all(sym, xs, monkeypatch, True, params)
    _off, out_off, _st = _serve_all(sym, xs, monkeypatch, False, params)
    assert on._verdicts == {"batch": "row-local"}
    assert st_on["max_batch"] == 4 and not on.analysis_report.warnings
    assert on.opt_plan.accepted
    np.testing.assert_array_equal(out_on, out_off)


def _host_probe_graph():
    name = "_engine_host_probe"
    if name not in mt.ops.registry._REGISTRY:
        # declared, so the shapes pass can still run it on meta tensors
        mt.ops.registry.register(name, host_sync=True)(
            lambda attrs, x: x * 1.0)
    from mxnet_tpu_torch.symbol.symbol import _create
    return _create(name, [mt.sym.Variable("data")], {}, name="hostcall")


def test_serving_engine_keeps_hazard_fingerprints():
    """The retrace linter's host-sync finding lands in
    ``hazard_fingerprints`` under the key the JAX package computes for
    the same (node, op, message head).  The op has no padding rule, so
    the engine also stops coalescing."""
    with pytest.warns(UserWarning, match="max_batch=1"):
        eng = ServingEngine(_host_probe_graph(), {}, {}, {"data": (3,)},
                            ctx=mt.cpu(), policy=BucketPolicy(max_batch=2),
                            start=False)
    eng.close()
    want = ja.hazard_fingerprint("hostcall", "_engine_host_probe",
                                 "host sync: anything")
    assert list(eng.hazard_fingerprints) == [want]
    assert "host sync" in eng.hazard_fingerprints[want]


# ---------------------------------------------------------------------------
# DecodeEngine
# ---------------------------------------------------------------------------

def _slot_mixing_step(vocab=8, d=4):
    tok = mt.sym.Variable("token")
    s = mt.sym.Variable("s")
    emb = mt.sym.Embedding(tok, input_dim=vocab, output_dim=d, name="emb")
    s2 = mt.sym.broadcast_add(s + emb, mt.sym.sum(s, axis=0,
                                                  keepdims=True),
                              name="mix")
    logits = mt.sym.FullyConnected(s2, num_hidden=vocab, name="out_fc")
    rng = np.random.default_rng(0)
    params = {"emb_weight": rng.standard_normal((vocab, d)),
              "out_fc_weight": rng.standard_normal((vocab, d)),
              "out_fc_bias": np.zeros(vocab)}
    params = {k: mt.nd.array(v.astype(np.float32), ctx=mt.cpu())
              for k, v in params.items()}
    return mt.sym.Group([logits, s2]), params, [{"name": "s",
                                                 "shape": (d,)}]


def test_decode_engine_strict_refuses_a_slot_mixing_step(monkeypatch):
    step, params, info = _slot_mixing_step()
    monkeypatch.setenv("MXNET_ANALYSIS_STRICT", "1")
    with pytest.raises(ta.AnalysisError, match="SLOT axis"):
        DecodeEngine(step, params, {}, info, num_slots=4, max_len=8,
                     ctx=mt.cpu(), start=False)


def test_decode_engine_warns_on_a_slot_mixing_step():
    step, params, info = _slot_mixing_step()
    with pytest.warns(UserWarning, match="SLOT axis"):
        eng = DecodeEngine(step, params, {}, info, num_slots=4, max_len=8,
                           ctx=mt.cpu(), start=False)
    eng.close()
    assert eng.step_verdict == "cross-position"
    assert eng.stats()["decode"]["analysis"]["step_verdict"] == \
        "cross-position"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [0, 2])
def test_decode_engine_gated_selection_serves_greedy_tokens(k):
    """The decoder of the decode phase at a small size, k = 0 and a
    speculative k = 2: the step and draft are row-local, the selection
    is adopted through the verdict gate, and every stream is
    greedy_decode's over the UNOPTIMIZED step graph."""
    bench = _load("decode_bench", os.path.join(ROOT, "perf",
                                               "decode_bench.py"))
    with mj.base.NameManager():
        jt, t_info, jd, d_info, jp = bench.build_spec_models(
            vocab=32, d=16, max_len=32, layers=2, seed=0)
    t, d = mt.sym.load_json(jt.tojson()), mt.sym.load_json(jd.tojson())
    params = mt.convert.params_from_numpy(
        {n: np.array(v.asnumpy()) for n, v in jp.items()}, {},
        device=mt.cpu())[0]
    spec = {} if not k else dict(draft_sym=d, spec_k=k,
                                 draft_arg_params=params,
                                 draft_state_info=d_info)
    eng = DecodeEngine(t, params, {}, t_info, num_slots=4, max_len=32,
                       ctx=mt.cpu(), default_deadline_ms=0, **spec)
    st = eng.stats()["decode"]
    assert eng.step_verdict == "row-local"
    assert eng.draft_verdict == ("row-local" if k else None)
    assert eng.opt_plan.accepted and st["optimizer"]["selection"]
    assert "verdict gate" in st["optimizer"]["gate"]
    assert eng.opt_plan.verdicts_after == {"slot": "row-local"}
    ops = [n.op.name for n in _topo(eng.served_sym._outputs) if n.op]
    assert ops.count("_cache_write_row") == 2 * 2 and "one_hot" not in ops
    prompts = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [10, 11]]
    futs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    got = [list(f.result(timeout=120).tokens) for f in futs]
    eng.close()
    prog = StepProgram(t, params, {}, t_info, 4, ctx=mt.cpu())
    want = [list(greedy_decode(prog, p, 6)) for p in prompts]
    assert got == want
