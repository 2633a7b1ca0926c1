"""Sequence buckets in the PyTorch port's ServingEngine, on the CPU,
against the JAX package.

The seq grid (``BucketPolicy.seq_bucket`` / ``example_shape``,
``pad_valid_lengths``), the preflight's verdicts and repair plans and the
program grids are held bitwise against ``mxnet_tpu``'s; served outputs
are held bitwise against the port's Predictor ``reshape``d to each
request's exact length (the equality ``test_torch_serve.py`` holds batch
buckets to), except where the repaired graph sums a softmax over a
longer, masked axis: there 1e-6 relative (another summation length).
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serving import BucketPolicy, ServingEngine

torch.set_num_threads(1)

BUCKETS = (4, 8)
MAX_BATCH = 4


def _both_policies(max_batch=MAX_BATCH, buckets=BUCKETS):
    return (BucketPolicy(max_batch, seq_axis=0, seq_buckets=buckets),
            mj.serving.BucketPolicy(max_batch, seq_axis=0,
                                    seq_buckets=buckets))


def test_seq_grid_and_pad_valid_lengths_match_jax(monkeypatch):
    tp, jp = _both_policies(8, (10, 20, 30, 40))
    for n in range(1, 41):
        assert tp.seq_bucket(n) == jp.seq_bucket(n)
        assert tp.example_shape((n, 3)) == jp.example_shape((n, 3))
    assert tp.batch_buckets() == jp.batch_buckets() == [1, 2, 4, 8]
    with pytest.raises(mt.base.MXNetError, match="exceeds largest"):
        tp.seq_bucket(41)
    with pytest.raises(mt.base.MXNetError, match="without seq_axis"):
        BucketPolicy(4, seq_buckets=(4,))
    for lens, b in (([3, 7], 4), ([], 2), ([2049.0], 1)):
        got = mt.serving.pad_valid_lengths(lens, b)
        want = mj.serving.pad_valid_lengths(lens, b)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    monkeypatch.setenv("MXNET_SERVE_SEQ_BUCKETS", "16, 8,32")
    monkeypatch.setenv("MXNET_SERVE_MAX_BATCH", "6")
    t, j = BucketPolicy.from_config(), mj.serving.BucketPolicy.from_config()
    assert (t.max_batch, t.seq_axis, t.seq_buckets) \
        == (j.max_batch, j.seq_axis, j.seq_buckets) == (8, 0, (8, 16, 32))


def _lm(S, vocab=20, embed=8, hidden=8, layers=2):
    """The served LSTM language model's form at small widths: begin
    states made in the graph by ``_begin_state``, a time-major fused
    LSTM, ``FullyConnected(flatten=False)`` and a label-free softmax."""
    data = S.Variable("data")
    emb = S.Embedding(data, input_dim=vocab, output_dim=embed, name="embed")
    body = S.transpose(emb, axes=(1, 0, 2))
    states = [S.broadcast_axis(S.expand_dims(
        S._begin_state(data, num_hidden=hidden, name=n), axis=0),
        axis=0, size=layers) for n in ("h0", "c0")]
    out = S.RNN(body, S.Variable("lstm_parameters"), *states,
                state_size=hidden, num_layers=layers, mode="lstm",
                name="lstm")
    pred = S.FullyConnected(S.transpose(out, axes=(1, 0, 2)),
                            num_hidden=vocab, flatten=False, name="pred")
    return S.softmax(pred, axis=-1, name="prob")


def _serve(sym, args, xs, policy, data_shape, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = ServingEngine(sym, args, {}, {"data": data_shape},
                            ctx=mt.cpu(), policy=policy,
                            batch_timeout_ms=20.0, start=False, **kw)
    try:
        warm = eng.warmup()
        futs = [eng.submit(x) for x in xs]
        eng.start()
        outs = [f.result(timeout=60) for f in futs]
        st = eng.stats()
    finally:
        eng.close()
    return eng, outs, st, warm, [str(w.message) for w in caught]


def test_lstm_lm_verdicts_match_jax_and_exact_lengths_match_predictor():
    """The JAX package's padding pass has no rule for ``_begin_state`` (so
    both axes are conservatively cross-position) and reads
    ``FullyConnected(flatten=False)`` as contracting the padded seq axis:
    the port gives the same verdicts and the same rejected repair, so the
    engine drops the seq buckets and stops coalescing, and every request
    runs alone at its exact length — bitwise a Predictor reshaped to it."""
    sym = _lm(mt.sym)
    jsym = mj.sym.load_json(sym.tojson())
    tp, jp = _both_policies()
    verdicts, _ = mt.analysis.check_serving_graph(sym, {"data": (8,)}, tp)
    jverdicts, _ = mj.analysis.check_serving_graph(jsym, {"data": (8,)}, jp)
    assert verdicts == jverdicts == {"batch": "cross-position",
                                     "seq": "cross-position"}
    plan = mt.analysis.repair_serving_graph(sym, {"data": (8,)}, tp)
    jplan = mj.analysis.repair_serving_graph(jsym, {"data": (8,)}, jp)
    assert not plan.accepted and not jplan.accepted
    assert plan.reason == jplan.reason and "_begin_state" in plan.reason
    rng = np.random.default_rng(3)
    args = mt.convert.random_params(sym, {"data": (1, 8)}, seed=2)[0]
    args = mt.convert.params_from_numpy(args, {}, device=mt.cpu())[0]
    lengths = [2, 5, 8, 3, 5, 7]
    xs = [rng.integers(0, 20, n).astype(np.float32) for n in lengths]
    eng, outs, st, _warm, msgs = _serve(sym, args, xs, tp, (8,))
    assert eng._policy.seq_buckets == () and eng._policy.seq_axis == 0
    assert st["max_batch"] == 1 and st["batches"] == len(xs)
    assert any("disabling seq buckets" in m for m in msgs)
    assert any("max_batch=1" in m for m in msgs)
    pred = mt.Predictor(sym, args, {}, {"data": (1, 8)}, ctx=mt.cpu())
    for x, o in zip(xs, outs):
        want = pred.reshape({"data": (1, len(x))}).forward(
            data=x[None]).get_output(0)[0]
        assert o.shape == (len(x), 20)
        np.testing.assert_array_equal(o, want)


def _seq_softmax(S):
    return S.softmax(S.Variable("data"), axis=1, name="attn")


@pytest.mark.parametrize("repair", [True, False])
def test_seq_softmax_repair_on_and_off_matches_jax(monkeypatch, repair):
    """A softmax over the seq axis: cross-position along seq in both
    packages.  Repair on: the same accepted plan as the JAX package's
    (actions, valid-length input, length sources), served from the whole
    seq x batch grid with nothing built after warmup, each output within
    1e-6 (relative) of the exact softmax over the request's own length.
    Repair off: the seq buckets dropped, exact lengths, bitwise a
    reshaped Predictor."""
    monkeypatch.setenv("MXNET_SERVE_REPAIR", "1" if repair else "0")
    sym = _seq_softmax(mt.sym)
    jsym = _seq_softmax(mj.sym)
    tp, jp = _both_policies()
    shapes = {"data": (8, 3)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = mj.serving.ServingEngine(jsym, {}, {}, shapes, policy=jp,
                                        start=False)
    jst = jeng.stats()
    jeng.close()
    rng = np.random.default_rng(4)
    lengths = [3, 8, 1, 6, 5, 2, 7]
    xs = [rng.standard_normal((n, 3)).astype(np.float32) for n in lengths]
    eng, outs, st, warm, _msgs = _serve(sym, {}, xs, tp, shapes[
        "data"])
    assert eng._verdicts == jeng._verdicts == {"batch": "row-local",
                                               "seq": "cross-position"}
    assert st["repairs"] == jst["repairs"]
    assert eng._policy.seq_buckets == jeng._policy.seq_buckets
    pred = mt.Predictor(sym, {}, {}, {"data": (1, 8, 3)}, ctx=mt.cpu())
    if repair:
        assert eng.repair_plan.describe() == jeng.repair_plan.describe()
        assert eng._length_sources == jeng._length_sources == {"data": 0}
        grid = len(BUCKETS) * len(tp.batch_buckets())
        assert warm == st["compile_count"] == st["bucket_keys"] == grid
        assert st["retraces"] == 0
    else:
        assert eng.repair_plan is None and jeng.repair_plan is None
        assert eng._policy.seq_buckets == ()
    for x, o in zip(xs, outs):
        assert o.shape == x.shape
        want = pred.reshape({"data": (1,) + x.shape}).forward(
            data=x[None]).get_output(0)[0]
        if repair:
            np.testing.assert_allclose(o, want, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(o, want)


def test_predictor_outputs_shapes_and_reshape_match_jax():
    """``get_outputs``, ``output_shapes`` and ``reshape`` against
    ``mxnet_tpu.predict.Predictor`` (1e-6 relative: another summation
    order); the reshaped Predictor shares the bound parameters (the same
    NDArrays, no upload)."""
    def graph(S):
        x = S.Variable("data")
        fc = S.FullyConnected(x, num_hidden=5, flatten=False, name="fc")
        return S.Group([S.softmax(fc, axis=-1, name="p"),
                        S.sum(fc, axis=1, name="s")])
    sym, jsym = graph(mt.sym), graph(mj.sym)
    rng = np.random.default_rng(5)
    args = {"fc_weight": rng.standard_normal((5, 3)).astype(np.float32),
            "fc_bias": rng.standard_normal(5).astype(np.float32)}
    targs = mt.convert.params_from_numpy(args, {}, device=mt.cpu())[0]
    jargs = {k: mj.nd.array(v) for k, v in args.items()}
    pred = mt.Predictor(sym, targs, {}, {"data": (2, 4, 3)}, ctx=mt.cpu())
    jpred = mj.predict.Predictor(jsym, jargs, {}, {"data": (2, 4, 3)})
    assert pred.output_shapes == jpred.output_shapes == [(2, 4, 5), (2, 5)]
    with pytest.raises(mt.base.MXNetError, match="forward"):
        pred.get_outputs()
    for shape in ((2, 4, 3), (3, 7, 3)):
        p = pred.reshape({"data": shape})
        jp = jpred.reshape({"data": shape})
        assert p.output_shapes == jp.output_shapes
        for name in ("fc_weight", "fc_bias"):
            assert p._exec.arg_dict[name] is pred._exec.arg_dict[name]
        x = rng.standard_normal(shape).astype(np.float32)
        got = p.forward(data=x).get_outputs()
        want = jp.forward(data=x).get_outputs()
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        dev = p.get_outputs(as_numpy=False)
        assert isinstance(dev[0], mt.nd.NDArray)
        np.testing.assert_array_equal(dev[0].asnumpy(), got[0])
    with pytest.raises(mt.base.MXNetError, match="cover exactly"):
        pred.reshape({"other": (1, 2, 3)})
