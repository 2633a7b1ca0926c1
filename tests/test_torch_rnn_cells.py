"""The symbolic RNN cells (``mt.rnn``) against the JAX package's, on the
CPU.

Each cell is built in both packages, unrolled over the same (batch, T, C)
input with merged and with unmerged outputs, bound with the same seeded
weights and run forward in predict mode, where DropoutCell is the
identity and ZoneoutCell the fixed blend (1 - p) new + p old in both:
every output and final state within 1e-5 absolute.  The FusedRNNCell's
weights unpack to the JAX package's per-gate arrays bit for bit, pack
back to the blob, and its ``unfuse`` stack with the unpacked weights
gives the fused outputs within 1e-5 (as tests/test_rnn_weights.py holds
the JAX package).  The ``FusedRNN`` initializer puts ``forget_bias`` on
the LSTM's forget gates and 0 on every other bias, and the variables'
``__init__`` attributes are the JAX package's JSON.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

FWD_ATOL = 1e-5
N, T, C, H = 3, 3, 4, 5


def _cells(pkg, kind):
    r = pkg.rnn
    if kind == "rnn_tanh":
        return r.RNNCell(H, "tanh", prefix="rt_")
    if kind == "rnn_relu":
        return r.RNNCell(H, "relu", prefix="rr_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix="l_", forget_bias=2.0)
    if kind == "gru":
        return r.GRUCell(H, prefix="g_")
    if kind == "stack":
        s = r.SequentialRNNCell()
        s.add(r.LSTMCell(H, prefix="s0_"))
        s.add(r.DropoutCell(0.5, prefix="d_"))
        s.add(r.ResidualCell(r.GRUCell(H, prefix="s1_")))
        return s
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, prefix="z_"), 0.3, 0.2)
    if kind == "bidi":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="bl_"),
                                   r.GRUCell(H, prefix="br_"))
    if kind == "fused_lstm":
        return r.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="f_")
    if kind == "fused_gru_bidi":
        return r.FusedRNNCell(H, mode="gru", bidirectional=True,
                              prefix="fb_")
    raise ValueError(kind)


def _unrolled(pkg, kind, merge):
    cell = _cells(pkg, kind)
    outs, states = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                               merge_outputs=merge)
    outs = [outs] if merge else list(outs)
    return pkg.sym.Group(outs + list(states))


def _forward(pkg, sym, feeds):
    args = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in feeds.items()}
    exe = sym.bind(pkg.cpu(), args,
                   grad_req={n: "null" for n in sym.list_arguments()})
    return [o.asnumpy() for o in exe.forward(is_train=False)]


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru",
                                  "stack", "zoneout", "bidi", "fused_lstm",
                                  "fused_gru_bidi"])
def test_unroll_matches_jax(kind, merge):
    tsym = _unrolled(mt, kind, merge)
    jsym = _unrolled(mx, kind, merge)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert len(tsym.list_outputs()) == len(jsym.list_outputs())
    args, _ = mt.convert.random_params(tsym, {"data": (N, T, C)}, seed=1)
    args["data"] = np.random.default_rng(2).standard_normal(
        (N, T, C)).astype(np.float32)
    got = _forward(mt, tsym, args)
    # eager: the unrolled graphs would each compile for seconds
    with jax.disable_jit():
        want = _forward(mx, jsym, args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("mode,layers,bidi", [("lstm", 2, False),
                                              ("gru", 1, True),
                                              ("rnn_tanh", 2, False)])
def test_fused_cell_unpack_pack_unfuse(mode, layers, bidi):
    """unpack_weights gives the JAX package's per-gate arrays bit for bit
    (``convert.rnn_params_to_numpy``); pack_weights gives the blob back
    from them (``convert.rnn_params_from_numpy``); the unfused stack with
    those weights gives the fused outputs."""
    size = mt.ops.rnn.rnn_param_size(mode, C, H, layers, bidi)
    blob = (np.random.default_rng(3).standard_normal(size) * 0.3) \
        .astype(np.float32)
    cell = mt.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                               bidirectional=bidi, prefix="f_")
    got = mt.convert.rnn_params_to_numpy(
        cell, {"f_parameters": mt.nd.array(blob, ctx=mt.cpu())})
    jcell = mx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                bidirectional=bidi, prefix="f_")
    want = {k: v.asnumpy() for k, v in jcell.unpack_weights(
        {"f_parameters": mx.nd.array(blob)}).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    repacked = mt.convert.rnn_params_from_numpy(cell, want, device=mt.cpu())
    np.testing.assert_array_equal(repacked["f_parameters"].asnumpy(), blob)
    if bidi:
        return          # unfuse stacks unidirectional cells
    cell = mt.rnn.FusedRNNCell(H, num_layers=layers, mode=mode, prefix="f_")
    data = mt.sym.Variable("data")
    fused, _ = cell.unroll(T, inputs=data, merge_outputs=True)
    stack = cell.unfuse()
    unfused, _ = stack.unroll(T, inputs=data, merge_outputs=True)
    x = np.random.default_rng(4).standard_normal((N, T, C)) \
        .astype(np.float32)
    zeros = np.zeros((layers, N, H), np.float32)
    feeds = {"data": x, "f_parameters": blob, "f_state": zeros}
    if mode == "lstm":
        feeds["f_state_cell"] = zeros
    packed = mt.convert.rnn_params_from_numpy(stack._cells, got,
                                              device=mt.cpu())
    ufeeds = {"data": x, **{k: v.asnumpy() for k, v in packed.items()}}
    np.testing.assert_allclose(_forward(mt, unfused, ufeeds)[0],
                               _forward(mt, fused, feeds)[0], rtol=0,
                               atol=FWD_ATOL)


def test_fused_rnn_initializer_forget_bias():
    """Through the blob variable's ``__init__`` attribute (the JAX
    package's JSON): the LSTM forget gates' biases are forget_bias, the
    other biases 0, the weights drawn."""
    cells = {pkg: pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                       prefix="f_", forget_bias=1.5)
             for pkg in (mt, mx)}
    attrs = {pkg: c.unroll(T, inputs=pkg.sym.Variable("data"),
                           merge_outputs=True)[0].attr_dict()["f_parameters"]
             for pkg, c in cells.items()}
    assert attrs[mt]["__init__"] == attrs[mx]["__init__"]
    size = mt.ops.rnn.rnn_param_size("lstm", C, H, 2, False)
    with mt.cpu():
        arr = mt.nd.zeros((size,))
    mt.init.Xavier()(mt.init.InitDesc("f_parameters", attrs[mt]), arr)
    parts = cells[mt].unpack_weights({"f_parameters": arr})
    for name, v in parts.items():
        v = v.asnumpy()
        if name.endswith("_f_bias"):            # i2h's and h2h's
            np.testing.assert_array_equal(v, 1.5)
        elif name.endswith("_bias"):
            np.testing.assert_array_equal(v, 0.0)
        else:
            assert np.abs(v).max() > 0, name


def test_lstm_cell_bias_init_matches_jax():
    """LSTMCell's i2h bias carries ``init=LSTMBias(forget_bias)`` as the
    same JSON in both packages; initialized, only its forget block is
    forget_bias."""
    outs = {pkg: pkg.rnn.LSTMCell(4, prefix="l_", forget_bias=5.0).unroll(
        1, inputs=pkg.sym.Variable("data"), merge_outputs=True)[0]
        for pkg in (mt, mx)}
    battr = {pkg: o.attr_dict()["l_i2h_bias"] for pkg, o in outs.items()}
    assert battr[mt]["__init__"] == battr[mx]["__init__"]
    with mt.cpu():
        arr = mt.nd.zeros((16,))
    mt.init.Uniform(0.1)(mt.init.InitDesc("l_i2h_bias", battr[mt]), arr)
    b = arr.asnumpy()
    np.testing.assert_array_equal(b[4:8], 5.0)
    np.testing.assert_array_equal(np.r_[b[:4], b[8:]], 0.0)


def test_cell_unpack_pack_and_begin_state_arrays():
    """A gated cell's unpack/pack is the JAX package's; begin_state_arrays
    fills the batch."""
    w = np.random.default_rng(5).standard_normal((3 * H, C)) \
        .astype(np.float32)
    got = mt.rnn.GRUCell(H, prefix="g_").unpack_weights(
        {"g_i2h_weight": mt.nd.array(w, ctx=mt.cpu())})
    want = mx.rnn.GRUCell(H, prefix="g_").unpack_weights(
        {"g_i2h_weight": mx.nd.array(w)})
    assert sorted(got) == sorted(want) == ["g_i2h_o_weight",
                                           "g_i2h_r_weight",
                                           "g_i2h_z_weight"]
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    packed = mt.rnn.GRUCell(H, prefix="g_").pack_weights(got)
    np.testing.assert_array_equal(packed["g_i2h_weight"].asnumpy(), w)
    stack = mt.rnn.SequentialRNNCell()
    stack.add(mt.rnn.LSTMCell(H, prefix="a_")).add(
        mt.rnn.RNNCell(2, prefix="b_"))
    shapes = [a.shape for a in stack.begin_state_arrays(7)]
    assert shapes == [(7, H), (7, H), (7, 2)]
