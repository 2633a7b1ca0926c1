"""Gluon's fused RNN layers (``gluon.rnn.RNN``, ``LSTM``, ``GRU``) against
the JAX package's, on the CPU, and against the port's own cells.

Each layer is built in both packages with the same seeded weights and
run under ``autograd.record()`` on the same input and initial states:
outputs and final states within 1e-5 absolute, the input's and every
per-layer Parameter's gradient within 1e-4 relative L2 (the packed blob
is a Concat of the Parameters, so each gets its own slice back).  In the
port the layer equals a stack of its unfused cells (``_unfuse``) with
the same weights within 1e-5, and ``hybridize()`` leaves the layer (a
Block, as in the reference) giving the same bits.  The cells are in
test_torch_gluon_rnn_cells.py.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
T, N, C, H = 4, 3, 5, 6


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


LAYERS = {
    "lstm 2 layers TNC": (lambda g: g.rnn.LSTM(H, num_layers=2, input_size=C,
                                               prefix="lstm_"), "TNC"),
    "gru bidirectional NTC": (lambda g: g.rnn.GRU(
        H, layout="NTC", bidirectional=True, input_size=C, prefix="gru_"),
        "NTC"),
    "rnn tanh 2 layers": (lambda g: g.rnn.RNN(
        H, num_layers=2, activation="tanh", input_size=C, prefix="rnn_"),
        "TNC"),
}


def _values(layer, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(p.shape) * 0.3).astype(np.float32)
            for k, p in layer.collect_params().items()}


def run_layer(pkg, make, layout, values, x, states, cot, hybridize=False):
    """(outputs, states, input gradient, {param: gradient})."""
    layer = make(pkg.gluon)
    layer.initialize(ctx=pkg.cpu())
    for k, p in layer.collect_params().items():
        p.set_data(pkg.nd.array(values[k], ctx=pkg.cpu()))
    if hybridize:
        layer.hybridize()
    xs = pkg.nd.array(x, ctx=pkg.cpu())
    xs.attach_grad()
    st = [pkg.nd.array(s, ctx=pkg.cpu()) for s in states]
    with pkg.autograd.record():
        out, new = layer(xs, st)
        loss = (out * pkg.nd.array(cot, ctx=pkg.cpu())).sum()
    loss.backward()
    return (out.asnumpy(), [s.asnumpy() for s in new], xs.grad.asnumpy(),
            {k: p.grad().asnumpy()
             for k, p in layer.collect_params().items()})


def _case(name):
    make, layout = LAYERS[name]
    layer = make(mt.gluon)
    values = _values(layer, 0)
    rng = np.random.default_rng(1)
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    x = rng.standard_normal(shape).astype(np.float32)
    states = [rng.standard_normal(i["shape"]).astype(np.float32)
              for i in layer.state_info(N)]
    oshape = shape[:2] + (H * layer._dir,)
    cot = rng.standard_normal(oshape).astype(np.float32)
    return make, layout, values, x, states, cot


@pytest.mark.parametrize("name", list(LAYERS))
def test_rnn_layer_matches_jax(name):
    make, layout, values, x, states, cot = _case(name)
    got = run_layer(mt, make, layout, values, x, states, cot)
    want = run_layer(mx, make, layout, values, x, states, cot)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FWD_ATOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=FWD_ATOL)
    assert _rel(got[2], want[2]) < GRAD_RTOL
    assert sorted(got[3]) == sorted(want[3]) == sorted(values)
    for k in values:
        assert np.abs(got[3][k]).max() > 0, k
        assert _rel(got[3][k], want[3][k]) < GRAD_RTOL, k


@pytest.mark.parametrize("name", list(LAYERS))
def test_rnn_layer_equals_its_cells(name):
    """The layer against ``_unfuse()``'s cells with the same Parameters
    (1e-5), hybridized (a no-op on a Block) bit for bit, and without
    states it returns the output alone."""
    make, layout, values, x, states, cot = _case(name)
    eager = run_layer(mt, make, layout, values, x, states, cot)
    hyb = run_layer(mt, make, layout, values, x, states, cot,
                    hybridize=True)
    for a, b in zip(eager[:3], hyb[:3]):
        assert np.array_equal(a, b)
    layer = make(mt.gluon)
    layer.initialize(ctx=mt.cpu())
    for k, p in layer.collect_params().items():
        p.set_data(mt.nd.array(values[k], ctx=mt.cpu()))
    with mt.cpu():
        xs = mt.nd.array(x)
        cells = layer._unfuse()
        out, _ = cells.unroll(T, xs, [mt.nd.array(s) for s in
                                      _cell_states(layer, states)],
                              layout=layout, merge_outputs=True)
        np.testing.assert_allclose(out.asnumpy(), eager[0], rtol=0,
                                   atol=FWD_ATOL)
        assert layer(xs).shape == eager[0].shape


def _cell_states(layer, states):
    """The layer's (layers * directions, N, H) states as the unfused
    stack's per-cell list: each layer's cells in order, the LSTM's h and
    c per cell."""
    per = [[s[i] for s in states] for i in range(states[0].shape[0])]
    return [a for cell in per for a in cell]
