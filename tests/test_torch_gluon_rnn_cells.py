"""Gluon's recurrent cells (``gluon.rnn.RNNCell`` ... ``BidirectionalCell``)
against the JAX package's, on the CPU.

Each cell is built in both packages (the JAX package's hybridized, as
its eager Gluon is slow) with the same seeded weights and unrolled over
the same input, with merged and unmerged outputs, under
``autograd.record()``: outputs and final states within 1e-5 absolute,
the input's and every Parameter's gradient within 1e-4 relative L2.  In
predict mode DropoutCell is the identity and ZoneoutCell its base cell in
both packages.  The GRU cell, ``valid_length`` and hybridization are in
test_torch_gluon_rnn_valid.py, which shares this file's comparison.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
T, N, C, H = 4, 3, 5, 5


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _make(g, kind):
    r = g.rnn
    if kind == "rnn_relu":
        return r.RNNCell(H, activation="relu", input_size=C, prefix="c_")
    if kind == "lstm":
        return r.LSTMCell(H, input_size=C, prefix="c_")
    if kind == "gru":
        return r.GRUCell(H, input_size=C, prefix="c_")
    if kind == "stack":
        s = r.SequentialRNNCell(prefix="c_")
        with s.name_scope():
            s.add(r.LSTMCell(H, input_size=C, prefix="l0_"))
            s.add(r.DropoutCell(0.5, prefix="d_"))
            s.add(r.ResidualCell(r.GRUCell(H, input_size=H, prefix="l1_")))
            s.add(r.ZoneoutCell(r.RNNCell(H, input_size=H, prefix="l2_"),
                                0.3, 0.2))
        return s
    if kind == "bidi":
        return r.BidirectionalCell(
            r.LSTMCell(H, input_size=C, prefix="c_l_"),
            r.GRUCell(H, input_size=C, prefix="c_r_"))
    raise ValueError(kind)


def _values(cell, seed=0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(p.shape) * 0.4).astype(np.float32)
            for k, p in sorted(cell.collect_params().items())}


def run_cell(pkg, kind, values, x, merge, hybridize, valid_length=None,
             training=True, layout="NTC"):
    cell = _make(pkg.gluon, kind)
    cell.initialize(ctx=pkg.cpu())
    for k, p in cell.collect_params().items():
        p.set_data(pkg.nd.array(values[k], ctx=pkg.cpu()))
    if hybridize:
        cell.hybridize()
    xs = pkg.nd.array(x, ctx=pkg.cpu())
    xs.attach_grad()
    vl = None if valid_length is None else pkg.nd.array(valid_length,
                                                        ctx=pkg.cpu())
    with pkg.autograd.record(train_mode=training):
        outs, states = cell.unroll(T, xs, layout=layout,
                                   merge_outputs=merge, valid_length=vl)
        merged = outs if merge else pkg.nd.stack(*outs, axis=1)
        loss = (merged * merged).sum() + sum((s * s).sum() for s in states)
    loss.backward()
    return (merged.asnumpy(), [s.asnumpy() for s in states],
            xs.grad.asnumpy(),
            {k: p.grad().asnumpy() for k, p in cell.collect_params().items()})


def _x(seed=1):
    return np.random.default_rng(seed).standard_normal((N, T, C)) \
        .astype(np.float32)


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FWD_ATOL)
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=FWD_ATOL)
    assert _rel(got[2], want[2]) < GRAD_RTOL
    assert sorted(got[3]) == sorted(want[3])
    for k in want[3]:
        assert _rel(got[3][k], want[3][k]) < GRAD_RTOL, k


@pytest.mark.parametrize("kind,merge", [
    ("rnn_relu", True), ("lstm", False), ("stack", True), ("bidi", False)])
def test_cell_unroll_matches_jax(kind, merge):
    check_cell(kind, merge)


def check_cell(kind, merge):
    """Predict-mode record (``train_mode=False``): DropoutCell and
    ZoneoutCell are deterministic in both packages."""
    values = _values(_make(mt.gluon, kind))
    x = _x()
    got = run_cell(mt, kind, values, x, merge, False, training=False)
    want = run_cell(mx, kind, values, x, merge, True, training=False)
    _check(got, want)
