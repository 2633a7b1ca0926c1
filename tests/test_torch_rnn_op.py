"""The fused ``RNN`` op, ``_begin_state`` and the Sequence ops against the
JAX package's, on the CPU.

Same numpy inputs through ``mxnet_tpu.ops.registry.invoke_jax`` and the
port's ``invoke``.  Tolerances: 1e-5 absolute on forward values; 1e-4
relative L2 on the gradients of the data, the packed parameters and the
initial states (both packages take them by autograd of float32 sums in
another order).  ``rnn_relu``'s gradient at an exact 0 differs
(``jnp.maximum``'s is 0.5, ``torch.relu``'s 0): the inputs are random
normals, so no pre-activation is exactly 0, and the relative L2 holds
the rest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu.ops.registry import invoke_jax
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.ops.registry import invoke

torch.set_num_threads(1)

FWD_ATOL = 1e-5
GRAD_RTOL = 1e-4
T, N, I, H = 5, 3, 4, 6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _inputs(mode, bidi, layers, seed=0):
    rng = np.random.default_rng(seed)
    d = 2 if bidi else 1
    size = trnn.rnn_param_size(mode, I, H, layers, bidi)
    x = rng.standard_normal((T, N, I)).astype(np.float32)
    p = (rng.standard_normal(size) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((layers * d, N, H)).astype(np.float32)
    c0 = rng.standard_normal((layers * d, N, H)).astype(np.float32)
    return [x, p, h0] + ([c0] if mode == "lstm" else [])


def check_rnn_against_jax(mode, bidi, state_outputs, layers):
    """Every output, and the gradients of every input under one random
    cotangent per output."""
    attrs = dict(state_size=H, num_layers=layers, mode=mode,
                 bidirectional=bidi, state_outputs=state_outputs)
    ins = _inputs(mode, bidi, layers)
    key = jax.random.PRNGKey(0)

    def jfn(*a):
        return invoke_jax("RNN", attrs, key, *a, training=True)
    # eager: compiling the scans would take most of the file's time
    with jax.disable_jit():
        ref, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in ins])
        rng = np.random.default_rng(1)
        cots = [rng.standard_normal(np.shape(r)).astype(np.float32)
                for r in ref]
        jgrads = vjp(tuple(jnp.asarray(c) for c in cots))

    ts = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = invoke("RNN", attrs, *ts, training=True)
    assert len(got) == len(ref) == (1 if not state_outputs
                                    else 3 if mode == "lstm" else 2)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=0, atol=FWD_ATOL)
    torch.autograd.backward(list(got), [torch.from_numpy(c) for c in cots])
    for name, t, jg in zip(["data", "parameters", "state", "state_cell"],
                           ts, jgrads):
        assert _rel(t.grad.numpy(), jg) < GRAD_RTOL, name


# the LSTM language model's case here; the others in
# test_torch_rnn_op_{bidi,modes,gru}.py: each JAX case costs seconds on
# the CPU, and each file stays short alone
@pytest.mark.parametrize("mode,state_outputs,layers", [("lstm", True, 2)])
def test_rnn_matches_jax(mode, state_outputs, layers):
    check_rnn_against_jax(mode, False, state_outputs, layers)


@pytest.mark.parametrize("mode", ["lstm"])
def test_rnn_dropout_between_layers_only(mode):
    """``p`` acts in training between layers: eval output equals p = 0's
    (and the JAX package's), one layer is untouched in training, two are
    not, and a seeded run repeats."""
    ins = _inputs(mode, False, 2)
    base = dict(state_size=H, num_layers=2, mode=mode)
    ts = [torch.from_numpy(a) for a in ins]
    plain = invoke("RNN", base, *ts)[0]
    ref = invoke_jax("RNN", base, jax.random.PRNGKey(0),
                     *[jnp.asarray(a) for a in ins])[0]
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=FWD_ATOL)
    drop = dict(base, p=0.5)
    assert torch.equal(invoke("RNN", drop, *ts)[0], plain)
    one = _inputs(mode, False, 1)
    t1 = [torch.from_numpy(a) for a in one]
    assert torch.equal(invoke("RNN", dict(drop, num_layers=1), *t1,
                              training=True)[0],
                       invoke("RNN", dict(base, num_layers=1), *t1)[0])
    mt.random.seed(3)
    a = invoke("RNN", drop, *ts, training=True)[0]
    mt.random.seed(3)
    b = invoke("RNN", drop, *ts, training=True)[0]
    assert torch.equal(a, b) and not torch.allclose(a, plain)


@pytest.mark.parametrize("mode,isz,h,layers,bidi", [
    ("lstm", 4, 6, 2, False), ("gru", 5, 3, 3, True),
    ("rnn_tanh", 7, 2, 1, True), ("rnn_relu", 200, 200, 2, False)])
def test_param_layout_and_size_match_jax(mode, isz, h, layers, bidi):
    assert trnn._param_layout(mode, isz, h, layers, bidi) == \
        jrnn._param_layout(mode, isz, h, layers, bidi)
    assert trnn.rnn_param_size(mode, isz, h, layers, bidi) == \
        jrnn.rnn_param_size(mode, isz, h, layers, bidi)


def test_begin_state_matches_jax():
    x = np.ones((3, 7, 2), np.float32)
    for axis in (0, 1):
        attrs = {"num_hidden": 5, "batch_axis": axis}
        got = invoke("_begin_state", attrs, torch.from_numpy(x))[0]
        ref = invoke_jax("_begin_state", attrs, jnp.asarray(x))[0]
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert not got.any()


SEQ_CASES = [
    ("SequenceMask", {"use_sequence_length": False}),
    ("SequenceMask", {"use_sequence_length": True, "value": -2.5}),
    ("SequenceMask", {"use_sequence_length": True, "axis": 1}),
    ("SequenceLast", {"use_sequence_length": False}),
    ("SequenceLast", {"use_sequence_length": True}),
    ("SequenceLast", {"use_sequence_length": True, "axis": 1}),
    ("SequenceReverse", {"use_sequence_length": False}),
    ("SequenceReverse", {"use_sequence_length": True}),
]


@pytest.mark.parametrize("op,attrs", SEQ_CASES)
def test_sequence_ops_match_jax(op, attrs):
    """Values and the data's gradient; lengths 1..T, stored as float as
    MXNet feeds them."""
    rng = np.random.default_rng(2)
    # time on axis 0 is (T, batch, ...), on axis 1 (batch, T, ...)
    shape = (4, 6, 3) if attrs.get("axis") == 1 else (6, 4, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    ins = [x]
    if attrs["use_sequence_length"]:
        ins.append(np.array([6, 1, 3, 4], np.float32))
    ref, vjp = jax.vjp(lambda d: invoke_jax(op, attrs, d, *[
        jnp.asarray(a) for a in ins[1:]])[0], jnp.asarray(x))
    cot = rng.standard_normal(np.shape(ref)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    got = invoke(op, attrs, xt, *[torch.from_numpy(a) for a in ins[1:]])[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=FWD_ATOL)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=0, atol=FWD_ATOL)


def test_ops_through_nd_and_symbol():
    """The ops are in ``mt.nd`` and ``mt.sym`` with the reference's input
    counts; shape inference fills the packed parameters and states."""
    attrs = dict(state_size=H, num_layers=2, mode="lstm", state_outputs=True)
    out = mt.sym.RNN(mt.sym.var("data"), mt.sym.var("p"), mt.sym.var("h"),
                     mt.sym.var("c"), **attrs)
    arg_shapes, out_shapes, _ = out.infer_shape(data=(T, N, I))
    assert arg_shapes[1] == (trnn.rnn_param_size("lstm", I, H, 2, False),)
    assert arg_shapes[2] == arg_shapes[3] == (2, N, H)
    assert out_shapes == [(T, N, H), (2, N, H), (2, N, H)]
    with mt.cpu():
        ins = [mt.nd.array(a) for a in _inputs("gru", False, 1)]
        y = mt.nd.RNN(*ins, state_size=H, num_layers=1, mode="gru")
        assert y.shape == (T, N, H)
        last = mt.nd.SequenceLast(y, mt.nd.array([5, 2, 1]),
                                  use_sequence_length=True)
        np.testing.assert_array_equal(
            last.asnumpy(), y.asnumpy()[[4, 1, 0], [0, 1, 2]])
