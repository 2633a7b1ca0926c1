"""The port's initializers against the JAX package's.

Bilinear, LSTMBias, Load and Mixed are deterministic and must equal the
JAX package's bit for bit.  Orthogonal draws its matrix from another
generator in each package, so both are fed the same noise (the JAX
package's ``np.random.uniform``, the port's ``Orthogonal._noise``) and
must then agree to float32 rounding.  MSRAPrelu is a Gaussian whose
scale is the point: over 250,000 draws the sample deviation must be
within 1% of sqrt(2 / (1 + slope^2) / fan) (its standard error is about
0.14%).
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)


def _init(pkg, init, name, shape):
    arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
    init(pkg.init.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 5, 5),
                                   (3, 2, 3, 6)])
def test_bilinear_equals_jax(shape):
    np.testing.assert_array_equal(
        _init(mt, mt.init.Bilinear(), "up_weight", shape),
        _init(mx, mx.init.Bilinear(), "up_weight", shape))


def test_lstm_bias_equals_jax():
    got = _init(mt, mt.init.LSTMBias(forget_bias=2.5), "lstm_i2h_weight",
                (16,))
    np.testing.assert_array_equal(
        got, _init(mx, mx.init.LSTMBias(forget_bias=2.5), "lstm_i2h_weight",
                   (16,)))
    assert got[4:8].tolist() == [2.5] * 4 and got.sum() == 10.0


def test_load_and_mixed_equal_jax(tmp_path):
    """Load from a ``.params`` file the JAX package wrote (arg:/aux:
    prefixes) with a default for missing names; Mixed by regex; a shape
    mismatch and an unmatched name raise in both."""
    rng = np.random.default_rng(0)
    saved = {"arg:fc_weight": rng.standard_normal((3, 4)).astype(np.float32),
             "aux:bn_moving_var": rng.random(3).astype(np.float32)}
    path = str(tmp_path / "init.params")
    mx.nd.save(path, {k: mx.nd.array(v) for k, v in saved.items()})
    for pkg in (mx, mt):
        load = pkg.init.Load(path, default_init=pkg.init.Constant(0.5))
        np.testing.assert_array_equal(_init(pkg, load, "fc_weight", (3, 4)),
                                      saved["arg:fc_weight"])
        np.testing.assert_array_equal(
            _init(pkg, load, "bn_moving_var", (3,)),
            saved["aux:bn_moving_var"])
        np.testing.assert_array_equal(_init(pkg, load, "fc2_weight", (2,)),
                                      np.full(2, 0.5, np.float32))
        with pytest.raises(ValueError, match="Shape mismatch"):
            _init(pkg, load, "fc_weight", (4, 3))
        mixed = pkg.init.Mixed(["conv", ".*"],
                               [pkg.init.Constant(2.0), pkg.init.One()])
        assert _init(pkg, mixed, "conv_weight", (2,)).tolist() == [2.0, 2.0]
        assert _init(pkg, mixed, "fc_weight", (2,)).tolist() == [1.0, 1.0]
        # the name still picks the rule: a bias is zero whatever the match
        assert _init(pkg, mixed, "conv_bias", (2,)).tolist() == [0.0, 0.0]
        with pytest.raises(ValueError, match="did not match"):
            _init(pkg, pkg.init.Mixed(["conv"], [pkg.init.Zero()]),
                  "fc_weight", (2,))
    assert mt.init.create("load", param=path)  # registered by name


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(4, 3, 2, 2), (12, 3)])
def test_orthogonal_matches_jax_on_the_same_noise(monkeypatch, rand_type,
                                                  shape):
    nout, nin = shape[0], int(np.prod(shape[1:]))
    noise = np.random.default_rng(3).uniform(-1, 1, (nout, nin)).astype(
        np.float32)
    monkeypatch.setattr(np.random, rand_type, lambda *a, **k: noise.astype(
        np.float64))
    monkeypatch.setattr(mt.init.Orthogonal, "_noise",
                        lambda self, arr, s: torch.from_numpy(noise))
    want = _init(mx, mx.init.Orthogonal(scale=1.5, rand_type=rand_type),
                 "q_weight", shape)
    got = _init(mt, mt.init.Orthogonal(scale=1.5, rand_type=rand_type),
                "q_weight", shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    q = got.reshape(nout, nin)
    gram = q @ q.T if nout <= nin else q.T @ q
    np.testing.assert_allclose(gram, 2.25 * np.eye(min(nout, nin)),
                               atol=1e-5)


def test_msra_prelu_matches_jax_by_its_scale():
    slope, shape = 0.5, (250, 100, 3, 3)
    fan = (100 * 9 + 250 * 9) / 2.0
    want = math.sqrt(2.0 / (1 + slope ** 2) / fan)
    mt.random.seed(0)
    got = _init(mt, mt.init.MSRAPrelu(slope=slope), "c_weight", shape)
    np.random.seed(0)
    ref = _init(mx, mx.init.MSRAPrelu(slope=slope), "c_weight", shape)
    assert abs(got.std() / want - 1) < 0.01
    assert abs(ref.std() / want - 1) < 0.01
    assert abs(got.mean()) < 0.01 * want


def test_fused_rnn_raises_a_named_error():
    """FusedRNN (ported with the RNN cells) fills a blob of its cell's
    size through a variable's ``__init__`` JSON, the forget gates' biases
    at forget_bias, and names the fault for a blob of no cell's size."""
    init = mt.init.create("fusedrnn", init=None, num_hidden=4, num_layers=1,
                          mode="lstm", forget_bias=2.0)
    desc = mt.init.InitDesc("f_parameters", {"__init__": init.dumps()})
    size = mt.ops.rnn.rnn_param_size("lstm", 3, 4, 1, False)
    with mt.cpu():
        good, bad = mt.nd.zeros((size,)), mt.nd.zeros((size + 1,))
    mt.init.Uniform(0.1)(desc, good)
    blob = good.asnumpy()
    biases = blob[-32:]
    np.testing.assert_array_equal(biases[4:8], 2.0)       # i2h forget
    np.testing.assert_array_equal(biases[20:24], 2.0)     # h2h forget
    assert np.abs(blob[:-32]).max() > 0
    with pytest.raises(mt.MXNetError, match="fused parameter size"):
        mt.init.Uniform(0.1)(desc, bad)
