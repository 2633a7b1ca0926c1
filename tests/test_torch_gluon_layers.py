"""The basic layers of the PyTorch port's ``gluon.nn`` (Dense,
Activation, LeakyReLU, Flatten, Lambda, HybridLambda) against the JAX
package's: each layer built in both from the same seeded weights, run in
training (output, input and parameter gradients) and in predict mode, the
port imperative and hybridized, the JAX package hybridized.  The
normalization layers and the containers are in test_torch_gluon_norm.py,
the convolution and pooling layers in test_torch_gluon_conv.py and
test_torch_gluon_pool.py, which share this file's comparison.  Tolerance:
1e-5 relative and 1e-6 absolute in float32 (1e-5 absolute for parameter
gradients, sums over the batch taken in another order).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _close(ours, ref, rtol=RTOL, atol=ATOL):
    ours = ours.asnumpy() if hasattr(ours, "asnumpy") else np.asarray(ours)
    ref = ref.asnumpy() if hasattr(ref, "asnumpy") else np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=atol)


def _ctx(pkg):
    return pkg.cpu()


def _seeded_values(params, rng):
    """Seeded numpy values for a ParameterDict, keyed by name: variances
    and scales positive."""
    out = {}
    for name, p in params.items():
        if name.endswith(("running_var", "gamma")):
            out[name] = rng.uniform(0.5, 1.5, p.shape).astype(np.float32)
        else:
            out[name] = (rng.standard_normal(p.shape) * 0.5) \
                .astype(np.float32)
    return out


def _set_all(pkg, params, values):
    for name, p in params.items():
        p.set_data(pkg.nd.array(values[name], ctx=_ctx(pkg)))


BASIC = {
    "Dense": (lambda nn: nn.Dense(5, activation="tanh", prefix="l_"),
              (3, 4, 2)),
    "Dense no bias, no flatten": (lambda nn: nn.Dense(
        5, use_bias=False, flatten=False, prefix="l_"), (3, 4, 2)),
    "Activation relu": (lambda nn: nn.Activation("relu", prefix="l_"),
                        (3, 7)),
    "Activation sigmoid": (lambda nn: nn.Activation("sigmoid", prefix="l_"),
                           (3, 7)),
    "Activation softrelu": (lambda nn: nn.Activation("softrelu",
                                                     prefix="l_"), (3, 7)),
    "Activation softsign": (lambda nn: nn.Activation("softsign",
                                                     prefix="l_"), (3, 7)),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.2, prefix="l_"), (3, 7)),
    "Flatten": (lambda nn: nn.Flatten(prefix="l_"), (3, 2, 4)),
    "HybridLambda": (lambda nn: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2 + F.exp(x), prefix="l_"), (3, 4)),
    "Lambda": (lambda nn: nn.Lambda("tanh", prefix="l_"), (3, 4)),
}


LAYERS = dict(BASIC)


def _layer_run(pkg, layer, x, cot, training):
    """Output, input gradient, parameter gradients (training) and the
    parameters afterwards."""
    xs = pkg.nd.array(x, ctx=_ctx(pkg))
    xs.attach_grad()
    with pkg.autograd.record(train_mode=training):
        y = layer(xs)
        loss = (y * pkg.nd.array(cot, ctx=_ctx(pkg))).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in layer.collect_params().items()
             if p.grad_req != "null"}
    after = {k: p.data().asnumpy() for k, p in
             layer.collect_params().items()}
    return y.asnumpy(), xs.grad.asnumpy(), grads, after


_JAX_LAYER_RUNS = {}


def _layer_case(name):
    """(input, cotangent, parameter values) of layer ``name`` from its
    seed, and the JAX package's hybridized runs (training, then predict),
    computed once for both of the port's modes."""
    if name not in _JAX_LAYER_RUNS:
        build, shape = LAYERS[name]
        rng = np.random.default_rng(sum(map(ord, name)))
        x = rng.standard_normal(shape).astype(np.float32)
        layer, out = _built(mj, build, x)
        values = _seeded_values(layer.collect_params(), rng)
        _set_all(mj, layer.collect_params(), values)
        cot = rng.standard_normal(out.shape).astype(np.float32)
        runs = [_layer_run(mj, layer, x, cot, training)
                for training in (True, False)]
        _JAX_LAYER_RUNS[name] = (x, cot, values, runs)
    return _JAX_LAYER_RUNS[name]


def _built(pkg, build, x, hybrid=True):
    """The layer, initialized on the CPU (a first predict-mode call
    finishes the deferred shapes), hybridized if asked; and that call's
    output."""
    layer = build(pkg.gluon.nn)
    layer.collect_params().initialize(ctx=_ctx(pkg))
    if hybrid and isinstance(layer, pkg.gluon.HybridBlock):
        layer.hybridize()
    with pkg.autograd.pause():
        out = layer(pkg.nd.array(x, ctx=_ctx(pkg)))
    return layer, out


@pytest.mark.parametrize("name", sorted(BASIC))
@pytest.mark.parametrize("hybrid", [False, True])
def test_layer_against_jax(name, hybrid):
    _check_layer(name, hybrid)


def _check_layer(name, hybrid):
    """The port's layer, imperative or hybridized, against the JAX
    package's hybridized one (whose imperative and hybridized runs agree,
    tests/test_gluon.py), from the same weights."""
    x, cot, values, runs = _layer_case(name)
    layer = _built(mt, LAYERS[name][0], x, hybrid)[0]
    _set_all(mt, layer.collect_params(), values)
    for training, ref in zip((True, False), runs):
        got = _layer_run(mt, layer, x, cot, training)
        _close(got[0], ref[0])
        _close(got[1], ref[1])
        assert sorted(got[2]) == sorted(ref[2])
        for k in ref[2]:
            _close(got[2][k], ref[2][k], atol=1e-5)
        for k in ref[3]:                     # BatchNorm's moving statistics
            _close(got[3][k], ref[3][k])
