"""The normalization layers (BatchNorm with its moving statistics,
InstanceNorm) and the containers (Sequential, HybridSequential) of the
PyTorch port's ``gluon.nn`` against the JAX package's, by the comparison
of test_torch_gluon_layers.py; Dropout by its contract and Embedding
against the JAX package.  Tolerance: 1e-5 relative and 1e-6 absolute in
float32 (1e-5 absolute for parameter gradients).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from test_torch_gluon_layers import LAYERS, _check_layer, _close, _ctx

torch.set_num_threads(1)


def _seq(nn, kind):
    net = kind(prefix="l_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(), nn.Flatten(),
                nn.Dense(3))
    return net


NORM = {
    "BatchNorm": (lambda nn: nn.BatchNorm(momentum=0.8, prefix="l_"),
                  (4, 3, 5, 5)),
    "BatchNorm NHWC no scale": (lambda nn: nn.BatchNorm(
        axis=-1, scale=False, prefix="l_"), (4, 5, 5, 3)),
    "InstanceNorm": (lambda nn: nn.InstanceNorm(scale=True, prefix="l_"),
                     (2, 3, 4, 5)),
    "HybridSequential": (lambda nn: _seq(nn, nn.HybridSequential),
                         (2, 3, 6, 6)),
    "Sequential": (lambda nn: _seq(nn, nn.Sequential), (2, 3, 6, 6)),
}
LAYERS.update(NORM)


@pytest.mark.parametrize("name", sorted(NORM))
@pytest.mark.parametrize("hybrid", [False, True])
def test_layer_against_jax(name, hybrid):
    _check_layer(name, hybrid)


def test_dropout_layer():
    """Identity in predict mode, as the JAX package's; in training each
    element kept with probability 1 - rate and scaled by 1 / (1 - rate)."""
    x = np.ones((50, 40), np.float32)
    with mt.cpu():
        d = mt.gluon.nn.Dropout(0.25)
        np.testing.assert_array_equal(d(mt.nd.array(x)).asnumpy(), x)
        with mt.autograd.record():
            y = d(mt.nd.array(x)).asnumpy()
    assert abs((y != 0).mean() - 0.75) < 0.03
    np.testing.assert_allclose(y[y != 0], 1 / 0.75)
    np.testing.assert_array_equal(
        mj.gluon.nn.Dropout(0.25)(mj.nd.array(x)).asnumpy(), x)


def test_embedding_layer():
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 10, (3, 4)).astype(np.float32)
    w = rng.standard_normal((10, 5)).astype(np.float32)
    outs = []
    for pkg in (mj, mt):
        e = pkg.gluon.nn.Embedding(10, 5, prefix="e_")
        e.initialize(ctx=_ctx(pkg))
        e.weight.set_data(pkg.nd.array(w, ctx=_ctx(pkg)))
        with pkg.autograd.record():
            y = e(pkg.nd.array(idx, ctx=_ctx(pkg)))
            (y * y).sum().backward()
        outs.append((y, e.weight.grad()))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1])
