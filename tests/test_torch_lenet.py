"""LeNet on MNIST through the port's Module API against the JAX package.

``examples/train_mnist.py``'s path at a small size: its synthetic
stand-in (28x28 images from 10 prototypes, noise 0.25, ``default_rng(0)``)
cut to its first 256 images, 4 batches of 64 in order, LeNet at its
published widths, the same Xavier weights drawn on the host in both
packages.  Each step's loss agrees to 1e-5 of its largest magnitude with
SGD (momentum 0.9, wd 1e-4) and with Adam, and so do the parameters after
the run with SGD: both run the same float32 arithmetic with sums in
another order (measured: 1.0e-7 in the losses, 1.2e-6 in the
parameters).  Adam's parameters are held to ADAM_PARAM_RTOL, set from a
control: Adam divides each element's step by its own gradient's running
RMS, so an element whose gradient cancels to 1e-6 of the largest carries
its rounding as a relative error of its step.  The JAX package against
itself, with conv1_weight or fc2_weight moved one ulp, reads 5.7e-5 and
3.4e-5 there (and 0 to 2.6e-8 in the losses); the port reads 8.2e-5.
tests/test_torch_module_api.py holds the rest of the Module API on the
same net and data.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.models as jax_models
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

RTOL = 1e-5
ADAM_PARAM_RTOL = 2e-4      # about 4x the larger control (module doc)
BATCH, N = 64, 256
OPTIMIZERS = {"sgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-4),
              "adam": dict(learning_rate=0.002, wd=1e-4)}


def mnist_stand_in(n):
    """The first ``n`` images and labels of examples/train_mnist.py's
    synthetic stand-in, in its order."""
    rng = np.random.default_rng(0)
    protos = [np.kron(rng.random((7, 7)).astype(np.float32),
                      np.ones((4, 4), np.float32)) for _ in range(10)]
    x, y = [], []
    for k, pr in enumerate(protos):
        for _ in range(200):
            x.append(np.clip(pr + rng.normal(0, 0.25, (28, 28)), 0, 1))
            y.append(k)
    x = np.stack(x)[:, None].astype(np.float32) - 0.5
    y = np.asarray(y, np.float32)
    order = rng.permutation(len(y))
    return x[order][:n], y[order][:n]


@pytest.fixture(scope="module")
def lenet():
    with mx.base.NameManager(), mt.base.NameManager():
        jsym, tsym = jax_models.get_lenet(), mt.models.get_lenet()
    x, y = mnist_stand_in(N)
    # Xavier (uniform, avg, magnitude 3) on the host
    rng = np.random.default_rng(1)
    args = {}
    shapes, _, _ = tsym.infer_shape(data=(BATCH, 1, 28, 28))
    for name, shape in zip(tsym.list_arguments(), shapes):
        if name.endswith("_weight"):
            fan = (shape[0] + shape[1]) * np.prod(shape[2:]) / 2.0
            lim = np.sqrt(3.0 / fan)
            args[name] = rng.uniform(-lim, lim, shape).astype(np.float32)
        elif name.endswith("_bias"):
            args[name] = np.zeros(shape, np.float32)
    return jsym, tsym, args, x, y


@pytest.mark.parametrize("get", ["get_lenet", "get_mlp"])
def test_symbols_equal_jax(get):
    with mx.base.NameManager(), mt.base.NameManager():
        assert getattr(mt.models, get)().tojson() \
            == getattr(jax_models, get)().tojson()


def _loss(mod, batch):
    probs = mod.get_outputs()[0].asnumpy()
    labels = batch.label[0].asnumpy().astype(np.int64)
    return float(-np.log(probs[np.arange(len(labels)), labels]).mean())


def _fit(pkg, sym, args, x, y, optimizer, num_epoch=1, mod=None,
         begin_epoch=0, **fit_kwargs):
    losses = []

    def on_batch(param):
        losses.append(_loss(param.locals["self"], param.locals["batch"]))
    mod = mod or pkg.mod.Module(sym, context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(x, y, BATCH, label_name="softmax_label"),
            num_epoch=num_epoch, begin_epoch=begin_epoch,
            optimizer=optimizer, optimizer_params=OPTIMIZERS[optimizer],
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()},
            batch_end_callback=on_batch, **fit_kwargs)
    return mod, np.array(losses)


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _close(got, want, what, rtol=RTOL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_fit_matches_jax(lenet, optimizer):
    jsym, tsym, args, x, y = lenet
    jmod, jl = _fit(mx, jsym, args, x, y, optimizer)
    tmod, tl = _fit(mt, tsym, args, x, y, optimizer)
    assert len(tl) == N // BATCH
    _close(tl, jl, "losses")
    assert tl[-1] < tl[0]
    jp = _params(jmod)
    for k, v in _params(tmod).items():
        _close(v, jp[k], k, ADAM_PARAM_RTOL if optimizer == "adam" else RTOL)
