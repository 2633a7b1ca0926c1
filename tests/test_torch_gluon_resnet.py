"""The model zoo's ResNet-18 v2 in the PyTorch port against the JAX
package's, trained through Gluon's Trainer, and the zoo's parameter names
and files.

Both packages build ``resnet18_v2(classes=10, thumbnail=True)`` with the
same seeded weights (``convert.gluon_random_params``, carried into the
JAX package through a ``.params`` file the port wrote), hybridize it and
take 2 SGD steps (momentum 0.9, wd 1e-4) on one seeded 32x32 batch of 4
through ``SoftmaxCrossEntropyLoss``; ResNet-18 v1 is held the same way in
test_torch_gluon_resnet_v1.py.  Held: step 1's loss to 1e-5 relative;
step 2's loss, step 1's gradients over all parameters together (relative
L2) and the parameters and moving statistics after step 2 (absolute)
each within 3x a control.

The control is the JAX package against itself: the same two steps on the
batch reversed (the same sums in another order) move its step-2 loss by
7.0e-5 (v2) and 4.6e-4 (v1) relative, its step-1 gradients by 5.2e-3 and
3.5e-3 relative L2 and its parameters by 4.6e-4 and 3.9e-4, while the
port's move by 0, 1.5e-6 and 1.1e-5 (measured on the CPU at these seeds).
A ReLU whose input rounds to zero routes its gradient as 0.5 in the JAX
package and 0 in torch (``ROADMAP.md`` Queue C), and a BatchNorm backward
takes sum(dy * x) - mean * sum(dy), which cancels at random weights.  The
port read 5.8e-7 / 4.2e-6 / 1.1e-5 (v2) and 1.1e-3 / 6.2e-3 / 6.4e-4 (v1)
against the JAX package.  Within the port the hybridized net equals the
imperative one bit for bit.
"""
import hashlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

BATCH, SIDE = 4, 32
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
LOSS_RTOL = 1e-5
# 3x the JAX package's batch-reversed control (module docstring)
LIMITS = {"resnet18_v2": {"loss2": 2.1e-4, "grad": 1.6e-2, "param": 1.4e-3},
          "resnet18_v1": {"loss2": 1.4e-3, "grad": 1.06e-2,
                          "param": 1.2e-3}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, 3, SIDE, SIDE)).astype(np.float32)
    return x, rng.integers(0, 10, BATCH).astype(np.float32)


def _net(pkg, family):
    return getattr(pkg.gluon.model_zoo.vision, family)(
        classes=10, thumbnail=True, prefix="net_")


def _train(pkg, net, x, y, steps=2):
    """Per-step losses, step 1's gradients, and every parameter after the
    last step, keyed without the net's prefix."""
    ctx = pkg.cpu()
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    xs, ys = pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx)
    losses, grads = [], None
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        if grads is None:
            grads = {k[4:]: p.grad().asnumpy() for k, p in
                     net.collect_params().items() if p.grad_req != "null"}
        trainer.step(BATCH)
        losses.append(loss.asnumpy())
    return losses, grads, {k[4:]: p.data().asnumpy()
                           for k, p in net.collect_params().items()}


def _rel_l2(got, ref):
    num = sum(float(((got[k] - ref[k]).astype(np.float64) ** 2).sum())
              for k in ref)
    den = sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


def check_family(family, tmp_path):
    x, y = _batch(11)
    port = _net(mt, family)
    weights = mt.convert.gluon_random_params(port, (1, 3, SIDE, SIDE),
                                             seed=12)
    mt.convert.gluon_params_from_numpy(port, weights, ctx=mt.cpu())
    path = str(tmp_path / "weights.params")
    port.save_params(path)
    ref_net = _net(mj, family)
    ref_net.load_params(path, ctx=mj.cpu())
    ref_net.hybridize()
    port.hybridize()
    ref = _train(mj, ref_net, x, y)
    got = _train(mt, port, x, y)
    lim = LIMITS[family]
    np.testing.assert_allclose(got[0][0], ref[0][0], rtol=LOSS_RTOL,
                               atol=1e-6)
    loss2 = abs(got[0][1].mean() - ref[0][1].mean()) / abs(ref[0][1].mean())
    assert loss2 < lim["loss2"]
    assert sorted(got[1]) == sorted(ref[1])
    assert all(np.abs(g).sum() > 0 for g in got[1].values())
    assert _rel_l2(got[1], ref[1]) < lim["grad"]
    for k, v in ref[2].items():
        np.testing.assert_allclose(got[2][k], v, rtol=0, atol=lim["param"])
    # the port hybridized against the port imperative, bit for bit
    imp = _net(mt, family)
    mt.convert.gluon_params_from_numpy(imp, weights, ctx=mt.cpu())
    again = _train(mt, imp, x, y)
    for a, b in zip(again[0], got[0]):
        np.testing.assert_array_equal(a, b)
    for k in got[1]:
        np.testing.assert_array_equal(again[1][k], got[1][k])
    for k in got[2]:
        np.testing.assert_array_equal(again[2][k], got[2][k])


def test_resnet18_v2_against_jax(tmp_path):
    check_family("resnet18_v2", tmp_path)


def test_second_step_reaches_every_parameter():
    """After a Trainer step, every parameter still gets a gradient: the
    update writes into the variable the recorded graph reaches."""
    x, y = _batch(13)
    with mt.cpu():
        net = _net(mt, "resnet18_v2")
        net.initialize(mt.init.Xavier())
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(2):
            for p in net.collect_params().values():
                if p.grad_req != "null":
                    p.zero_grad()
            with mt.autograd.record():
                loss = loss_fn(net(mt.nd.array(x)), mt.nd.array(y))
            loss.backward()
            trainer.step(BATCH)
    dead = [k for k, p in net.collect_params().items()
            if p.grad_req != "null" and not p.grad().asnumpy().any()]
    assert not dead


def _digest(net):
    names = sorted(k[len(net.prefix):] for k in net.collect_params().keys())
    return (hashlib.sha256("\n".join(names).encode()).hexdigest()[:16],
            len(names))


# the JAX package's digests of the stripped parameter names
# (tests/test_gluon.py test_model_zoo_param_names_stable)
DIGESTS = {
    "resnet18_v1": ("6a7f0b648e49d072", 102),
    "resnet50_v1": ("3cd872f679085f3c", 299),
    "resnet18_v2": ("6bbaf610941c4837", 98),
    "resnet50_v2": ("0e4f949c1c42fa07", 259),
    "mobilenet1_0": ("2659607d2096c3a9", 137),
    "vgg11": ("a4bc9d6b177ca551", 22),
    "vgg16_bn": ("94e9598facd36ced", 84),
    "alexnet": ("5a0fac7afd50f1ea", 16),
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_model_zoo_param_names_match_jax(name):
    zoo = mt.gluon.model_zoo.vision
    net = zoo.get_model(name.replace("mobilenet1_0", "mobilenet1.0"),
                        classes=10)
    assert _digest(net) == DIGESTS[name]


def test_get_model_names_the_unported_families():
    for name in ("densenet121", "squeezenet1.0", "inceptionv3"):
        with pytest.raises(ValueError, match="not ported"):
            mt.gluon.model_zoo.vision.get_model(name)
    with pytest.raises(IOError):
        mt.gluon.model_zoo.vision.resnet18_v1(pretrained=True,
                                              root="/nonexistent")


def test_params_files_cross_the_packages(tmp_path):
    """A file the port's save_params wrote loads in the JAX package's
    load_params, and the file the JAX package then writes loads back in
    the port's, bit for bit."""
    pnet = _net(mt, "resnet18_v1")
    want = mt.convert.gluon_random_params(pnet, (1, 3, SIDE, SIDE), seed=15)
    mt.convert.gluon_params_from_numpy(pnet, want, ctx=mt.cpu())
    ppath = str(tmp_path / "port.params")
    pnet.save_params(ppath)
    jnet = _net(mj, "resnet18_v1")
    jnet.load_params(ppath, ctx=mj.cpu())
    for k, p in jnet.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), want[k[4:]])
    jpath = str(tmp_path / "jax.params")
    jnet.save_params(jpath)
    back = _net(mt, "resnet18_v1")
    back.load_params(jpath, ctx=mt.cpu())
    got = mt.convert.gluon_params_to_numpy(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
