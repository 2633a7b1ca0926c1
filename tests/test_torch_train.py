"""Training ResNet through the PyTorch port against the JAX package.

A small fused ResNet (two stages, one fused bottleneck unit each, the
1x1-convolution backward kernel on at both stages) at batch 4, the same
numpy weights and batches in both packages:

- ``Executor``: ``simple_bind`` -> ``forward(is_train=True)`` ->
  ``backward()`` gives every argument's gradient and the aux write-backs
  of the JAX executor;
- ``Module.fit``: three SGD steps (lr 0.05, momentum 0.9, wd 1e-4) give
  the same loss and accuracy at each step and the same parameters after
  the first, and the port's checkpoint loads in the JAX package (and the
  reverse).

Tolerance, from a measured control: in this net a 1e-6 relative change
of the stem weight alone moves bn0_gamma's gradient by 2.8e-5 of its
largest magnitude, as BatchNorm+ReLU chains amplify rounding with depth.
The two packages sum in other orders throughout (port against JAX: 9.8e-5
at most, on the same gradient), so gradients, losses and parameters are
held to 1e-3 of their largest magnitude.  The JAX side runs its Pallas
kernels in interpret mode, as its own tests do.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu.models.resnet import _resnet as jax_small_resnet
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.resnet import _resnet as port_small_resnet

torch.set_num_threads(1)

TOL = 1e-3
BATCH = 4
NET = (([2, 2], 2, [16, 64, 128], 10, (3, 64, 64), True),
       dict(layout="NHWC", unit_impl="fused"))
SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4)


@pytest.fixture(scope="module")
def net():
    with mj.base.NameManager(), mt.base.NameManager():
        jsym = jax_small_resnet(*NET[0], **NET[1])
        tsym = port_small_resnet(*NET[0], **NET[1])
    assert jsym.tojson() == tsym.tojson()
    args, aux = mt.convert.random_params(tsym, {"data": (BATCH, 64, 64, 3)},
                                         seed=0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3 * BATCH, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, 3 * BATCH).astype(np.float32)
    return jsym, tsym, args, aux, x, y


@pytest.fixture
def fused_1x1_bwd(monkeypatch):
    monkeypatch.setenv("MXNET_CONV1X1_FUSED_BWD", "1")
    from mxnet_tpu_torch.ops import nn
    calls = []
    plain = nn.conv1x1_bwd_plain
    monkeypatch.setattr(nn, "conv1x1_bwd_plain",
                        lambda *a: calls.append(a) or plain(*a))
    return calls


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err <= TOL, (what, err)


def _fit(pkg, sym, args, aux, x, y, ctx, first=None):
    """Three SGD steps through Module.fit; returns (per-step cumulative
    (accuracy, cross-entropy), parameters after step 1, the module).
    ``first``, a dict, also gets step 1's output, gradients (the data's
    too: the module is bound with ``inputs_need_grad``) and aux
    states."""
    steps, after_first = [], {}

    def on_batch(param):
        steps.append([v for _, v in param.eval_metric.get_name_value()])
        if param.nbatch == 0:
            ex = param.locals["self"]._exec
            after_first.update({k: ex.arg_dict[k].asnumpy() for k in args})
            if first is not None:
                first["output"] = ex.outputs[0].asnumpy()
                first["grads"] = {k: g.asnumpy()
                                  for k, g in ex.grad_dict.items()}
                first["aux"] = {k: a.asnumpy()
                                for k, a in ex.aux_dict.items()}
    mod = pkg.mod.Module(sym, context=ctx)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH)
    if first is not None:
        mod.bind(it.provide_data, it.provide_label, inputs_need_grad=True)
    mod.fit(it,
            eval_metric=["acc", "ce"], optimizer="sgd",
            optimizer_params=SGD, kvstore="local", num_epoch=1,
            arg_params={k: pkg.nd.array(v, ctx=ctx) for k, v in args.items()},
            aux_params={k: pkg.nd.array(v, ctx=ctx) for k, v in aux.items()},
            batch_end_callback=[on_batch,
                                pkg.callback.Speedometer(BATCH, 1)])
    return np.array(steps), after_first, mod


@pytest.fixture(scope="module")
def jax_fit(net):
    """The JAX package's Module.fit (``_fit``), run once for the module:
    its step 1 is also the JAX side of the Executor test (forward,
    backward, then the outputs, as fit orders them)."""
    jsym, _, args, aux, x, y = net
    first = {}
    jsteps, jfirst, jmod = _fit(mj, jsym, args, aux, x, y, mj.cpu(), first)
    return jsteps, jfirst, jmod, first


def test_executor_gradients_match_jax(net, jax_fit, fused_1x1_bwd):
    jsym, tsym, args, aux, x, y = net
    want = jax_fit[3]
    shapes = {"data": (BATCH, 64, 64, 3), "softmax_label": (BATCH,)}
    tex = tsym.simple_bind(mt.cpu(), grad_req="write", **shapes)
    tex.copy_params_from(
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in args.items()},
        {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in aux.items()})
    # the order Module.fit uses: forward, backward, then the outputs
    tex.forward(is_train=True, data=x[:BATCH], softmax_label=y[:BATCH])
    tex.backward()
    # K8 took the five stride-1 1x1 convolutions at H*W <= 256: conv1,
    # conv3 and the shortcut of stage 1's transition unit, conv1 and conv3
    # of stage 2's
    assert len(fused_1x1_bwd) == 5
    _close(tex.outputs[0].asnumpy(), want["output"], "output")
    for n, g in zip(tsym.list_arguments(), tex.grad_arrays):
        if n == "softmax_label":          # the loss head's: zeros
            assert not g.asnumpy().any()
        else:
            _close(g.asnumpy(), want["grads"][n], n)
    for n in tsym.list_auxiliary_states():
        _close(tex.aux_dict[n].asnumpy(), want["aux"][n], n)


def test_module_fit_matches_jax_and_checkpoints_interchange(
        net, jax_fit, fused_1x1_bwd, tmp_path):
    jsym, tsym, args, aux, x, y = net
    jsteps, jfirst, jmod, _ = jax_fit
    tsteps, tfirst, tmod = _fit(mt, tsym, args, aux, x, y, mt.cpu())
    assert tsteps.shape == jsteps.shape == (3, 2)
    assert np.isfinite(tsteps).all()
    np.testing.assert_array_equal(tsteps[:, 0], jsteps[:, 0])   # accuracy
    _close(tsteps[:, 1], jsteps[:, 1], "cross-entropy")
    for k in args:
        _close(tfirst[k], jfirst[k], k)
    # scoring the trained modules in inference mode (moving statistics)
    scores = [m.score(pkg.io.NDArrayIter(x, y, batch_size=BATCH),
                      ["acc", "ce"])
              for m, pkg in ((jmod, mj), (tmod, mt))]
    assert scores[1][0] == scores[0][0]
    _close(scores[1][1][1], scores[0][1][1], "score cross-entropy")

    # the port's checkpoint in the JAX package, and the JAX one in the port
    prefix = str(tmp_path / "small")
    tmod.save_checkpoint(prefix, 3)
    sym, jargs, jaux = mj.model.load_checkpoint(prefix, 3)
    targs, taux = tmod.get_params()
    assert sym.tojson() == tsym.tojson()
    assert set(jargs) == set(targs) and set(jaux) == set(taux)
    for k in targs:
        np.testing.assert_array_equal(jargs[k].asnumpy(), targs[k].asnumpy())
    for k in taux:
        np.testing.assert_array_equal(jaux[k].asnumpy(), taux[k].asnumpy())
    jprefix = str(tmp_path / "small_jax")
    jmod.save_checkpoint(jprefix, 3)
    _, pargs, paux = mt.model.load_checkpoint(jprefix, 3)
    jparams = jmod.get_params()
    for got, want in ((pargs, jparams[0]), (paux, jparams[1])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].asnumpy(),
                                          want[k].asnumpy())


def test_4d_training_checkpoint_gives_the_jax_4d_eval_output(
        net, tmp_path, monkeypatch):
    """Train under MXNET_FUSED_UNIT_C3=4d in the port (K4/K7, their plain
    versions here), save the checkpoint, load it with the JAX package's
    load_checkpoint and run both packages' 4d eval forward on it: the
    same probabilities within 2e-5 of the largest (float32 sums in
    another order through the net)."""
    monkeypatch.setenv("MXNET_FUSED_UNIT_C3", "4d")
    jsym, tsym, args, aux, x, y = net
    _steps, _first, tmod = _fit(mt, tsym, args, aux, x, y, mt.cpu())
    prefix = str(tmp_path / "small_4d")
    tmod.save_checkpoint(prefix, 3)
    sym, jargs, jaux = mj.model.load_checkpoint(prefix, 3)
    targs, taux = tmod.get_params()
    assert sym.tojson() == tsym.tojson()
    shapes = {"data": (BATCH, 64, 64, 3), "softmax_label": (BATCH,)}
    feed = dict(data=x[:BATCH], softmax_label=y[:BATCH])
    jex = sym.simple_bind(mj.cpu(), grad_req="null", **shapes)
    jex.copy_params_from(jargs, jaux)
    want = jex.forward(is_train=False, **feed)[0].asnumpy()
    tex = tsym.simple_bind(mt.cpu(), grad_req="null", **shapes)
    tex.copy_params_from(targs, taux)
    got = tex.forward(is_train=False, **feed)[0].asnumpy()
    assert np.isfinite(got).all() and got.shape == (BATCH, 10)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= 2e-5, err


def test_ndarray_iter_pads_and_shuffles_from_the_seed():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    y = np.arange(5, dtype=np.float32)
    batches = list(mt.io.NDArrayIter(x, y, batch_size=2))
    assert [b.pad for b in batches] == [0, 0, 1]
    np.testing.assert_array_equal(batches[2].data[0].asnumpy(),
                                  [[8, 9], [0, 1]])
    assert [b.pad for b in mt.io.NDArrayIter(
        x, y, batch_size=2, last_batch_handle="discard")] == [0, 0]
    orders = []
    for _ in range(2):
        mt.random.seed(3)
        it = mt.io.NDArrayIter(x, y, batch_size=5, shuffle=True)
        b = next(iter(it))
        np.testing.assert_array_equal(b.data[0].asnumpy()[:, 0] / 2,
                                      b.label[0].asnumpy())
        orders.append(b.label[0].asnumpy())
    np.testing.assert_array_equal(orders[0], orders[1])
    assert sorted(orders[0]) == list(range(5))


def test_initializer_dispatches_on_names_from_the_seed():
    shapes = {"fc_weight": (4, 6), "fc_bias": (4,), "bn_gamma": (3,),
              "bn_beta": (3,), "bn_moving_mean": (3,), "bn_moving_var": (3,)}
    draws = []
    for _ in range(2):
        mt.random.seed(5)
        arrs = {k: mt.nd.zeros(s, ctx=mt.cpu()) for k, s in shapes.items()}
        for k, a in arrs.items():
            mt.init.Xavier(magnitude=2)(mt.init.InitDesc(k), a)
        draws.append(arrs["fc_weight"].asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    bound = np.sqrt(2.0 / 5.0)       # Xavier avg: fans 6 and 4
    assert 0 < np.abs(draws[0]).max() <= bound
    for k, want in (("fc_bias", 0), ("bn_gamma", 1), ("bn_beta", 0),
                    ("bn_moving_mean", 0), ("bn_moving_var", 1)):
        np.testing.assert_array_equal(arrs[k].asnumpy(), want)


def test_executor_grad_req_add_accumulates_and_null_skips():
    """grad_req per argument: 'add' sums over backward passes, 'write'
    replaces, 'null' allocates nothing; aux states move once per
    training forward."""
    data = mt.sym.Variable("data")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.BatchNorm(data, fix_gamma=False, name="bn"), num_hidden=3,
        name="fc"), name="softmax")
    rng = np.random.default_rng(2)
    shapes = {"data": (4, 5), "softmax_label": (4,)}
    reqs = {"fc_weight": "add", "fc_bias": "write", "bn_gamma": "write",
            "bn_beta": "write"}
    ex = net.simple_bind(mt.cpu(), grad_req=reqs, **shapes)
    assert "data" not in ex.grad_dict and "softmax_label" not in ex.grad_dict
    weight = rng.standard_normal((3, 5))
    ex.copy_params_from({"fc_weight": mt.nd.array(weight, ctx=mt.cpu()),
                         "bn_gamma": mt.nd.array(np.ones(5), ctx=mt.cpu())})
    feed = dict(data=rng.standard_normal((4, 5)).astype(np.float32),
                softmax_label=np.array([0, 1, 2, 1], np.float32))
    grads, means = [], []
    for _ in range(2):
        ex.forward(is_train=True, **feed)
        ex.backward()
        grads.append({n: g.asnumpy() for n, g in ex.grad_dict.items()})
        means.append(ex.aux_dict["bn_moving_mean"].asnumpy())
    np.testing.assert_allclose(grads[1]["fc_weight"],
                               2 * grads[0]["fc_weight"], rtol=1e-6)
    np.testing.assert_array_equal(grads[1]["fc_bias"], grads[0]["fc_bias"])
    batch_mean = feed["data"].mean(0)
    np.testing.assert_allclose(means[0], 0.1 * batch_mean, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(means[1], 0.19 * batch_mean, rtol=1e-5,
                               atol=1e-7)
