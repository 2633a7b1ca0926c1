"""SSD (``models/ssd.py``) in the port against the JAX package.

The ``vgg16_reduced`` graphs of ``examples/train_ssd.py`` are compared as
symbol JSON and by shape inference at the example's 300x300, batch 32,
not run.  The two-scale ``testnet`` runs in both packages from one set
of seeded parameters: a training step through ``Module`` (the outputs
within OUT_ATOL, the gradients within GRAD_RTOL by relative L2 over all
parameters together; both compute in float32, with sums in another
order: about 1e-7 measured), and the detect graph through both
packages' ``Predictor`` (kept class ids equal, scores and boxes within
DET_ATOL).  ``tests/test_torch_det_iter.py`` trains the port's testnet
through ``Module`` on the detection iterator.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.models import get_ssd_symbol as jax_ssd
import mxnet_tpu_torch as mt

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-5
DET_ATOL = 1e-5
IMG, BATCH, N_CLASSES, PAD = 32, 4, 3, 4


def _symbols(network, mode, **kw):
    with mx.base.NameManager(), mt.base.NameManager():
        return (jax_ssd(network, mode=mode, **kw),
                mt.models.get_ssd_symbol(network, mode=mode, **kw))


@pytest.mark.parametrize("mode", ["train", "detect"])
def test_vgg16_reduced_symbol_json_matches_jax(mode):
    jsym, tsym = _symbols("vgg16_reduced", mode, num_classes=20)
    assert tsym.tojson() == jsym.tojson()


def test_vgg16_reduced_infers_the_example_shapes():
    _, tsym = _symbols("vgg16_reduced", "train", num_classes=20)
    args, outs, _ = tsym.infer_shape(data=(32, 3, 300, 300),
                                     label=(32, 24, 5))
    assert tsym.list_outputs() == ["cls_prob_output", "loc_loss_output",
                                   "cls_label_output"]
    assert outs == [(32, 21, 8040), (32, 8040 * 4), (32, 8040)]
    n_params = sum(int(np.prod(s)) for n, s in
                   zip(tsym.list_arguments(), args)
                   if n not in ("data", "label"))
    assert n_params == 25167662


@pytest.mark.parametrize("mode", ["train", "detect"])
def test_testnet_symbol_json_matches_jax(mode):
    jsym, tsym = _symbols("testnet", mode, num_classes=N_CLASSES)
    assert tsym.tojson() == jsym.tojson()


@pytest.fixture(scope="module")
def testnet_data():
    _, tsym = _symbols("testnet", "train", num_classes=N_CLASSES)
    args, _ = mt.convert.random_params(
        tsym, {"data": (BATCH, 3, IMG, IMG), "label": (BATCH, PAD, 5)},
        seed=0)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (BATCH, 3, IMG, IMG)).astype(np.float32)
    y = np.full((BATCH, PAD, 5), -1.0, np.float32)
    for i in range(BATCH):
        n = 1 + i % PAD
        y[i, :n, 0] = rng.integers(0, N_CLASSES, n)
        xy = rng.uniform(0.0, 0.3, (n, 2))
        y[i, :n, 1:] = np.concatenate(
            [xy, xy + rng.uniform(0.15, 0.7, (n, 2))], axis=1)
    return args, x, y


def _step(pkg, args, x, y, ctx):
    """One forward and backward through Module: (the outputs, the
    gradients)."""
    jsym, tsym = _symbols("testnet", "train", num_classes=N_CLASSES)
    mod = pkg.mod.Module(jsym if pkg is mx else tsym, context=ctx,
                         data_names=("data",), label_names=("label",))
    it = pkg.io.NDArrayIter(x, y, batch_size=len(x), label_name="label")
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                for k, v in args.items()})
    mod.forward_backward(next(iter(it)))
    return ([o.asnumpy() for o in mod.get_outputs()],
            {k: mod._exec.grad_dict[k].asnumpy() for k in args})


def _rel_l2(got, want):
    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum())
              for k in want)
    den = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def test_testnet_step_matches_jax(testnet_data):
    args, x, y = testnet_data
    j_outs, j_grads = _step(mx, args, x, y, mx.cpu())
    t_outs, t_grads = _step(mt, args, x, y, mt.cpu())
    assert [o.shape for o in t_outs] == [(BATCH, N_CLASSES + 1, 240),
                                         (BATCH, 960), (BATCH, 240)]
    for got, want in zip(t_outs, j_outs):
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)
    assert (t_outs[2] > 0).any() and (t_outs[2] == -1).any()
    assert _rel_l2(t_grads, j_grads) <= GRAD_RTOL
    # both scales' heads learn from this batch
    assert all(np.abs(g).sum() > 0 for g in t_grads.values())


def test_testnet_detect_predictor_matches_jax(testnet_data):
    args, x, _ = testnet_data
    jsym, tsym = _symbols("testnet", "detect", num_classes=N_CLASSES,
                          nms_topk=50)
    shapes = {"data": (BATCH, 3, IMG, IMG)}
    params = {k: v for k, v in args.items() if k in tsym.list_arguments()}
    jp = mx.Predictor(jsym, {k: mx.nd.array(v) for k, v in params.items()},
                      {}, shapes, ctx=mx.cpu())
    want = jp.forward(data=x).get_output(0)
    with mt.cpu():
        tp = mt.Predictor(tsym, {k: mt.nd.array(v) for k, v in
                                 params.items()}, {}, shapes, ctx=mt.cpu())
    got = tp.forward(data=x).get_output(0)
    assert got.shape == (BATCH, 240, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=DET_ATOL)
    kept = got[..., 0] >= 0
    assert 0 < kept.sum() < kept.size
