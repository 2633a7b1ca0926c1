"""The training loop of ``examples/train_imagenet.py`` in the PyTorch port
against the JAX package: the learning-rate schedulers, SGD with momentum,
``wd`` and a scheduler, and ``Module.fit`` over an ``ImageRecordIter``
with ``do_checkpoint``.

Tolerances: the schedulers run the same float operations, so their rates
are equal.  An SGD update is a few f32 operations per element in both
packages, in the same order but through other libraries: 1e-6 relative
over six updates.  The fit runs a small MLP on the same record batches
and initial parameters; its products sum in other orders (XLA against
torch), and the differences grow through six momentum steps (7e-7 at
most here), so the final parameters are held to 1e-5 relative.  The
checkpoints each package writes load in the other bit for bit.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

SCHEDULERS = {
    "factor": lambda m: m.lr_scheduler.FactorScheduler(
        step=5, factor=0.5, stop_factor_lr=1e-3),
    "multi-factor": lambda m: m.lr_scheduler.MultiFactorScheduler(
        step=[3, 10, 20], factor=0.3),
    "poly": lambda m: m.lr_scheduler.PolyScheduler(
        max_update=40, base_lr=0.1, pwr=2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_rates_equal_the_reference(name):
    ref, port = SCHEDULERS[name](mj), SCHEDULERS[name](mt)
    ref.base_lr = port.base_lr = 0.1
    want = [ref(n) for n in range(1, 51)]
    got = [port(n) for n in range(1, 51)]
    assert got == want
    assert len(set(got)) > 2


def test_scheduler_raises_as_the_reference():
    for bad in (dict(step=[3, 3]), dict(step=[0]),
                dict(step=[2], factor=1.5)):
        with pytest.raises(ValueError):
            mj.lr_scheduler.MultiFactorScheduler(**bad)
        with pytest.raises(ValueError):
            mt.lr_scheduler.MultiFactorScheduler(**bad)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduled_sgd_tracks_the_reference(name):
    """Six updates of two weights through each package's Updater (SGD,
    momentum 0.9, wd 1e-4, rescale_grad, the scheduler): the scheduled
    rate at every update, and the weights within 1e-6 relative."""
    rng = np.random.default_rng(4)
    w0 = [rng.standard_normal((5, 7)).astype(np.float32) for _ in range(2)]
    grads = [[rng.standard_normal((5, 7)).astype(np.float32)
              for _ in range(2)] for _ in range(6)]
    runs = {}
    for pkg, kw in ((mj, {}), (mt, {"ctx": mt.cpu()})):
        opt = pkg.optimizer.SGD(
            learning_rate=0.2, momentum=0.9, wd=1e-4, rescale_grad=0.5,
            lr_scheduler=SCHEDULERS[name](pkg),
            param_idx2name={0: "a_weight", 1: "b_weight"})
        upd = pkg.optimizer.get_updater(opt)
        ws = [pkg.nd.array(w, **kw) for w in w0]
        lrs = []
        for step in grads:
            for i, g in enumerate(step):
                upd(i, pkg.nd.array(g, **kw), ws[i])
            lrs.append(opt._get_lr(0))
        runs[pkg.__name__] = (lrs, [w.asnumpy() for w in ws])
    (lr_ref, w_ref), (lr_port, w_port) = runs["mxnet_tpu"], \
        runs["mxnet_tpu_torch"]
    assert lr_port == lr_ref
    for a, b in zip(w_port, w_ref):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= 1e-6, err


def test_sgd_rate_follows_the_scheduler_from_begin_num_update():
    sched = mt.lr_scheduler.MultiFactorScheduler(step=[2], factor=0.1)
    opt = mt.optimizer.SGD(learning_rate=0.05, lr_scheduler=sched,
                           begin_num_update=1)
    upd = mt.optimizer.get_updater(opt)
    w = mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu())
    g = mt.nd.array(np.ones(3, np.float32), ctx=mt.cpu())
    lrs = []
    for _ in range(3):
        upd(0, g, w)
        lrs.append((opt.num_update, opt._get_lr(0)))
    assert lrs == [(2, 0.05), (3, 0.05 * 0.1), (4, 0.05 * 0.1)]


def _mlp(sym):
    """tests/test_image.py's _mlp_symbol, built by either package."""
    data = sym.Variable("data")
    h = sym.FullyConnected(sym.Flatten(data), num_hidden=32)
    h = sym.Activation(h, act_type="relu")
    net = sym.FullyConnected(h, num_hidden=4)
    return sym.SoftmaxOutput(net, name="softmax")


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Each package's Module.fit over an ImageRecordIter (JPEG records
    at 40x40, random 32x32 crops and mirrors, mean/std, shuffled; batch
    16, 2 epochs of 3 batches) from the same initial parameters, SGD with
    momentum, wd and a MultiFactorScheduler, and do_checkpoint."""
    root = tmp_path_factory.mktemp("fit")
    rec = str(root / "train.rec")
    w = mj.recordio.MXIndexedRecordIO(str(root / "train.idx"), rec, "w")
    rng = np.random.default_rng(0)
    for i in range(48):
        img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
        img[:, :, i % 3] //= 4          # a learnable colour cue
        w.write_idx(i, mj.recordio.pack_img(
            mj.recordio.IRHeader(0, float(i % 4), i, 0), img, quality=95))
    w.close()
    with mj.base.NameManager(), mt.base.NameManager():
        jsym, tsym = _mlp(mj.sym), _mlp(mt.sym)
    from test_image import _mlp_symbol
    with mj.base.NameManager():
        assert jsym.tojson() == _mlp_symbol().tojson() == tsym.tojson()
    arg_shapes, _, _ = tsym.infer_shape(data=(16, 3, 32, 32))
    prng = np.random.default_rng(1)
    init = {n: (prng.standard_normal(s) * 0.05).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    out = {}
    for pkg, sym, ctx in ((mj, jsym, mj.cpu()), (mt, tsym, mt.cpu())):
        it = pkg.io.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, 32, 32), batch_size=16,
            shuffle=True, rand_crop=True, rand_mirror=True, seed=3,
            mean_r=123.68, mean_g=116.779, mean_b=103.939,
            std_r=58.393, std_g=57.12, std_b=57.375, preprocess_threads=2)
        prefix = str(root / pkg.__name__)
        mod = pkg.mod.Module(sym, context=ctx)
        lrs = []
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={
                    "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
                    "lr_scheduler": pkg.lr_scheduler.MultiFactorScheduler(
                        step=[2, 4], factor=0.5)},
                arg_params={n: pkg.nd.array(v, ctx=ctx)
                            for n, v in init.items()},
                batch_end_callback=lambda p, m=mod: lrs.append(
                    m._optimizer._get_lr(0)),
                epoch_end_callback=pkg.callback.do_checkpoint(prefix))
        it.close()
        args, aux = mod.get_params()
        out[pkg.__name__] = dict(
            prefix=prefix, lrs=lrs, init=init,
            args={k: v.asnumpy() for k, v in args.items()})
    return out


def test_fit_over_record_iter_ends_at_the_reference_parameters(fitted):
    ref, port = fitted["mxnet_tpu"], fitted["mxnet_tpu_torch"]
    assert port["lrs"] == ref["lrs"] == [0.05, 0.05, 0.025, 0.025,
                                         0.0125, 0.0125]
    assert sorted(port["args"]) == sorted(ref["args"])
    for name, want in ref["args"].items():
        got = port["args"][name]
        assert not np.array_equal(want, port["init"][name])
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("epoch", [1, 2])
def test_each_package_loads_the_others_checkpoints(fitted, epoch):
    ref, port = fitted["mxnet_tpu"], fitted["mxnet_tpu_torch"]
    for prefix in (ref["prefix"], port["prefix"]):
        _, ja, jx = mj.model.load_checkpoint(prefix, epoch)
        tsym, ta, tx = mt.model.load_checkpoint(prefix, epoch)
        assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
        for k in ja:
            np.testing.assert_array_equal(ta[k].asnumpy(), ja[k].asnumpy())
        assert tsym.tojson() == mj.sym.load(
            "%s-symbol.json" % prefix).tojson()
    if epoch == 2:
        # the last checkpoint holds the parameters the fit ended with
        _, last, _ = mt.model.load_checkpoint(port["prefix"], 2)
        for k, v in port["args"].items():
            np.testing.assert_array_equal(last[k].asnumpy(), v)
