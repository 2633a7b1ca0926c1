"""Gluon in the PyTorch port against the JAX package's Gluon.

Parameters and ParameterDicts (sharing, deferred initialization,
grad_req, constants, files); every loss but CTC (values and gradients);
the Trainer (two SGD steps with momentum and weight decay, its states
saved and loaded); the utils; the DataLoader.  The layers of ``gluon.nn``
are in test_torch_gluon_layers.py, _norm.py, _conv.py and _pool.py.  The
same seeded numpy weights and inputs go into both packages, on the CPU.
Tolerance: 1e-5 relative and 1e-6 absolute in float32 (sums in another
order).  Within the port, hybridized blocks (``CachedOp``) are held
against imperative ones bit for bit, and a SymbolBlock over a small
ResNet symbol against the Executor.
"""
import os

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
        shape = p.shape
        if name.endswith(("running_var", "gamma")):
            out[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            out[name] = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return out


def _set_all(pkg, params, values):
    for name, p in params.items():
        p.set_data(pkg.nd.array(values[name], ctx=_ctx(pkg)))


# -- Parameter and ParameterDict -------------------------------------------

def test_parameter_basics():
    p = mt.gluon.Parameter("weight", shape=(3, 4))
    p.initialize(init="ones", ctx=mt.cpu())
    assert p.data().shape == (3, 4) and p.grad().shape == (3, 4)
    assert p.list_ctx() == [mt.cpu()]
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((3, 4)))
    p.set_data(np.full((3, 4), 2.0, np.float32))
    leaf = p.data()._data
    assert leaf.requires_grad and p.data()._data is leaf
    p.grad_req = "null"
    with pytest.raises(RuntimeError):
        p.grad()
    q = mt.gluon.Parameter("w", shape=(0, 4), allow_deferred_init=True)
    q.initialize(ctx=mt.cpu())
    with pytest.raises(mt.gluon.DeferredInitializationError):
        q.data()
    c = mt.gluon.Constant("c", np.arange(3, dtype=np.float32))
    c.initialize(ctx=mt.cpu())
    np.testing.assert_array_equal(c.data().asnumpy(), np.arange(3))
    assert c.grad_req == "null"


def test_parameterdict_sharing_merge_and_files(tmp_path):
    for pkg in (mj, mt):
        d = pkg.gluon.ParameterDict("net_")
        a = d.get("w", shape=(0, 3))
        assert d.get("w", shape=(2, 0)) is a and a.shape == (2, 3)
        shared = pkg.gluon.ParameterDict("net_", shared=d)
        assert shared.get("w") is a
    # files cross the packages both ways
    rng = np.random.default_rng(1)
    vals = {"w": rng.standard_normal((2, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    for src, dst in ((mt, mj), (mj, mt)):
        ds = src.gluon.ParameterDict("p_")
        for k, v in vals.items():
            ds.get(k, shape=v.shape).initialize(ctx=_ctx(src))
            ds["p_" + k].set_data(src.nd.array(v, ctx=_ctx(src)))
        f = str(tmp_path / ("from_%s.params" % src.__name__))
        ds.save(f, strip_prefix="p_")
        dd = dst.gluon.ParameterDict("q_")
        for k, v in vals.items():
            dd.get(k, shape=v.shape)
        dd.load(f, ctx=_ctx(dst), restore_prefix="q_")
        for k, v in vals.items():
            np.testing.assert_array_equal(dd["q_" + k].data().asnumpy(), v)


def test_block_sharing_deferred_init_and_grad_req():
    with mt.cpu():
        a = mt.gluon.nn.Dense(4, prefix="a_")
        b = mt.gluon.nn.Dense(4, prefix="b_", params=a.collect_params())
        a.initialize()
        x = mt.nd.ones((2, 3))
        assert a.weight.shape == (4, 0)
        np.testing.assert_array_equal(a(x).asnumpy(), b(x).asnumpy())
        assert a.weight.shape == (4, 3) and b.weight is a.weight
        a.weight.grad_req = "add"
        for _ in range(2):
            with mt.autograd.record():
                y = a(x).sum()
            y.backward()
        g2 = a.weight.grad().asnumpy()
        a.weight.zero_grad()
        with mt.autograd.record():
            y = a(x).sum()
        y.backward()
        np.testing.assert_allclose(g2, 2 * a.weight.grad().asnumpy())


# -- losses ------------------------------------------------------------------

LOSSES = {
    "L2Loss": (lambda g: g.loss.L2Loss(), "dense"),
    "L1Loss": (lambda g: g.loss.L1Loss(), "dense"),
    "SigmoidBCELoss": (lambda g: g.loss.SigmoidBCELoss(), "binary"),
    "SigmoidBCELoss from_sigmoid": (lambda g: g.loss.SigmoidBCELoss(
        from_sigmoid=True), "binary_prob"),
    "SoftmaxCrossEntropyLoss": (lambda g: g.loss.SoftmaxCrossEntropyLoss(),
                                "sparse"),
    "SoftmaxCELoss dense": (lambda g: g.loss.SoftmaxCELoss(
        sparse_label=False), "dist"),
    "KLDivLoss": (lambda g: g.loss.KLDivLoss(from_logits=False), "dist"),
    "HuberLoss": (lambda g: g.loss.HuberLoss(rho=0.5), "dense"),
    "HingeLoss": (lambda g: g.loss.HingeLoss(), "signed"),
    "SquaredHingeLoss": (lambda g: g.loss.SquaredHingeLoss(margin=2),
                         "signed"),
    "LogisticLoss": (lambda g: g.loss.LogisticLoss(), "signed"),
    "LogisticLoss binary": (lambda g: g.loss.LogisticLoss(
        label_format="binary"), "binary"),
    "L2Loss weighted": (lambda g: g.loss.L2Loss(weight=3.0), "weighted"),
}


def _loss_inputs(kind, rng):
    pred = rng.standard_normal((4, 5)).astype(np.float32)
    if kind in ("dense", "weighted"):
        label = rng.standard_normal((4, 5)).astype(np.float32)
    elif kind == "binary":
        label = rng.integers(0, 2, (4, 5)).astype(np.float32)
    elif kind == "binary_prob":
        pred = rng.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
        label = rng.integers(0, 2, (4, 5)).astype(np.float32)
    elif kind == "sparse":
        label = rng.integers(0, 5, (4,)).astype(np.float32)
    elif kind == "dist":
        label = rng.dirichlet(np.ones(5), 4).astype(np.float32)
    else:
        label = rng.choice([-1.0, 1.0], (4, 5)).astype(np.float32)
    extra = [rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)] \
        if kind == "weighted" else []
    return pred, label, extra


def _loss_run(pkg, name, hybrid):
    build, kind = LOSSES[name]
    pred, label, extra = _loss_inputs(kind, np.random.default_rng(
        sum(map(ord, name))))
    loss = build(pkg.gluon)
    if hybrid:
        loss.hybridize()
    p = pkg.nd.array(pred, ctx=_ctx(pkg))
    p.attach_grad()
    with pkg.autograd.record():
        val = loss(p, pkg.nd.array(label, ctx=_ctx(pkg)),
                   *[pkg.nd.array(e, ctx=_ctx(pkg)) for e in extra])
    val.backward()
    return val.asnumpy(), p.grad.asnumpy()


_JAX_LOSS_RUNS = {}


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("hybrid", [False, True])
def test_loss_against_jax(name, hybrid):
    """The port's loss, imperative or hybridized, against the JAX
    package's hybridized one: the value and the prediction's gradient."""
    if name not in _JAX_LOSS_RUNS:
        _JAX_LOSS_RUNS[name] = _loss_run(mj, name, True)
    ref = _JAX_LOSS_RUNS[name]
    got = _loss_run(mt, name, hybrid)
    _close(got[0], ref[0])
    _close(got[1], ref[1])


def test_triplet_and_ctc_losses():
    rng = np.random.default_rng(3)
    a, pos, neg = (rng.standard_normal((4, 6)).astype(np.float32)
                   for _ in range(3))
    vals = [pkg.gluon.loss.TripletLoss(margin=0.5)(
        *[pkg.nd.array(v, ctx=_ctx(pkg)) for v in (a, pos, neg)])
        for pkg in (mj, mt)]
    _close(vals[1], vals[0])
    with pytest.raises(mt.MXNetError, match="ctc_loss"):
        mt.gluon.loss.CTCLoss()


# -- CachedOp: hybridized against imperative, bit for bit --------------------

class _Net(mt.gluon.HybridBlock):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.conv = mt.gluon.nn.Conv2D(6, 3, padding=1, use_bias=False)
            self.bn = mt.gluon.nn.BatchNorm()
            self.fc = mt.gluon.nn.Dense(4)

    def hybrid_forward(self, F, x):
        y = F.relu(self.bn(self.conv(x)))
        return self.fc(y + F.mean(y, axis=1, keepdims=True))


def _net_step(net, x, ctx):
    xs = mt.nd.array(x, ctx=ctx)
    with mt.autograd.record():
        out = net(xs)
        loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
            out, mt.nd.array(np.arange(x.shape[0]) % 4, ctx=ctx))
    loss.backward()
    return (out.asnumpy(),
            {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"},
            {k: p.data().asnumpy() for k, p in net.collect_params().items()})


def test_cached_op_bit_equal_to_imperative():
    """The same net run imperatively and hybridized from the same weights:
    outputs, every gradient and BatchNorm's moving statistics equal bit
    for bit, the statistics written into the same arrays; the CachedOp
    counts one signature per (shape, training) met."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2, 5, 5)).astype(np.float32)
    nets = []
    for hybrid in (False, True):
        net = _Net(prefix="n_")
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        with mt.autograd.pause():
            net(mt.nd.array(x, ctx=mt.cpu()))
        if hybrid:
            net.hybridize()
        nets.append(net)
    values = _seeded_values(nets[0].collect_params(), rng)
    for net in nets:
        _set_all(mt, net.collect_params(), values)
    bn_arrays = [net.bn.running_mean.data() for net in nets]
    ref = [_net_step(nets[0], x, mt.cpu()) for _ in range(2)]
    got = [_net_step(nets[1], x, mt.cpu()) for _ in range(2)]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g[0], r[0])
        for k in r[1]:
            np.testing.assert_array_equal(g[1][k], r[1][k])
        for k in r[2]:
            np.testing.assert_array_equal(g[2][k], r[2][k])
    for net, arr in zip(nets, bn_arrays):
        assert net.bn.running_mean.data() is arr
        assert not np.array_equal(arr.asnumpy(),
                                  values["n_batchnorm0_running_mean"])
    op = nets[1]._cached_op
    assert op.trace_count == 1                  # training, one shape
    with mt.cpu():
        nets[1](mt.nd.array(x))                 # predict mode
        nets[1](mt.nd.array(x[:2]))             # another shape
    assert op.trace_count == 3


def test_aux_update_in_place_imperative_and_cached():
    """BatchNorm's moving statistics are written into the caller's array
    in place, both through ``nd.BatchNorm`` and through a CachedOp, with
    the same values."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 3, 2, 2)).astype(np.float32)
    with mt.cpu():
        sym = mt.sym.BatchNorm(mt.sym.var("data"), name="bn")
        op = mt.CachedOp(sym)
        got = []
        for cached in (False, True):
            ins = {n: mt.nd.array(rng.uniform(0.5, 1.5, (3,)).astype(
                np.float32)) for n in ("bn_gamma", "bn_beta",
                                       "bn_moving_mean", "bn_moving_var")}
            rng = np.random.default_rng(5)
            rng.standard_normal((4, 3, 2, 2))
            mean, var = ins["bn_moving_mean"], ins["bn_moving_var"]
            tensors = (mean._data, var._data)
            with mt.autograd.record():
                if cached:
                    op(*[mt.nd.array(x) if n == "data" else ins[n]
                         for n in op.input_names])
                else:
                    mt.nd.BatchNorm(mt.nd.array(x), ins["bn_gamma"],
                                    ins["bn_beta"], mean, var)
            assert (mean._data, var._data) == tensors
            got.append((mean.asnumpy(), var.asnumpy()))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_symbol_block_against_executor():
    """A SymbolBlock over a small plain-unit ResNet symbol (NHWC) gives the
    Executor's outputs and gradients bit for bit, predict and training."""
    sym = mt.models.resnet._resnet([1, 1], 2, [8, 16, 32], 10, (3, 16, 16),
                                   True, layout="NHWC", unit_impl="plain")
    shapes = {"data": (2, 16, 16, 3), "softmax_label": (2,)}
    args, aux = mt.convert.random_params(sym, {"data": shapes["data"]},
                                         seed=6)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shapes["data"]).astype(np.float32)
    y = np.array([3, 7], np.float32)
    with mt.cpu():
        blk = mt.gluon.SymbolBlock(sym, [mt.sym.var("data"),
                                         mt.sym.var("softmax_label")])
        params = blk.collect_params()
        assert sorted(params.keys()) == sorted(list(args) + list(aux))
        for k, p in params.items():
            p._load_init(mt.nd.array({**args, **aux}[k]), mt.cpu())
        assert all(params[k].grad_req == "null" for k in aux)
        ex = sym.bind(mt.cpu(), {**{k: mt.nd.array(v) for k, v in
                                    args.items()},
                                 "data": mt.nd.array(x),
                                 "softmax_label": mt.nd.array(y)},
                      aux_states={k: mt.nd.array(v) for k, v in aux.items()})
        pred = blk(mt.nd.array(x), mt.nd.array(y))
        np.testing.assert_array_equal(pred.asnumpy(),
                                      ex.forward()[0].asnumpy())
        with mt.autograd.record():
            out = blk(mt.nd.array(x), mt.nd.array(y))
        out.backward()
        ex_out = ex.forward(is_train=True)[0]
        ex.backward()
        np.testing.assert_array_equal(out.asnumpy(), ex_out.asnumpy())
        for k in args:
            np.testing.assert_array_equal(params[k].grad().asnumpy(),
                                          ex.grad_dict[k].asnumpy())
        for k in aux:
            np.testing.assert_array_equal(params[k].data().asnumpy(),
                                          ex.aux_dict[k].asnumpy())


# -- Trainer -----------------------------------------------------------------

def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(8, activation="relu"),
                pkg.gluon.nn.Dense(3))
    return net


def _train(pkg, net, trainer, x, y, steps):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x, ctx=_ctx(pkg))),
                           pkg.nd.array(y, ctx=_ctx(pkg)))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.asnumpy())
    return losses


def test_trainer_against_jax_and_states(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    y = rng.integers(0, 3, 6).astype(np.float32)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    runs = {}
    for pkg in (mt, mj):
        net = _mlp(pkg)
        net.initialize(ctx=_ctx(pkg))
        with pkg.autograd.pause():
            net(pkg.nd.array(x, ctx=_ctx(pkg)))
        if pkg is mt:
            values = _seeded_values(net.collect_params(), rng)
        _set_all(pkg, net.collect_params(), values)
        net.collect_params()["m_dense1_bias"].lr_mult = 0.5
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
        losses = _train(pkg, net, trainer, x, y, 2)
        runs[pkg] = (losses, {k: p.data().asnumpy() for k, p in
                              net.collect_params().items()}, net, trainer)
    for a, b in zip(runs[mt][0], runs[mj][0]):
        _close(a, b)
    for k, v in runs[mj][1].items():
        _close(runs[mt][1][k], v)
    # states: a third step from saved states equals the uninterrupted one
    net, trainer = runs[mt][2], runs[mt][3]
    f = str(tmp_path / "trainer.states")
    trainer.save_states(f)
    snapshot = {k: p.data().asnumpy() for k, p in
                net.collect_params().items()}
    _train(mt, net, trainer, x, y, 1)
    want = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    _set_all(mt, net.collect_params(), snapshot)
    fresh = mt.gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    fresh.load_states(f)
    _train(mt, net, fresh, x, y, 1)
    for k, v in want.items():
        np.testing.assert_array_equal(net.collect_params()[k].data()
                                      .asnumpy(), v)


def test_trainer_dist_store_raises():
    with mt.cpu():
        net = mt.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore="dist_sync")
        with mt.autograd.record():
            y = net(mt.nd.ones((1, 3))).sum()
        y.backward()
        with pytest.raises(mt.MXNetError):
            tr.step(1)


def test_utils_against_jax():
    rng = np.random.default_rng(8)
    a = rng.standard_normal((6, 4)).astype(np.float32)
    for pkg in (mj, mt):
        parts = pkg.gluon.utils.split_data(pkg.nd.array(a, ctx=_ctx(pkg)),
                                           3, batch_axis=1, even_split=False)
        assert [p.shape for p in parts] == [(6, 1), (6, 1), (6, 2)]
    arrs = {pkg: [pkg.nd.array(a, ctx=_ctx(pkg)),
                  pkg.nd.array(a[:2] * 3, ctx=_ctx(pkg))] for pkg in (mj, mt)}
    norms = [pkg.gluon.utils.clip_global_norm(arrs[pkg], 1.0)
             for pkg in (mj, mt)]
    assert norms[1] == pytest.approx(norms[0], rel=1e-6)
    for ours, ref in zip(arrs[mt], arrs[mj]):
        _close(ours, ref)
    loaded = mt.gluon.utils.split_and_load(a, [mt.cpu()])
    np.testing.assert_array_equal(loaded[0].asnumpy(), a)
    with pytest.raises(RuntimeError):
        mt.gluon.utils.download("http://example.invalid/none.params",
                                path=os.devnull + ".missing")


# -- data ---------------------------------------------------------------------

def test_dataloader_against_jax(tmp_path):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    for last in ("keep", "discard", "rollover"):
        got = {}
        for pkg in (mj, mt):
            ds = pkg.gluon.data.ArrayDataset(x, y)
            with pkg.cpu():
                dl = pkg.gluon.data.DataLoader(ds, batch_size=4,
                                               last_batch=last)
                got[pkg] = (len(dl), [(b[0].asnumpy(), b[1].asnumpy())
                                      for b in dl])
        assert got[mt][0] == got[mj][0]
        assert len(got[mt][1]) == len(got[mj][1])
        for (a0, a1), (b0, b1) in zip(got[mt][1], got[mj][1]):
            np.testing.assert_array_equal(a0, b0)
            np.testing.assert_array_equal(a1, b1)
    ds = mt.gluon.data.ArrayDataset(x, y).transform_first(lambda v: v * 2)
    with mt.cpu():
        serial = [b[0].asnumpy() for b in mt.gluon.data.DataLoader(
            ds, batch_size=3)]
        threaded = [b[0].asnumpy() for b in mt.gluon.data.DataLoader(
            ds, batch_size=3, num_workers=2)]
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a, b)
    np.random.seed(0)
    order = list(mt.gluon.data.RandomSampler(10))
    assert sorted(order) == list(range(10))
    # records the port wrote, read by both packages' RecordFileDataset
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = mt.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i), i, 0), bytes([i]) * (i + 1)))
    w.close()
    for pkg in (mt, mj):
        ds = pkg.gluon.data.RecordFileDataset(rec)
        assert len(ds) == 5
        header, payload = pkg.recordio.unpack(ds[3])
        assert header.label == 3.0 and payload == bytes([3]) * 4


def test_gluon_entry_points_want_a_card_unless_given_cpu(monkeypatch):
    """Initialization without a context lands on the card, and raises
    without one; ``ctx=cpu()`` or a ``with mt.cpu():`` scope runs on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = mt.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        net.initialize()
    with pytest.raises(mt.MXNetError, match="ctx=cpu"):
        mt.gluon.Parameter("w", shape=(2,)).initialize()
    net.initialize(ctx=mt.cpu())
    assert net.weight.list_ctx() == [mt.cpu()]
    with mt.cpu():
        other = mt.gluon.nn.Dense(2, in_units=3)
        other.initialize()
        assert other(mt.nd.ones((1, 3))).context == mt.cpu()
