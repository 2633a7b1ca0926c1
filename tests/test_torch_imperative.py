"""The imperative frontend of the PyTorch port (``mt.nd.<op>``,
``mt.autograd``, ``with ctx:``) against the JAX package's.

The same seeded numpy inputs go through ``mxnet_tpu.nd`` /
``mxnet_tpu.autograd`` (the JAX package on the CPU, its Pallas kernels in
interpret mode) and through ``mxnet_tpu_torch.nd`` / ``autograd`` under
``with mt.cpu():``, where the kernel wrappers take their plain versions.
Tolerance: 2e-5 in float32 for ops that sum products (the rounding of sums
taken in another order), exact equality for elementwise arithmetic; the
fused unit's gradients at the atol rule of tests/test_fused_unit.py.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

# Small CPU cases: one torch thread runs them faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

TOL = 2e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(a):
    """The same numpy array as a JAX-package and a port NDArray."""
    return mj.nd.array(a), mt.nd.array(a, ctx=mt.cpu())


def _close(ours, ref, tol=TOL):
    ours = ours.asnumpy() if hasattr(ours, "asnumpy") else np.asarray(ours)
    ref = ref.asnumpy() if hasattr(ref, "asnumpy") else np.asarray(ref)
    assert ours.shape == ref.shape
    if tol:
        np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(ours, ref)


def _unit_params(rng, c):
    """The fused unit's nine parameters and six moving statistics."""
    cq = c // 4
    mk = lambda *s: _rand(rng, *s, scale=0.1)  # noqa: E731
    vec = lambda n, lo=0.5, hi=1.5: rng.uniform(lo, hi, n).astype(  # noqa
        np.float32)
    return [vec(c), mk(c), mk(cq, 1, 1, c), vec(cq), mk(cq), mk(cq, 3, 3, cq),
            vec(cq), mk(cq), mk(c, 1, 1, cq), mk(c), vec(c), mk(cq),
            vec(cq, 0.2, 3.0), mk(cq), vec(cq, 0.1, 2.0)]


OP_CASES = {
    "FullyConnected": lambda rng: (
        [_rand(rng, 4, 6), _rand(rng, 5, 6), _rand(rng, 5)],
        dict(num_hidden=5), TOL),
    "Convolution": lambda rng: (
        [_rand(rng, 2, 7, 7, 8), _rand(rng, 6, 3, 3, 8, scale=0.2)],
        dict(kernel=(3, 3), pad=(1, 1), num_filter=6, no_bias=True,
             layout="NHWC"), TOL),
    "Activation": lambda rng: (
        [_rand(rng, 3, 5)], dict(act_type="relu"), 0),
    "softmax": lambda rng: (
        [_rand(rng, 3, 7)], dict(axis=1), TOL),
    "_contrib_FusedBottleneckUnit": lambda rng: (
        [_rand(rng, 2, 8, 8, 32)] + _unit_params(rng, 32),
        dict(num_filter=32, layout="NHWC"), TOL),
}


@pytest.mark.parametrize("op", sorted(OP_CASES))
def test_nd_op_matches_jax(op):
    """``mt.nd.<op>`` against ``mx.nd.<op>``, eval mode, array inputs by
    position and params by keyword."""
    rng = np.random.default_rng(len(op))
    inputs, attrs, tol = OP_CASES[op](rng)
    pairs = [_pair(a) for a in inputs]
    ref = getattr(mj.nd, op)(*[j for j, _ in pairs], **attrs)
    ours = getattr(mt.nd, op)(*[t for _, t in pairs], **attrs)
    assert isinstance(ours, mt.nd.NDArray)
    assert ours.context == mt.cpu()
    _close(ours, ref, tol)


def test_nd_keyword_inputs_and_out():
    """Inputs by name, ``out=`` writing in place, and an op without array
    inputs on the context it is given."""
    rng = np.random.default_rng(1)
    x, w, b = _rand(rng, 3, 4), _rand(rng, 2, 4), _rand(rng, 2)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x), _pair(w), _pair(b)
    ref = mj.nd.FullyConnected(data=jx, weight=jw, bias=jb, num_hidden=2)
    ours = mt.nd.FullyConnected(data=tx, weight=tw, bias=tb, num_hidden=2)
    _close(ours, ref)
    dst = mt.nd.zeros((3, 2), ctx=mt.cpu())
    buf = dst._data
    got = mt.nd.FullyConnected(tx, tw, tb, num_hidden=2, out=dst)
    assert got is dst and dst._data is buf      # written in place
    _close(dst, ref)
    r = mt.nd._arange(start=0, stop=5, ctx=mt.cpu())
    np.testing.assert_array_equal(r.asnumpy(), np.arange(5))


ARITH = [
    ("add", lambda a, b: a + b), ("sub", lambda a, b: a - b),
    ("mul", lambda a, b: a * b), ("div", lambda a, b: a / b),
    ("add_scalar", lambda a, b: a + 2.5),
    ("radd_scalar", lambda a, b: 2.5 + a),
    ("sub_scalar", lambda a, b: a - 1.5),
    ("rsub_scalar", lambda a, b: 1.5 - a),
    ("mul_scalar", lambda a, b: a * 3.0),
    ("rmul_scalar", lambda a, b: 3.0 * a),
    ("div_scalar", lambda a, b: a / 4.0),
    ("rdiv_scalar", lambda a, b: 4.0 / b),
    ("neg", lambda a, b: -a),
]


@pytest.mark.parametrize("name,fn", ARITH, ids=[a[0] for a in ARITH])
def test_nd_arithmetic_matches_jax(name, fn):
    rng = np.random.default_rng(7)
    a = _rand(rng, 3, 4)
    b = rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _close(fn(ta, tb), fn(ja, jb), 0)


def _mlp_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return dict(x=_rand(rng, 6, 5), w1=_rand(rng, 8, 5, scale=0.5),
                b1=_rand(rng, 8, scale=0.1), w2=_rand(rng, 3, 8, scale=0.5),
                b2=_rand(rng, 3, scale=0.1), hg=_rand(rng, 6, 3))


def _mlp(pkg, v):
    h = pkg.nd.Activation(pkg.nd.FullyConnected(v["x"], v["w1"], v["b1"],
                                                num_hidden=8),
                          act_type="relu")
    y = pkg.nd.FullyConnected(h, v["w2"], v["b2"], num_hidden=3)
    return pkg.nd.softmax(y * 0.5 - 1.0, axis=1) / 2.0


def _mlp_grads(pkg, inputs, ctx_args, use_grad=False):
    v = {k: pkg.nd.array(a, **ctx_args) for k, a in inputs.items()}
    names = ["w1", "b1", "w2", "b2", "x"]
    for n in names:
        v[n].attach_grad()
    with pkg.autograd.record():
        out = _mlp(pkg, v)
    if use_grad:
        return [g.asnumpy() for g in pkg.autograd.grad(
            out, [v[n] for n in names], head_grads=v["hg"])]
    out.backward(v["hg"])
    return [v[n].grad.asnumpy() for n in names]


@pytest.mark.parametrize("use_grad", [False, True],
                         ids=["backward", "grad"])
def test_autograd_mlp_matches_jax(use_grad):
    """A small MLP under ``record()``: ``backward`` into attached buffers,
    and ``autograd.grad``, against the JAX package's tape."""
    inputs = _mlp_inputs()
    ref = _mlp_grads(mj, inputs, {}, use_grad)
    ours = _mlp_grads(mt, inputs, {"ctx": mt.cpu()}, use_grad)
    for o, r in zip(ours, ref):
        _close(o, r)


def test_autograd_grad_req_write_add_null():
    """write overwrites, add accumulates over two backwards, null gets no
    gradient, as in the reference."""
    rng = np.random.default_rng(11)
    a, b = _rand(rng, 3, 3), _rand(rng, 3, 3)
    results = {}
    for pkg, kw in ((mj, {}), (mt, {"ctx": mt.cpu()})):
        xs = {req: pkg.nd.array(a, **kw) for req in ("write", "add", "null")}
        for req, x in xs.items():
            x.attach_grad(grad_req=req)
        for _ in range(2):
            with pkg.autograd.record():
                ys = [x * pkg.nd.array(b, **kw) + x * x for x in xs.values()]
            pkg.autograd.backward(ys)
        results[pkg] = {req: None if x.grad is None else x.grad.asnumpy()
                        for req, x in xs.items()}
    want = b + 2 * a
    for pkg in (mj, mt):
        np.testing.assert_allclose(results[pkg]["write"], want, rtol=1e-6)
        np.testing.assert_allclose(results[pkg]["add"], 2 * want, rtol=1e-6)
    assert results[mt]["null"] is None
    _close(results[mt]["write"], results[mj]["write"], 0)


def test_autograd_backward_releases_the_recording():
    with mt.cpu():
        x = mt.nd.array(np.ones((2, 2), np.float32))
        x.attach_grad()
        with mt.autograd.record():
            y = x * 3.0
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), 3.0)
        with pytest.raises(mt.MXNetError, match="no recorded computation"):
            y.backward()
        z = x * 2.0                     # not recorded
        with pytest.raises(mt.MXNetError, match="no recorded computation"):
            z.backward()


@pytest.mark.parametrize("mode", ["train_mode", "predict_mode"])
def test_batchnorm_train_and_predict_mode_match_jax(mode):
    """BatchNorm under record() in train_mode (batch statistics, moving
    averages updated once) and in predict_mode (moving statistics), with
    the gradient of its data, against the JAX package."""
    rng = np.random.default_rng(13)
    ins = [_rand(rng, 6, 4), rng.uniform(0.5, 1.5, 4).astype(np.float32),
           _rand(rng, 4, scale=0.1), _rand(rng, 4, scale=0.1),
           rng.uniform(0.5, 1.5, 4).astype(np.float32)]
    hg = _rand(rng, 6, 4)
    got = {}
    for pkg, kw in ((mj, {}), (mt, {"ctx": mt.cpu()})):
        arrs = [pkg.nd.array(a, **kw) for a in ins]
        arrs[0].attach_grad()
        with pkg.autograd.record(), getattr(pkg.autograd, mode)():
            assert pkg.autograd.is_training() == (mode == "train_mode")
            y = pkg.nd.BatchNorm(*arrs, fix_gamma=False, momentum=0.9)
        y.backward(pkg.nd.array(hg, **kw))
        got[pkg] = [y.asnumpy(), arrs[0].grad.asnumpy(), arrs[3].asnumpy(),
                    arrs[4].asnumpy()]
    for o, r in zip(got[mt], got[mj]):
        _close(o, r)
    moved = not np.allclose(got[mt][2], ins[3])
    assert moved == (mode == "train_mode")


def _unit_grads(pkg, ins, kw, attrs, hg):
    arrs = [pkg.nd.array(a, **kw) for a in ins]
    for a in arrs[:10]:
        a.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd._contrib_FusedBottleneckUnit(*arrs, **attrs)
    out.backward(pkg.nd.array(hg, **kw))
    return ([out.asnumpy()] + [a.grad.asnumpy() for a in arrs[:10]]
            + [a.asnumpy() for a in arrs[10:]])


@pytest.mark.parametrize("c3", ["2d", "4d"])
def test_autograd_fused_unit_matches_jax(monkeypatch, c3):
    """The fused unit under record() in training mode, 2d (K3/K6) and 4d
    (K4/K7, plain versions here): output, ten gradients and the six moving
    statistics updated in place, against the JAX package's autograd."""
    monkeypatch.setenv("MXNET_FUSED_UNIT_C3", c3)
    rng = np.random.default_rng(17)
    n, h, w, c = 2, 8, 8, 32
    ins = [_rand(rng, n, h, w, c)] + _unit_params(rng, c)
    hg = _rand(rng, n, h, w, c)
    attrs = dict(num_filter=c, layout="NHWC")
    ref = _unit_grads(mj, ins, {}, attrs, hg)
    ours = _unit_grads(mt, ins, {"ctx": mt.cpu()}, attrs, hg)
    _close(ours[0], ref[0])
    for o, r in zip(ours[1:11], ref[1:11]):
        scale = float(np.abs(r).max()) + 1e-6
        np.testing.assert_allclose(o, r, rtol=0, atol=3e-5 * max(scale, 1.0))
    for o, r in zip(ours[11:], ref[11:]):
        _close(o, r)


def test_fused_unit_nd_equals_executor_bitwise():
    """The imperative unit and the same unit bound as a symbol run the
    same ops in the same order: output and gradients equal bit for bit
    (chip_smoke holds the same on the card through the kernels)."""
    rng = np.random.default_rng(19)
    c = 32
    ins = [_rand(rng, 2, 8, 8, c)] + _unit_params(rng, c)
    with mt.cpu():
        arrs = [mt.nd.array(a) for a in ins]
        for a in arrs[:10]:
            a.attach_grad()
        with mt.autograd.record():
            out = mt.nd._contrib_FusedBottleneckUnit(*arrs, num_filter=c,
                                                     layout="NHWC",
                                                     name="u")
        out.backward()
        sym = mt.sym._contrib_FusedBottleneckUnit(mt.sym.Variable("data"),
                                                  num_filter=c,
                                                  layout="NHWC", name="u")
        names = sym.list_arguments() + sym.list_auxiliary_states()
        ex = sym.bind(mt.cpu(), {n: mt.nd.array(a)
                                 for n, a in zip(sym.list_arguments(), ins)},
                      aux_states={n: mt.nd.array(a) for n, a in zip(
                          sym.list_auxiliary_states(), ins[10:])})
        ex_out = ex.forward(is_train=True)[0]
        ex.backward()
    assert len(names) == 16
    assert torch.equal(out._data, ex_out._data)
    for name, a in zip(sym.list_arguments(), arrs[:10]):
        assert torch.equal(a.grad._data, ex.grad_dict[name]._data), name


def test_context_scope_sets_the_default_device():
    """``with ctx:`` scopes nest, restore on exit, and are per thread."""
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
        assert mt.nd.zeros((2,)).context == mt.cpu()
        with mt.cpu(1):
            assert mt.current_context() == mt.cpu(1)
        assert mt.current_context() == mt.cpu()
        seen = {}

        def other():
            try:
                seen["ctx"] = mt.current_context()
            except mt.MXNetError as e:      # no card: the default raises
                seen["ctx"] = e
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert seen["ctx"] != mt.cpu()
        y = mt.nd.array([1.0, 2.0]) + 1.0
        assert y.context == mt.cpu()


def test_creation_in_scope_matches_explicit_ctx():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    with mt.cpu():
        x = mt.nd.array(a)
    y = mt.nd.array(a, ctx=mt.cpu())
    assert x.dtype == y.dtype == torch.float32
    np.testing.assert_array_equal(x.asnumpy(), y.asnumpy())


def test_symbolic_checks_hold_the_port_to_the_jax_executor():
    """The port's check_symbolic_forward / check_symbolic_backward pass on
    the JAX executor's outputs and gradients of the same graph, and fail on
    a wrong expectation."""
    rng = np.random.default_rng(23)
    loc = {"data": _rand(rng, 3, 4), "fc_weight": _rand(rng, 2, 4),
           "fc_bias": _rand(rng, 2)}
    hg = _rand(rng, 3, 2)
    jsym = mj.sym.FullyConnected(mj.sym.Variable("data"), num_hidden=2,
                                 name="fc")
    jex = jsym.bind(mj.cpu(), {k: mj.nd.array(v) for k, v in loc.items()})
    want = jex.forward(is_train=True)[0].asnumpy()
    jex.backward(out_grads=[mj.nd.array(hg)])
    grads = {k: jex.grad_dict[k].asnumpy() for k in loc}
    sym = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2,
                                name="fc")
    tu = mt.test_utils
    tu.check_symbolic_forward(sym, loc, [want], rtol=TOL, atol=TOL,
                              ctx=mt.cpu())
    tu.check_symbolic_backward(sym, loc, [hg], grads, rtol=TOL, atol=TOL,
                               ctx=mt.cpu())
    with pytest.raises(AssertionError, match="grad\\[fc_weight\\]"):
        tu.check_symbolic_backward(sym, loc, [hg],
                                   dict(grads, fc_weight=grads["fc_weight"]
                                        + 1.0), ctx=mt.cpu())
    with mt.cpu():
        with pytest.raises(AssertionError, match="forward"):
            tu.check_symbolic_forward(sym, loc, [want * 2.0])
