"""NDArray's methods, properties and operators, recorded indexing,
assignment and in-place updates, ``autograd.Function``, higher-order
``grad`` and the Symbol additions of the PyTorch port, against the JAX
package on the same seeded inputs.  Tolerance: 1e-5 relative and 1e-6
absolute in float32 (sums in another order); shapes and names exactly.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _pair(a):
    return mj.nd.array(a), mt.nd.array(a, ctx=mt.cpu())


def _close(ours, ref, tol=RTOL):
    ours = ours.asnumpy() if hasattr(ours, "asnumpy") else np.asarray(ours)
    ref = ref.asnumpy() if hasattr(ref, "asnumpy") else np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=ATOL)


METHODS = {
    "sum": lambda x: x.sum(axis=1), "mean": lambda x: x.mean(),
    "max": lambda x: x.max(axis=0, keepdims=True), "norm": lambda x: x.norm(),
    "abs": lambda x: x.abs(), "square": lambda x: x.square(),
    "exp": lambda x: x.exp(), "log_softmax": lambda x: x.log_softmax(),
    "reshape": lambda x: x.reshape((4, -1)),
    "reshape codes": lambda x: x.reshape(0, -1),
    "transpose": lambda x: x.transpose(), "T": lambda x: x.T,
    "flatten": lambda x: x.flatten(), "expand_dims": lambda x:
        x.expand_dims(axis=1),
    "tile": lambda x: x.tile(reps=(1, 2)), "clip": lambda x: x.clip(-0.5, 0.5),
    "astype": lambda x: x.astype("float16").astype("float32"),
    "split": lambda x: x.split(num_outputs=2, axis=1)[1],
    "slice_axis": lambda x: x.slice_axis(axis=1, begin=1, end=3),
    "pow": lambda x: abs(x) ** 1.5, "rpow": lambda x: 2.0 ** x,
    "mod": lambda x: x % 0.3, "neg": lambda x: -x,
    "compare": lambda x: (x > 0.1) + (x <= -0.2) + (x == x),
    "rsub rdiv": lambda x: (1.0 - x) / (2.0 + x) + 3.0 / (x + 2.5),
    "getitem": lambda x: x[1:3, ::2], "getitem int": lambda x: x[2],
    "broadcast_to": lambda x: x[0:1].broadcast_to((3, 6)),
    "dot": lambda x: x.dot(x.T),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_ndarray_method(name):
    a = np.random.default_rng(3).uniform(-1, 1, (4, 6)).astype(np.float32)
    jx, tx = _pair(a)
    fn = METHODS[name]
    _close(fn(tx), fn(jx))


def test_ndarray_properties_and_inplace():
    a = np.random.default_rng(4).uniform(-1, 1, (3, 4)).astype(np.float32)
    jx, tx = _pair(a)
    assert (tx.size, tx.ndim, len(tx)) == (jx.size, jx.ndim, len(jx))
    assert tx.sum().asscalar() == pytest.approx(float(jx.sum().asscalar()),
                                                rel=1e-6)
    assert float(tx[1, 2]) == float(jx[1, 2])
    for ops in ((lambda x: x.__iadd__(1.5)), (lambda x: x.__isub__(0.25)),
                (lambda x: x.__imul__(2.0)), (lambda x: x.__itruediv__(3.0))):
        same_t = tx._data
        tx, jx = ops(tx), ops(jx)
        assert tx._data is same_t          # in place outside a recording
        _close(tx, jx)
    ty = tx.detach()
    assert ty._data.data_ptr() == tx._data.data_ptr()
    with mt.cpu():
        assert mt.nd.ones((2, 3)).asnumpy().sum() == 6
        np.testing.assert_array_equal(mt.nd.full((2,), 4.0).asnumpy(),
                                      mj.nd.full((2,), 4.0).asnumpy())
        np.testing.assert_array_equal(mt.nd.arange(1, 7, 2).asnumpy(),
                                      mj.nd.arange(1, 7, 2).asnumpy())
        np.testing.assert_array_equal(mt.nd.ones_like(tx).asnumpy(),
                                      np.ones((3, 4), np.float32))
        assert mt.nd.empty((2, 2)).shape == (2, 2)


def _grad_pair(a, fn):
    """fn's gradient at ``a`` (summed output) in both packages."""
    out = []
    for pkg, x in zip((mj, mt), _pair(a)):
        x.attach_grad()
        with pkg.autograd.record():
            y = fn(x)
        y.backward()
        out.append(x.grad)
    return out


RECORDED = {
    "getitem": lambda x: (x[1:3, 1:] * 2).sum(),
    "setitem": lambda x: _setitem(x).sum(),
    "inplace": lambda x: _inplace(x).sum(),
    "astype": lambda x: (x.astype("float64") * x.astype("float64"))
    .astype("float32").sum(),
    "copy": lambda x: (x.copy() * x).sum(),
    "reductions": lambda x: x.max(axis=1).sum() + x.mean() * 3
    + x.norm(),
}


def _setitem(x):
    y = x * 1.0
    y[1:3] = x[0:2] * 3
    return y * x


def _inplace(x):
    y = x * 1.0
    y += x
    y *= x
    return y


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_recorded_gradient(name):
    a = np.random.default_rng(6).uniform(-1, 1, (4, 5)).astype(np.float32)
    tg, jg = _grad_pair(a, RECORDED[name])[::-1]
    _close(tg, jg)


class _Square(object):
    """x*x with the gradient 2*x*dy, written as each package's Function."""

    @staticmethod
    def build(pkg):
        class Sq(pkg.autograd.Function):
            def forward(self, x):
                self.x = x
                return x * x

            def backward(self, dy):
                return 2 * self.x * dy
        return Sq()


def test_autograd_function_against_jax():
    a = np.random.default_rng(8).uniform(-1, 1, (3, 4)).astype(np.float32)
    got = []
    for pkg, x in zip((mj, mt), _pair(a)):
        x.attach_grad()
        with pkg.autograd.record():
            y = _Square.build(pkg)(x)
            z = (y * 3 + x).sum()
        z.backward()
        got.append((y, x.grad))
    _close(got[1][0], got[0][0])
    _close(got[1][1], got[0][1])


def test_higher_order_grad():
    """grad(create_graph=True) of sum(x^3) is 3x^2, as the JAX package's;
    differentiated again through sum(g^2) it gives 36x^3 (the JAX
    package's tape cannot take this second step, so the formula holds
    it)."""
    a = np.random.default_rng(9).uniform(-1, 1, (3, 4)).astype(np.float32)
    jx, tx = _pair(a)
    jx.attach_grad()
    with mj.autograd.record():
        jg = mj.autograd.grad((jx * jx * jx).sum(), [jx],
                              create_graph=True)[0]
    tx.attach_grad()
    with mt.autograd.record():
        tg = mt.autograd.grad((tx * tx * tx).sum(), [tx],
                              create_graph=True)[0]
        z = (tg * tg).sum()
    z.backward()
    _close(tg, jg)
    np.testing.assert_allclose(tx.grad.asnumpy(), 36 * a ** 3, rtol=1e-5)


def test_get_symbol_raises_as_the_reference():
    with mt.cpu():
        x = mt.nd.ones((2,))
    with pytest.raises(NotImplementedError):
        mt.autograd.get_symbol(x)
    with pytest.raises(NotImplementedError):
        mj.autograd.get_symbol(mj.nd.ones((2,)))


def test_symbol_additions_against_jax():
    """list_inputs, get_internals, infer_type, infer_shape_partial, attr,
    / and unary -, the methods and var's attributes, in both packages."""
    built = []
    for pkg in (mj, mt):
        with mj.base.NameManager() if pkg is mj else mt.base.NameManager():
            d = pkg.sym.var("data")
            w = pkg.sym.var("w", dtype="float32", lr_mult=2.0, wd_mult=0.5,
                            init="zeros")
            fc = pkg.sym.FullyConnected(d, w, num_hidden=4, no_bias=True,
                                        name="fc")
            bn = pkg.sym.BatchNorm(fc, name="bn")
            y = -(bn / 2.0).sum(axis=1) + bn.mean() + fc.reshape((0, 2, 2)) \
                .sum(axis=(1, 2))
            built.append((w, y))
    (jw, jy), (tw, ty) = built
    assert ty.list_inputs() == jy.list_inputs()
    assert ty.list_arguments() == jy.list_arguments()
    assert ty.list_auxiliary_states() == jy.list_auxiliary_states()
    assert ty.get_internals().list_outputs() == \
        jy.get_internals().list_outputs()
    assert tw.attr("__lr_mult__") == str(jw.attr("__lr_mult__"))
    assert ty.infer_shape_partial() == jy.infer_shape_partial()
    assert ty.infer_shape(data=(3, 5)) == jy.infer_shape(data=(3, 5))
    assert ty.infer_type(data="float32") == jy.infer_type(data="float32")
    assert ty.infer_shape_partial(data=(3, 5))[0] == \
        jy.infer_shape_partial(data=(3, 5))[0]
    assert mt.sym.load_json(jy.tojson()).tojson() == jy.tojson()


class _Wrapper:
    """A fresh Python object for a graph node at every access, as some
    torch builds hand out an autograd node's wrapper: freed once the
    caller drops it, so its id can come back for another node."""

    def __init__(self, node):
        self._node = node

    @property
    def next_functions(self):
        return tuple((_Wrapper(n) if not isinstance(n, torch.Tensor)
                      else _Leaf(n), 0) for n in self._node)


class _Leaf:
    def __init__(self, tensor):
        self.variable = tensor


def test_variable_walk_survives_fresh_node_wrappers():
    """``autograd._variables`` finds every variable when each node's
    wrapper is a new object whose id a freed one may have had (a torch
    build on the card hands wrappers out so: the walk found 1 of
    ResNet-50 v2's 155 parameters before it held the nodes it visited)."""
    with mt.cpu():
        arrs = [mt.nd.array(np.full((2,), i, np.float32)) for i in range(40)]
    for a in arrs:
        a.attach_grad()
    # a chain of 40 nodes, each with one variable and the rest of the chain
    node = []
    for a in reversed(arrs):
        node = [a._data, node]
    head = type("Head", (), {"grad_fn": _Wrapper(node)})()
    assert len(mt.autograd._variables([head])) == len(arrs)
