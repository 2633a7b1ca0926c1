"""Runtime kernels of the PyTorch port (``mt.rtc``) against the JAX
package's ``mx.rtc``.

``register_kernel_op`` installs a torch function as an op in the port and
a jax function in the JAX package (the ``swish_rt`` of
tests/test_custom_sparse.py); both then run through ``nd``, through a bound
symbol and through autograd on the same seeded inputs, within 1e-6 (the
same float32 formula in two libraries).  ``CudaModule`` needs a card and
``nvcc``: here it must raise, and tests/test_torch_kernels.py runs it on
the card.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import _REGISTRY as _JREGISTRY
from mxnet_tpu_torch.test_utils import check_numeric_gradient

torch.set_num_threads(1)

TOL = 1e-6


def _jax_swish_rt():
    """The JAX package's runtime op of tests/test_custom_sparse.py."""
    if "swish_rt" not in _JREGISTRY:
        mj.rtc.register_kernel_op(
            "swish_rt",
            lambda x, beta=1.0: x * (1 / (1 + jnp.exp(-beta * x))),
            params={"beta": mj.ops.P(float, 1.0)})


def _port_swish_rt():
    mt.rtc.register_kernel_op(
        "swish_rt", lambda x, beta=1.0: x * torch.sigmoid(beta * x),
        params={"beta": mt.ops.P(float, 1.0)})


def _x(shape=(2, 5), seed=0):
    return np.random.default_rng(seed).uniform(-2, 2, shape).astype(
        np.float32)


def test_register_kernel_op_nd_matches_jax():
    _jax_swish_rt()
    _port_swish_rt()
    x = _x()
    ref = mj.nd.swish_rt(mj.nd.array(x), beta=2.0).asnumpy()
    with mt.cpu():
        ours = mt.nd.swish_rt(mt.nd.array(x), beta=2.0)
    assert ours.context == mt.cpu()
    np.testing.assert_allclose(ours.asnumpy(), ref, rtol=TOL, atol=TOL)


def test_register_kernel_op_symbol_and_gradients_match_jax():
    """The op in a graph through Executor forward and backward, and under
    autograd, against the JAX package's."""
    _jax_swish_rt()
    _port_swish_rt()
    x, hg = _x(seed=1), _x(seed=2)
    outs = {}
    for pkg, ctx in ((mj, mj.cpu()), (mt, mt.cpu())):
        s = pkg.sym.swish_rt(pkg.sym.Variable("data"), beta=1.5)
        ex = s.bind(ctx, {"data": pkg.nd.array(x, ctx=ctx)})
        y = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(out_grads=[pkg.nd.array(hg, ctx=ctx)])
        a = pkg.nd.array(x, ctx=ctx)
        a.attach_grad()
        with pkg.autograd.record():
            z = pkg.nd.swish_rt(a, beta=1.5)
        z.backward(pkg.nd.array(hg, ctx=ctx))
        outs[pkg] = (y, ex.grad_dict["data"].asnumpy(), a.grad.asnumpy())
    for o, r in zip(outs[mt], outs[mj]):
        np.testing.assert_allclose(o, r, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(outs[mt][1], outs[mt][2])


def test_register_kernel_op_numeric_gradient():
    """The port's check_numeric_gradient through the symbol path, as the
    reference's test runs its own."""
    _port_swish_rt()
    out = mt.sym.swish_rt(mt.sym.Variable("data"), beta=1.0)
    check_numeric_gradient(out, {"data": _x((1, 5))}, numeric_eps=1e-3,
                           rtol=5e-2, atol=1e-2, ctx=mt.cpu())


def _swish_vjp_pair():
    def fwd(x, beta=1.0):
        s = torch.sigmoid(beta * x)
        return x * s, (x, s)

    def bwd(res, g, beta=1.0):
        x, s = res
        return (g * (s + beta * x * s * (1 - s)),)
    return fwd, bwd


def test_register_kernel_op_vjp_pair():
    """A hand-written backward (vjp=) through autograd.Function: used when
    a gradient is recorded, ``fn`` alone otherwise; equal to torch
    autograd on the formula, through nd, Executor and autograd.grad."""
    calls = []

    def fn(x, beta=1.0):
        calls.append("fn")
        return x * torch.sigmoid(beta * x)
    mt.rtc.register_kernel_op("swish_vjp", fn, vjp=_swish_vjp_pair(),
                              params={"beta": mt.ops.P(float, 1.0)})
    x, hg = _x(seed=3), _x(seed=4)
    xt = torch.from_numpy(x).requires_grad_(True)
    (xt * torch.sigmoid(0.7 * xt)).backward(torch.from_numpy(hg))
    want = xt.grad.numpy()
    with mt.cpu():
        a = mt.nd.array(x)
        mt.nd.swish_vjp(a, beta=0.7)
        assert calls == ["fn"]
        a.attach_grad()
        with mt.autograd.record():
            y = mt.nd.swish_vjp(a, beta=0.7)
        assert calls == ["fn"]          # the forward of the pair ran
        [g] = mt.autograd.grad(y, [a], head_grads=mt.nd.array(hg))
        s = mt.sym.swish_vjp(mt.sym.Variable("data"), beta=0.7)
        ex = s.bind(mt.cpu(), {"data": mt.nd.array(x)})
        ex.forward(is_train=True)
        ex.backward(out_grads=[mt.nd.array(hg)])
    np.testing.assert_allclose(g.asnumpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), want,
                               rtol=TOL, atol=TOL)


def test_register_kernel_op_aliases_and_refresh():
    """Aliases and the refreshed nd and sym namespaces; registering a name
    again points it at the newest op, as in the reference."""
    mt.rtc.register_kernel_op("rt_scale", lambda x: x * 2.0,
                              aliases=("rt_scale_alias",))
    x = _x(seed=5)
    with mt.cpu():
        a = mt.nd.array(x)
        np.testing.assert_array_equal(mt.nd.rt_scale(a).asnumpy(), x * 2)
        np.testing.assert_array_equal(mt.nd.rt_scale_alias(a).asnumpy(),
                                      x * 2)
        mt.rtc.register_kernel_op("rt_scale", lambda x: x * 3.0)
        np.testing.assert_array_equal(mt.nd.rt_scale(a).asnumpy(), x * 3)
    s = mt.sym.rt_scale_alias(mt.sym.Variable("data"), name="sc")
    assert '"rt_scale"' in s.tojson()
    assert mt.ops.get_op("rt_scale_alias").name == "rt_scale"
    two = mt.rtc.register_kernel_op(
        "rt_split", lambda x: (x + 1.0, x - 1.0), nout=2)
    assert two.num_outputs() == 2
    with mt.cpu():
        hi, lo = mt.nd.rt_split(mt.nd.array(x))
    np.testing.assert_array_equal(hi.asnumpy(), x + 1.0)
    np.testing.assert_array_equal(lo.asnumpy(), x - 1.0)


def test_signature_parser():
    args = mt.rtc.parse_signature("const float *x, float *y, int n")
    assert [(a[0], a[1], a[2]) for a in args] == [
        (True, True, torch.float32), (True, False, torch.float32),
        (False, False, torch.int32)]
    args = mt.rtc.parse_signature(
        "const __nv_bfloat16* a, __half *b, int64_t m, double s")
    assert [a[2] for a in args] == [torch.bfloat16, torch.float16,
                                    torch.int64, torch.float64]
    for bad in ("float x y", "complex *z", "const float *x, __half h"):
        with pytest.raises(mt.MXNetError):
            mt.rtc.parse_signature(bad)


def test_kernel_launch_checks_its_arguments_before_the_driver():
    """Context, count, device and dtype are checked before any CUDA driver
    call, so a bad launch raises here too."""
    k = mt.rtc.CudaKernel(None, "add_one", mt.rtc.parse_signature(
        "const float *x, float *y, int n"))
    x = torch.zeros(4)
    with pytest.raises(mt.MXNetError, match="gpu context"):
        k.launch([x, x, 4], mt.cpu(), (1,), (4,))
    with pytest.raises(mt.MXNetError, match="3"):
        k.launch([x, x], mt.gpu(0), (1,), (4,))
    with pytest.raises(mt.MXNetError, match="contiguous"):
        k.launch([x, x, 4], mt.gpu(0), (1,), (4,))
    scalar = mt.rtc.CudaKernel(None, "k", mt.rtc.parse_signature("int n"))
    with pytest.raises(mt.MXNetError, match="scalar"):
        scalar.launch([x], mt.gpu(0), (1,), (4,))


def test_cuda_module_raises_without_a_card_or_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mt.MXNetError, match="CUDA card"):
        mt.rtc.CudaModule('extern "C" __global__ void k() {}')
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(mt.MXNetError, match="nvcc"):
        mt.rtc.CudaModule('extern "C" __global__ void k() {}')


def test_pallas_call_points_at_cuda_module():
    with pytest.raises(mt.MXNetError, match="CudaModule"):
        mt.rtc.pallas_call(lambda x_ref, o_ref: None)
