"""The ResNet ops of the PyTorch port against the JAX package's ops.

Each op runs through ``mxnet_tpu.ops.registry.invoke_jax`` and the port's
``invoke`` on the same numpy inputs, in eval mode.  Tolerance: 2e-5 in
float32 for ops that sum products (convolution, fully connected, pooling
averages), the rounding of sums taken in another order; exact equality for
data movement (reshape, flatten, max pooling, relu).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops.registry import invoke_jax
from mxnet_tpu_torch.ops.registry import invoke

# Small CPU cases: one torch thread runs them faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

TOL = 2e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(op, attrs, *inputs):
    """(port outputs, JAX outputs) as numpy lists."""
    ours = invoke(op, attrs, *[torch.from_numpy(a) for a in inputs])
    ref = invoke_jax(op, attrs, *[jnp.asarray(a) for a in inputs])
    return ([o.numpy() for o in ours], [np.asarray(r) for r in ref])


def _check(op, attrs, *inputs, tol=TOL):
    ours, ref = _both(op, attrs, *inputs)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        if tol:
            np.testing.assert_allclose(o, r, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(o, r)


CONV_CASES = [
    # (data shape, attrs): the ResNet-50 stem, its strided 1x1 shortcut,
    # a channels-last 3x3 transition, a plain 1x1, and NCHW with a bias
    ((2, 32, 32, 3), dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                          num_filter=8, no_bias=True, layout="NHWC")),
    ((2, 9, 9, 16), dict(kernel=(1, 1), stride=(2, 2), num_filter=32,
                         no_bias=True, layout="NHWC")),
    ((2, 9, 9, 8), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        num_filter=16, no_bias=True, layout="NHWC")),
    ((3, 5, 5, 16), dict(kernel=(1, 1), num_filter=8, no_bias=True,
                         layout="NHWC")),
    ((2, 4, 9, 9), dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                        num_filter=6)),
]


@pytest.mark.parametrize("shape,attrs", CONV_CASES)
def test_convolution(shape, attrs):
    rng = np.random.default_rng(len(shape) + sum(shape))
    cl = attrs.get("layout") == "NHWC"
    cin = shape[-1] if cl else shape[1]
    k = attrs["kernel"]
    w = _rand(rng, *((attrs["num_filter"],) + k + (cin,) if cl
                     else (attrs["num_filter"], cin) + k), scale=0.2)
    ins = [_rand(rng, *shape), w]
    if not attrs.get("no_bias"):
        ins.append(_rand(rng, attrs["num_filter"]))
    _check("Convolution", attrs, *ins)


@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_batchnorm_eval(fix_gamma, layout):
    rng = np.random.default_rng(7)
    shape, axis = ((2, 5, 5, 6), 3) if layout == "NHWC" else ((2, 6, 5, 5), 1)
    x = _rand(rng, *shape)
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    beta, mean = _rand(rng, 6), _rand(rng, 6)
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    _check("BatchNorm", dict(fix_gamma=fix_gamma, eps=2e-5, axis=axis),
           x, gamma, beta, mean, var)


def test_activation_relu():
    x = _rand(np.random.default_rng(1), 3, 4, 5)
    _check("Activation", dict(act_type="relu"), x, tol=0)


@pytest.mark.parametrize("attrs,tol", [
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
          layout="NHWC"), 0),
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          layout="NHWC"), TOL),
    (dict(global_pool=True, kernel=(7, 7), pool_type="avg",
          layout="NHWC"), TOL),
    (dict(kernel=(2, 2), stride=(2, 2), pool_type="max"), 0),
])
def test_pooling(attrs, tol):
    rng = np.random.default_rng(2)
    shape = (2, 9, 9, 4) if attrs.get("layout") == "NHWC" else (2, 4, 8, 8)
    # all-negative inputs: padding with zeros instead of -inf would show
    _check("Pooling", attrs, -np.abs(_rand(rng, *shape)) - 0.1, tol=tol)


@pytest.mark.parametrize("batch", [1, 3, 11])
def test_fully_connected(batch):
    rng = np.random.default_rng(batch)
    _check("FullyConnected", dict(num_hidden=10),
           _rand(rng, batch, 2, 2, 4), _rand(rng, 10, 16, scale=0.3),
           _rand(rng, 10))


def test_fully_connected_rows_do_not_depend_on_batch():
    """An example's answer is bitwise the same alone and in a batch."""
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 11, 64), _rand(rng, 10, 64)
    attrs = dict(num_hidden=10, no_bias=True)
    full = invoke("FullyConnected", attrs, torch.from_numpy(x),
                  torch.from_numpy(w))[0]
    for i in (0, 5, 10):
        one = invoke("FullyConnected", attrs, torch.from_numpy(x[i:i + 1]),
                     torch.from_numpy(w))[0]
        assert torch.equal(one[0], full[i])


def test_softmax_output():
    rng = np.random.default_rng(3)
    _check("SoftmaxOutput", {}, _rand(rng, 4, 10, scale=3.0),
           np.zeros(4, np.float32))


def test_elemwise_add():
    rng = np.random.default_rng(5)
    _check("elemwise_add", {}, _rand(rng, 2, 3), _rand(rng, 2, 3), tol=0)


@pytest.mark.parametrize("shape,spec", [
    ((2, 4, 4, 8), (-1, 8)),          # stageN_rows
    ((32, 8), (-1, 4, 4, 8)),         # stageN_grid
    ((2, 3, 4), (0, -1)),
    ((2, 3, 4), (-3, 0)),
    ((2, 4, 3), (0, -4, -1, 2, 0)),
    ((2, 3, 4), (-2,)),
])
def test_reshape_codes(shape, spec):
    x = _rand(np.random.default_rng(6), *shape)
    _check("Reshape", dict(shape=spec), x, tol=0)


def test_flatten():
    x = _rand(np.random.default_rng(8), 2, 1, 1, 6)
    _check("Flatten", {}, x, tol=0)


# ---------------------------------------------------------------------------
# The attention decoder's ops (step, draft and commit graphs), forward
# ---------------------------------------------------------------------------

def _ids(rng, n, hi):
    """Token ids and positions arrive as float32, as in the decode graphs,
    with a fractional and an out-of-range value among them."""
    v = rng.integers(0, hi, n).astype(np.float32)
    v[0], v[-1] = hi - 1 + 0.7, hi + 3
    return v


def test_embedding():
    rng = np.random.default_rng(21)
    _check("Embedding", dict(input_dim=12, output_dim=5), _ids(rng, 7, 12),
           _rand(rng, 12, 5), tol=0)


@pytest.mark.parametrize("axis", [1, -1])
def test_softmax(axis):
    rng = np.random.default_rng(22)
    x = _rand(rng, 4, 16, scale=4.0)
    x[:, 9:] = -1e9                     # masked positions, as the decoder's
    # torch and XLA evaluate exp and the sum in other orders: 1e-6
    _check("softmax", dict(axis=axis), x, tol=1e-6)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True)])
def test_batch_dot(ta, tb):
    rng = np.random.default_rng(23)
    a = _rand(rng, 4, 16, 8) if not ta else _rand(rng, 4, 8, 16)
    b = _rand(rng, 4, 8, 1) if not tb else _rand(rng, 4, 1, 8)
    _check("batch_dot", dict(transpose_a=ta, transpose_b=tb), a, b)


def test_argmax_takes_the_first_index_on_ties():
    rng = np.random.default_rng(24)
    x = np.round(_rand(rng, 6, 9), 0)   # many ties
    x[2] = 1.0
    for attrs in (dict(axis=1), dict(axis=0, keepdims=True), {}):
        _check("argmax", attrs, x, tol=0)


@pytest.mark.parametrize("attrs", [dict(depth=16),
                                   dict(depth=8, on_value=2.0,
                                        off_value=-1.0, dtype="float16")])
def test_one_hot(attrs):
    _check("one_hot", attrs, _ids(np.random.default_rng(25), 6, 16) - 2.0,
           tol=0)


@pytest.mark.parametrize("attrs", [dict(start=0, stop=32),
                                   dict(start=5), dict(start=1, stop=4,
                                                       step=0.5, repeat=2)])
def test_arange(attrs):
    _check("_arange", attrs, tol=0)


@pytest.mark.parametrize("op,attrs,shape", [
    ("expand_dims", dict(axis=1), (4, 8)),
    ("expand_dims", dict(axis=2), (4, 8)),
    ("expand_dims", dict(axis=-1), (4, 8)),
    ("slice_axis", dict(axis=1, begin=2, end=3), (4, 5, 8)),
    ("slice_axis", dict(axis=-1, begin=1), (4, 5, 8)),
    ("reshape", dict(shape=(0, 16)), (4, 16, 1)),
    ("reshape", dict(shape=(-1, 1)), (4,)),
])
def test_shape_ops(op, attrs, shape):
    _check(op, attrs, _rand(np.random.default_rng(26), *shape), tol=0)


@pytest.mark.parametrize("op,shapes", [
    ("elemwise_sub", [(3, 4), (3, 4)]),
    ("elemwise_mul", [(3, 4), (3, 4)]),
    ("broadcast_mul", [(3, 16, 8), (3, 16, 1)]),
    ("broadcast_lesser_equal", [(1, 16), (3, 1)]),
    ("greater", [(3, 4), (3, 4)]),
])
def test_binary_ops(op, shapes):
    rng = np.random.default_rng(27)
    ins = [np.round(_rand(rng, *s, scale=3.0), 0) for s in shapes]
    _check(op, {}, *ins, tol=0)


@pytest.mark.parametrize("op,scalar", [
    ("_plus_scalar", 3.0), ("_minus_scalar", 0.25), ("_rminus_scalar", 1.0),
    ("_mul_scalar", 1.0 / np.sqrt(200)), ("_mul_scalar", -1e9),
    ("_greater_scalar", 1.0)])
def test_scalar_ops(op, scalar):
    x = np.round(_rand(np.random.default_rng(28), 4, 6, scale=2.0), 1)
    _check(op, dict(scalar=scalar), x, tol=0)


# ---------------------------------------------------------------------------
# Training: forward in training mode and gradients against jax.vjp
# ---------------------------------------------------------------------------

def _vjp_both(op, attrs, inputs, wrt, head):
    """(port outputs, port gradients, JAX outputs, JAX gradients) of
    sum(out[0] * head) with respect to inputs[i] for i in wrt, in
    training mode.  A gradient the port does not produce reads as zeros,
    as the executor writes it."""
    import jax
    ts = [torch.from_numpy(a).requires_grad_(i in wrt)
          for i, a in enumerate(inputs)]
    outs = invoke(op, attrs, *ts, training=True)
    (outs[0] * torch.from_numpy(head)).sum().backward()
    grads = [ts[i].grad.numpy() if ts[i].grad is not None
             else np.zeros_like(inputs[i]) for i in wrt]

    def f(*diff):
        args = [jnp.asarray(a) for a in inputs]
        for i, d in zip(wrt, diff):
            args[i] = d
        return invoke_jax(op, attrs, *args, training=True)
    ref, vjp = jax.vjp(lambda *d: f(*d)[0],
                       *[jnp.asarray(inputs[i]) for i in wrt])
    ref_grads = vjp(jnp.asarray(head))
    return ([o.detach().numpy() for o in outs], grads,
            [np.asarray(r) for r in f(*[jnp.asarray(inputs[i])
                                       for i in wrt])],
            [np.asarray(g) for g in ref_grads])


def _close_scaled(got, want, tol=TOL):
    """Within tol of max(1, the reference's largest magnitude)."""
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("fix_gamma", [True, False])
def test_batchnorm_training(fix_gamma):
    """Batch statistics, moving-average write-backs and the hand-written
    backward; with fix_gamma gamma's gradient is zero in both."""
    rng = np.random.default_rng(11)
    x = _rand(rng, 4, 5, 5, 6) + 0.5
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    beta, mean = _rand(rng, 6), _rand(rng, 6)
    var = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    head = _rand(rng, *x.shape)
    attrs = dict(fix_gamma=fix_gamma, eps=2e-5, axis=3, momentum=0.9)
    outs, grads, ref, ref_grads = _vjp_both(
        "BatchNorm", attrs, [x, gamma, beta, mean, var], (0, 1, 2), head)
    assert len(outs) == len(ref) == 5
    for o, r in zip(outs, ref):
        _close_scaled(o, r)
    for g, r in zip(grads, ref_grads):
        _close_scaled(g, r)
    if fix_gamma:
        assert not grads[1].any()


@pytest.mark.parametrize("attrs", [
    {}, dict(normalization="batch"), dict(normalization="valid"),
    dict(normalization="valid", use_ignore=True, ignore_label=2),
    dict(use_ignore=True, ignore_label=0, grad_scale=0.5),
    dict(smooth_alpha=0.1, normalization="batch"),
])
def test_softmax_output_gradient(attrs):
    """p - onehot(label), whatever the head gradient."""
    rng = np.random.default_rng(12)
    data = _rand(rng, 6, 5, scale=2.0)
    label = np.array([0, 2, 4, 2, 1, 3], np.float32)
    outs, grads, ref, ref_grads = _vjp_both(
        "SoftmaxOutput", attrs, [data, label], (0,), _rand(rng, 6, 5))
    _close_scaled(outs[0], ref[0])
    _close_scaled(grads[0], ref_grads[0])


@pytest.mark.parametrize("op,momentum", [("sgd_update", None),
                                         ("sgd_mom_update", 0.9)])
@pytest.mark.parametrize("clip", [-1.0, 0.05])
def test_sgd_updates_in_place(op, momentum, clip):
    from mxnet_tpu_torch.ops import optimizer_ops
    rng = np.random.default_rng(13)
    w, g, mom = _rand(rng, 4, 6), _rand(rng, 4, 6), _rand(rng, 4, 6)
    attrs = dict(lr=0.05, wd=1e-4, rescale_grad=0.25, clip_gradient=clip)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(mom.copy())
    if momentum is None:
        ref = invoke_jax(op, attrs, jnp.asarray(w), jnp.asarray(g))
        optimizer_ops.sgd_update(tw, torch.from_numpy(g), **attrs)
        ours = [tw]
    else:
        attrs["momentum"] = momentum
        ref = invoke_jax(op, attrs, jnp.asarray(w), jnp.asarray(g),
                         jnp.asarray(mom))
        optimizer_ops.sgd_mom_update(tw, torch.from_numpy(g), tm, **attrs)
        ours = [tw, tm]
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


# 1x1 cases with the K8 gate on: (4, 8, 8, 16) is eligible (H*W <= 256),
# (2, 18, 18, 8) is not (H*W = 324), nor is the strided shortcut
TRAIN_CONV_CASES = CONV_CASES[:3] + [
    ((4, 8, 8, 16), dict(kernel=(1, 1), num_filter=12, no_bias=True,
                         layout="NHWC")),
    ((2, 18, 18, 8), dict(kernel=(1, 1), num_filter=8, no_bias=True,
                          layout="NHWC")),
]


@pytest.mark.parametrize("shape,attrs", TRAIN_CONV_CASES)
def test_convolution_gradients(shape, attrs, monkeypatch):
    monkeypatch.setenv("MXNET_CONV1X1_FUSED_BWD", "1")
    from mxnet_tpu_torch.ops import nn
    rng = np.random.default_rng(sum(shape))
    cin = shape[-1]
    w = _rand(rng, *((attrs["num_filter"],) + attrs["kernel"] + (cin,)),
              scale=0.2)
    x = _rand(rng, *shape)
    out_shape = invoke("Convolution", attrs, torch.from_numpy(x),
                       torch.from_numpy(w))[0].shape
    calls = []
    plain = nn.conv1x1_bwd_plain
    monkeypatch.setattr(nn, "conv1x1_bwd_plain",
                        lambda *a: calls.append(a) or plain(*a))
    outs, grads, ref, ref_grads = _vjp_both(
        "Convolution", attrs, [x, w], (0, 1),
        _rand(rng, *out_shape))
    # K8's gate: only the stride-1 1x1 at H*W <= 256 goes through it (its
    # plain version, on the CPU)
    assert len(calls) == (shape == (4, 8, 8, 16))
    _close_scaled(outs[0], ref[0])
    for g, r in zip(grads, ref_grads):
        _close_scaled(g, r)


def test_conv1x1_bwd_plain_matches_pallas():
    """K8's plain version against _fused1x1_bwd_pallas (interpret mode)."""
    from mxnet_tpu.ops.nn import _fused1x1_bwd_pallas
    from mxnet_tpu_torch.ops import nn
    rng = np.random.default_rng(14)
    x, dy, w = _rand(rng, 512, 32), _rand(rng, 512, 48), _rand(rng, 48, 32)
    dx_ref, dw_ref = _fused1x1_bwd_pallas(jnp.asarray(x), jnp.asarray(dy),
                                          jnp.asarray(w))
    dx, dw = nn.conv1x1_bwd(torch.from_numpy(x), torch.from_numpy(dy),
                            torch.from_numpy(w).reshape(48, 1, 1, 32))
    _close_scaled(dx.numpy(), np.asarray(dx_ref))
    _close_scaled(dw.numpy().reshape(48, 32), np.asarray(dw_ref))


@pytest.mark.parametrize("op,attrs,shape,wshape", [
    ("FullyConnected", dict(num_hidden=10), (4, 2, 2, 4), (10, 16)),
    ("Pooling", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max", layout="NHWC"), (2, 9, 9, 4), None),
    ("Pooling", dict(global_pool=True, kernel=(7, 7), pool_type="avg",
                     layout="NHWC"), (2, 7, 7, 4), None),
])
def test_dense_and_pooling_gradients(op, attrs, shape, wshape):
    rng = np.random.default_rng(15)
    ins = [_rand(rng, *shape)]
    if wshape:
        ins += [_rand(rng, *wshape, scale=0.3), _rand(rng, wshape[0])]
    out_shape = invoke(op, attrs, *map(torch.from_numpy, ins))[0].shape
    outs, grads, ref, ref_grads = _vjp_both(
        op, attrs, ins, tuple(range(len(ins))), _rand(rng, *out_shape))
    _close_scaled(outs[0], ref[0])
    for g, r in zip(grads, ref_grads):
        _close_scaled(g, r)
