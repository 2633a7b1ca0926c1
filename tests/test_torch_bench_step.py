"""bench.py's training step in the PyTorch port against the JAX package.

The modules that ``bench.py``'s step needs, each against its JAX
counterpart on the same numpy inputs (the JAX side runs its Pallas
kernels as its own tests do, in interpret mode on the CPU):

- ``_contrib_BNStemConv``, the input BatchNorm fused with the stem
  convolution, over ``tests/test_bn_stem.py``'s cases in both layouts,
  with that file's tolerances (2e-5 forward, 1e-4 gradients), and
  against the port's own BatchNorm + Convolution;
- ``transpose``, ``Pad`` and ``Reshape``'s copy code over 6-D shapes, the
  ``s2d`` stem's ops: data movement, so exact;
- ``get_resnet_symbol``'s JSON for the three stems at ResNet-50, and the
  ``s2d`` stem's output against ``conv7``'s on the same weights;
- every op of the step in bfloat16 (see ``BF16_TOL``);
- the step itself (``bench_step.TrainStep`` against ``bench.py``'s
  ``train_step`` body, rebuilt here from the JAX package's
  ``build_graph_fn``), in f32 and in bf16 (see ``STEP_TOL``);
- bf16 across the packages (``convert``, ``nd.array``), bit-exact;
- the SGD update ops and ``SGD(multi_precision=True)`` on float16
  weights;
- the kernels' plans at bench.py's batch of 256.

The step runs on ``tests/test_torch_train.py``'s small net (two stages,
one fused unit each) at batch 4 and 64x64.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mxnet_tpu as mj
import mxnet_tpu.models  # noqa: F401
from mxnet_tpu.executor import build_graph_fn as jax_build_graph_fn
from mxnet_tpu.models.resnet import _resnet as jax_small_resnet
from mxnet_tpu.ops.registry import invoke_jax
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.resnet import _resnet as port_small_resnet
from mxnet_tpu_torch.ops import _cuda, fused_unit as tfu, nn as tnn
from mxnet_tpu_torch.ops.registry import invoke

torch.set_num_threads(1)

BATCH = 4
NET = ([2, 2], 2, [16, 64, 128], 10, (3, 64, 64), True)
SHAPES = {"data": (BATCH, 64, 64, 3), "softmax_label": (BATCH,)}
LR = 0.05
# tests/test_bn_stem.py's cases: (H, W, k, stride, pad)
STEM_CASES = [
    (12, 12, 7, (2, 2), (3, 3)),
    (11, 13, 7, (2, 2), (3, 3)),
    (10, 10, 3, (1, 1), (1, 1)),
    (9, 9, 5, (3, 2), (0, 2)),
    (8, 8, 1, (1, 1), (0, 0)),
]
STEM_FWD_TOL, STEM_BWD_TOL = 2e-5, 1e-4


def _rel(got, want):
    """Largest difference over the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              or 1.0)


def _f32(a):
    """numpy f32 of a torch tensor or a JAX array, bf16 too."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# (a), (b): the fused stem
# ---------------------------------------------------------------------------

def _stem_attrs(k, stride, pad, cl, nf=4):
    return {"eps": 2e-5, "momentum": 0.9, "fix_gamma": True,
            "num_filter": nf, "kernel": (k, k), "stride": stride,
            "pad": pad, "layout": "NHWC" if cl else None}


def _stem_inputs(case, cl, rng):
    """data, gamma, beta, weight, moving mean, moving var (the moving
    statistics not the identity, so that eval mode shows a mix-up)."""
    h, w, k = case[:3]
    data = rng.standard_normal((3, h, w, 2) if cl else (3, 2, h, w)) * 2 + 1
    weight = rng.standard_normal((4, k, k, 2) if cl else (4, 2, k, k)) * 0.3
    return [a.astype(np.float32) for a in (
        data, np.ones(2), rng.standard_normal(2), weight,
        rng.standard_normal(2) * 0.1, rng.uniform(0.5, 1.5, 2))]


def _jax_stem(attrs, ins, training):
    """(outputs, gradients of sum(tanh(out)) with respect to data, beta
    and weight) of the JAX op, jitted."""
    def loss(data, beta, weight):
        outs = invoke_jax("_contrib_BNStemConv", attrs, data,
                          jnp.asarray(ins[1]), beta, weight,
                          *map(jnp.asarray, ins[4:]), training=training)
        return jnp.sum(jnp.tanh(outs[0].astype(jnp.float32))), outs
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *map(jnp.asarray, (ins[0], ins[2], ins[3])))
    return outs, grads


def _port_stem(attrs, ins, training, op="_contrib_BNStemConv"):
    t = [torch.from_numpy(a) for a in ins]
    leaves = [t[0].requires_grad_(True), t[2].requires_grad_(True),
              t[3].requires_grad_(True)]
    if op == "_contrib_BNStemConv":
        outs = invoke(op, attrs, t[0], t[1], t[2], t[3], t[4], t[5],
                      training=training)
    else:
        # the unfused graph: BatchNorm(fix_gamma), then the convolution
        bn = invoke("BatchNorm", dict(
            eps=attrs["eps"], momentum=attrs["momentum"], fix_gamma=True,
            axis=3 if attrs["layout"] else 1), t[0], t[1], t[2], t[4], t[5],
            training=training)
        conv = invoke("Convolution", dict(
            num_filter=attrs["num_filter"], kernel=attrs["kernel"],
            stride=attrs["stride"], pad=attrs["pad"], no_bias=True,
            layout=attrs["layout"]), bn[0], t[3])
        outs = (conv[0], bn[3], bn[4])
    grads = torch.autograd.grad(torch.tanh(outs[0].float()).sum(), leaves,
                                allow_unused=True)
    return outs, [torch.zeros_like(x) if g is None else g
                  for x, g in zip(leaves, grads)]


@pytest.mark.parametrize("cl", [True, False], ids=["NHWC", "NCHW"])
@pytest.mark.parametrize("case", STEM_CASES)
def test_bn_stem_matches_jax(case, cl):
    """Output, moving statistics, dW, dbeta and the zero d(data) in
    training, and the output in eval (moving statistics), against the JAX
    op, with tests/test_bn_stem.py's tolerances: 2e-5 forward, 1e-4
    gradients."""
    rng = np.random.default_rng([STEM_CASES.index(case), cl])
    ins = _stem_inputs(case, cl, rng)
    attrs = _stem_attrs(*case[2:], cl)
    for training in (True, False):
        ref_outs, ref_grads = _jax_stem(attrs, ins, training)
        outs, grads = _port_stem(attrs, ins, training)
        assert len(outs) == len(ref_outs) == 3
        np.testing.assert_allclose(_f32(outs[0]), _f32(ref_outs[0]),
                                   rtol=STEM_FWD_TOL, atol=STEM_FWD_TOL)
        for o, r in zip(outs[1:], ref_outs[1:]):       # the write-backs
            np.testing.assert_allclose(_f32(o), _f32(r), rtol=1e-6,
                                       atol=1e-6)
        if training:
            assert not grads[0].any() and not np.asarray(ref_grads[0]).any()
            for g, r in zip(grads[1:], ref_grads[1:]):  # dbeta, dW
                np.testing.assert_allclose(_f32(g), _f32(r),
                                           rtol=STEM_BWD_TOL,
                                           atol=STEM_BWD_TOL)


@pytest.mark.parametrize("cl", [True, False], ids=["NHWC", "NCHW"])
@pytest.mark.parametrize("case", STEM_CASES)
def test_bn_stem_matches_port_batchnorm_convolution(case, cl):
    """The port's fused stem against its own BatchNorm(fix_gamma) +
    Convolution: the same output and moving statistics, and dbeta from
    the rectangle sums equal to the unfused graph's, which runs the stem's
    dgrad convolution (tests/test_bn_stem.py's tolerances)."""
    rng = np.random.default_rng([7, STEM_CASES.index(case), cl])
    ins = _stem_inputs(case, cl, rng)
    attrs = _stem_attrs(*case[2:], cl)
    for training in (True, False):
        fused, fgrads = _port_stem(attrs, ins, training)
        plain, pgrads = _port_stem(attrs, ins, training, op="unfused")
        np.testing.assert_allclose(_f32(fused[0]), _f32(plain[0]),
                                   rtol=STEM_FWD_TOL, atol=STEM_FWD_TOL)
        for o, r in zip(fused[1:], plain[1:]):
            np.testing.assert_allclose(_f32(o), _f32(r), rtol=1e-6,
                                       atol=1e-6)
        for g, r in zip(fgrads[1:], pgrads[1:]):
            np.testing.assert_allclose(_f32(g), _f32(r), rtol=STEM_BWD_TOL,
                                       atol=STEM_BWD_TOL)


def test_bn_stem_raises_as_the_reference_does():
    """fix_gamma=False and data that is not 4-D raise in both packages."""
    ins = _stem_inputs(STEM_CASES[0], True, np.random.default_rng(0))
    t = [torch.from_numpy(a) for a in ins]
    bad = dict(_stem_attrs(*STEM_CASES[0][2:], True), fix_gamma=False)
    with pytest.raises(MXNetError, match="fix_gamma"):
        invoke("_contrib_BNStemConv", bad, *t)
    with pytest.raises(mj.base.MXNetError, match="fix_gamma"):
        invoke_jax("_contrib_BNStemConv", bad, *map(jnp.asarray, ins))
    flat = [t[0][0]] + t[1:]
    attrs = _stem_attrs(*STEM_CASES[0][2:], True)
    with pytest.raises(MXNetError, match="2D convs only"):
        invoke("_contrib_BNStemConv", attrs, *flat)
    with pytest.raises(mj.base.MXNetError, match="2D convs only"):
        invoke_jax("_contrib_BNStemConv", attrs,
                   *map(jnp.asarray, [ins[0][0]] + ins[1:]))


# ---------------------------------------------------------------------------
# (c): the s2d stem's data movement
# ---------------------------------------------------------------------------

MOVE_CASES = [
    ("transpose", {"axes": (0, 1, 3, 2, 4, 5)}, (2, 3, 2, 3, 2, 3)),
    ("transpose", {"axes": (0, 3, 1, 2)}, (4, 7, 7, 3)),
    ("transpose", {}, (2, 3, 4)),
    ("Pad", {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 0, 1, 0)},
     (4, 3, 7, 7)),
    ("Pad", {"mode": "constant", "pad_width": (0, 1, 2, 0, 1, 3),
             "constant_value": 1.5}, (2, 3, 4)),
    ("Reshape", {"shape": (0, 4, 2, 4, 2, 3)}, (2, 8, 8, 3)),
    ("Reshape", {"shape": (0, 4, 4, 12)}, (2, 4, 2, 4, 2, 3)),
]


@pytest.mark.parametrize("op,attrs,shape", MOVE_CASES)
def test_data_movement_matches_jax(op, attrs, shape):
    """Bit-equal to the JAX op, in f32 and bf16."""
    x = np.random.default_rng(len(shape)).standard_normal(shape)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        ours = invoke(op, attrs, torch.from_numpy(x).to(dt))[0]
        ref = invoke_jax(op, attrs, jnp.asarray(x, jdt))[0]
        assert ours.dtype == dt and tuple(ours.shape) == ref.shape
        np.testing.assert_array_equal(_f32(ours), _f32(ref))


def test_pad_modes_not_ported_raise():
    with pytest.raises(MXNetError, match="not yet ported"):
        invoke("Pad", {"mode": "edge", "pad_width": (0, 0, 1, 1)},
               torch.zeros(2, 2))


# ---------------------------------------------------------------------------
# (d): the stems in the ResNet builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stem", ["conv7", "fused", "s2d"])
def test_resnet50_symbol_json_matches_jax(stem):
    """get_resnet_symbol(num_layers=50, layout="NHWC", stem=...) builds
    the JAX package's JSON, and infers its shapes."""
    with mj.base.NameManager(), mt.base.NameManager():
        ref = mj.models.get_resnet_symbol(num_layers=50, layout="NHWC",
                                          stem=stem)
        sym = mt.models.get_resnet_symbol(num_layers=50, layout="NHWC",
                                          stem=stem)
    assert sym.tojson() == ref.tojson()
    assert sym.infer_shape(data=(2, 224, 224, 3))[1] == [(2, 1000)]


def _small(stem, impl="plain", pkg=mt):
    build = port_small_resnet if pkg is mt else jax_small_resnet
    with pkg.base.NameManager():
        return build(*NET, layout="NHWC", unit_impl=impl, stem=stem)


def test_s2d_stem_equals_conv7():
    """The space-to-depth stem is the 7x7/s2 convolution rewritten: the
    small net's output through it equals conv7's on the same weights, in
    training (batch statistics) and eval, to f32 rounding (2e-5 of the
    largest probability); the gradients of conv0_weight agree to 1e-3 of
    the largest (BatchNorm chains amplify the rounding of the other sum
    order, as tests/test_torch_train.py measures)."""
    syms = {s: _small(s) for s in ("conv7", "s2d")}
    assert syms["s2d"].list_arguments() == syms["conv7"].list_arguments()
    args, aux = mt.convert.random_params(syms["conv7"], SHAPES, seed=0)
    x = np.random.default_rng(1).standard_normal(SHAPES["data"])
    res = {}
    for stem, sym in syms.items():
        names = sym.list_arguments()
        fn = mt.executor.build_graph_fn(sym, names,
                                        sym.list_auxiliary_states())
        w = torch.from_numpy(args["conv0_weight"]).requires_grad_(True)
        vals = {n: torch.from_numpy(v) for n, v in args.items()}
        vals.update(conv0_weight=w, data=torch.from_numpy(x).float(),
                    softmax_label=torch.zeros(BATCH))
        auxs = [torch.from_numpy(aux[n])
                for n in sym.list_auxiliary_states()]
        outs = {}
        for training in (True, False):
            outs[training] = fn([vals[n] for n in names], auxs,
                                training=training)[0][0]
        # the loss head's gradient ignores the head gradient
        gw = torch.autograd.grad(outs[True], w,
                                 torch.ones_like(outs[True]))[0]
        res[stem] = (outs, gw)
    for training in (True, False):
        np.testing.assert_allclose(_f32(res["s2d"][0][training]),
                                   _f32(res["conv7"][0][training]),
                                   rtol=0, atol=2e-5)
    assert _rel(_f32(res["s2d"][1]), _f32(res["conv7"][1])) <= 1e-3


# ---------------------------------------------------------------------------
# (e): every op of the step in bf16, and the step
# ---------------------------------------------------------------------------

# Each op of the step on the same bf16 inputs in both packages: outputs
# rounded once from f32 sums taken in another order sit at most a bf16 step
# apart (2^-8 of the value), so outputs are held to 2^-7 of their largest
# magnitude, as chip_smoke.py holds the kernels; the gradients of
# sum(out * r) (r f32) take one more such rounding through the op's
# backward: 2^-6 of the largest.  The fused unit chains three convolutions
# and three BatchNorms, whose batch statistics amplify a bf16 step in an
# intermediate (measured: 1.6e-2 of the largest magnitude at most over its
# ten gradients): 4e-2.
BF16_TOL = {"out": 2.0 ** -7, "grad": 2.0 ** -6, "unit_grad": 4e-2}


def _unit_inputs(rng, n, h, w, c):
    cq = c // 4
    mk = lambda *s: rng.standard_normal(s) * 0.1  # noqa: E731
    vec = lambda k: rng.uniform(0.5, 1.5, k)  # noqa: E731
    return [rng.standard_normal((n * h * w, c)), vec(c), mk(c),
            mk(cq, 1, 1, c) * 4, vec(cq), mk(cq), mk(cq, 3, 3, cq) * 2,
            vec(cq), mk(cq), mk(c, 1, 1, cq) * 4,
            mk(c), vec(c), mk(cq), vec(cq), mk(cq), vec(cq)]


BF16_OPS = [
    # (op, attrs, input shapes or a maker, differentiable inputs, aux
    # (f32) inputs, environment)
    ("Convolution", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         num_filter=16, no_bias=True, layout="NHWC"),
     [(2, 9, 9, 8), (16, 3, 3, 8)], (0, 1), (), {}),
    ("Convolution", dict(kernel=(1, 1), num_filter=16, no_bias=True,
                         layout="NHWC"),
     [(2, 7, 7, 8), (16, 1, 1, 8)], (0, 1), (),
     {"MXNET_CONV1X1_FUSED_BWD": "1"}),
    ("BatchNorm", dict(fix_gamma=False, eps=2e-5, axis=3),
     [(2, 5, 5, 8), (8,), (8,), (8,), (8,)], (0, 1, 2), (3, 4), {}),
    ("Pooling", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max", layout="NHWC"),
     [(2, 9, 9, 4)], (0,), (), {}),
    ("Pooling", dict(kernel=(7, 7), global_pool=True, pool_type="avg",
                     layout="NHWC"), [(2, 7, 7, 4)], (0,), (), {}),
    ("Flatten", {}, [(2, 1, 1, 8)], (0,), (), {}),
    ("FullyConnected", dict(num_hidden=10), [(4, 16), (10, 16), (10,)],
     (0, 1, 2), (), {}),
    ("SoftmaxOutput", {}, [(4, 10), "labels"], (0,), (), {}),
    ("_contrib_BNStemConv", _stem_attrs(7, (2, 2), (3, 3), True, nf=8),
     [(2, 16, 16, 3), (3,), (3,), (8, 7, 7, 3), (3,), (3,)], (2, 3),
     (4, 5), {}),
    ("_contrib_FusedBottleneckUnit",
     dict(num_filter=32, eps=2e-5, height=6, width=6), "unit", None,
     tuple(range(10, 16)), {"MXNET_FUSED_UNIT_C3": None}),
    ("_contrib_FusedBottleneckUnit",
     dict(num_filter=32, eps=2e-5, height=6, width=6), "unit", None,
     tuple(range(10, 16)), {"MXNET_FUSED_UNIT_C3": "4d"}),
]


@pytest.mark.parametrize("op,attrs,shapes,diff,aux,env", BF16_OPS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_op_bf16_matches_jax(op, attrs, shapes, diff, aux, env,
                             monkeypatch):
    """Each op of bench.py's step in training mode on the same bf16
    inputs (f32 aux states, f32 labels): the outputs' dtypes are the JAX
    package's, values within BF16_TOL; and so are the gradients of
    sum(out * r) in the inputs' dtype."""
    for k, v in env.items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    rng = np.random.default_rng([BF16_OPS.index(
        (op, attrs, shapes, diff, aux, env))])
    if shapes == "unit":
        ins = _unit_inputs(rng, 2, 6, 6, 32)
        diff = tuple(range(10))
    else:
        ins = [rng.integers(0, 10, 4) if s == "labels"
               else rng.standard_normal(s) for s in shapes]
    f32_in = set(aux) | {i for i, s in enumerate(shapes) if s == "labels"}
    jins = [jnp.asarray(a, jnp.float32 if i in f32_in else jnp.bfloat16)
            for i, a in enumerate(ins)]
    tins = [torch.from_numpy(np.array(_f32(a))).to(
        torch.float32 if i in f32_in else torch.bfloat16)
        for i, a in enumerate(jins)]
    r = None

    def jloss(*d):
        x = list(jins)
        for i, v in zip(diff, d):
            x[i] = v
        outs = invoke_jax(op, attrs, *x, training=True)
        return jnp.sum(outs[0].astype(jnp.float32) * r), outs
    # one jitted program gives the gradients and, as its aux, the outputs
    shape = jax.eval_shape(lambda *x: invoke_jax(op, attrs, *x,
                                                 training=True),
                           *jins)[0].shape
    r = rng.standard_normal(shape).astype(np.float32)
    ref_grads, ref_outs = jax.jit(jax.grad(
        jloss, argnums=tuple(range(len(diff))), has_aux=True))(
        *[jins[i] for i in diff])
    for i in diff:
        tins[i].requires_grad_(True)
    outs = invoke(op, attrs, *tins, training=True)
    grads = torch.autograd.grad((outs[0].float() * torch.from_numpy(r))
                                .sum(), [tins[i] for i in diff])
    for o, ro in zip(outs, ref_outs):
        assert str(o.dtype).split(".")[1] == str(ro.dtype), (o.dtype,
                                                              ro.dtype)
        assert _rel(_f32(o), _f32(ro)) <= BF16_TOL["out"]
    tol = BF16_TOL["unit_grad" if shapes == "unit" else "grad"]
    for i, g, rg in zip(diff, grads, ref_grads):
        assert g.dtype == tins[i].dtype
        assert str(rg.dtype) == str(jins[i].dtype)
        assert _rel(_f32(g), _f32(rg)) <= tol, (i, _rel(_f32(g), _f32(rg)))


def _jax_step(sym, dtype):
    """bench.py's train_step body (bench.py:116-138) over the JAX
    package's build_graph_fn, jitted as bench.py jits it: (loss,
    {name: gradient}, {name: new parameter}, new aux) as numpy f32."""
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    graph_fn = jax_build_graph_fn(sym, arg_names, aux_names)
    names = [n for n in arg_names if n not in SHAPES]
    grad_idx = [arg_names.index(n) for n in names]
    data_pos = arg_names.index("data")
    label_pos = arg_names.index("softmax_label")

    def train_step(data_u8, labels, params, auxs, key):
        data = data_u8.astype(dtype) * jnp.asarray(1.0 / 255.0, dtype)

        def loss_fn(*wrt):
            av = [None] * len(arg_names)
            av[data_pos] = data
            av[label_pos] = labels
            for i, w in zip(grad_idx, wrt):
                av[i] = w
            outs, new_aux = graph_fn(tuple(av), auxs, key, True)
            probs = outs[0].astype(jnp.float32)
            lab = labels.astype(jnp.int32)
            ll = -jnp.mean(jnp.log(probs[jnp.arange(probs.shape[0]),
                                         lab] + 1e-8))
            return ll, new_aux

        (loss, new_aux), grads = jax.value_and_grad(
            loss_fn, argnums=tuple(range(len(params))), has_aux=True)(
            *params)
        new_params = tuple(p - jnp.asarray(LR, p.dtype) * g
                           for p, g in zip(params, grads))
        return loss, grads, new_params, new_aux
    step = jax.jit(train_step)

    def run(args, aux, u8, labels):
        loss, grads, new, new_aux = step(
            jnp.asarray(u8), jnp.asarray(labels),
            tuple(jnp.asarray(args[n], dtype) for n in names),
            tuple(jnp.asarray(aux[n]) for n in aux_names),
            jax.random.PRNGKey(0))
        for g, p in zip(grads, new):
            assert g.dtype == p.dtype == dtype
        return (float(loss), {n: _f32(g) for n, g in zip(names, grads)},
                {n: _f32(p) for n, p in zip(names, new)},
                {n: _f32(a) for n, a in zip(aux_names, new_aux)})
    return run


def _port_step(sym, dtype, args, aux, u8, labels):
    step = mt.bench_step.TrainStep(sym, dtype=dtype, lr=LR)
    params = [torch.from_numpy(args[n]).to(dtype) for n in step.param_names]
    auxs = [torch.from_numpy(aux[n]) for n in step.aux_names]
    loss, grads, new, new_aux = step(torch.from_numpy(u8),
                                     torch.from_numpy(labels), params, auxs)
    for g, p in zip(grads, new):
        assert g.dtype == p.dtype == dtype
    assert all(a.dtype == torch.float32 for a in new_aux)
    return (float(loss), {n: _f32(g) for n, g in zip(step.param_names, grads)},
            {n: _f32(p) for n, p in zip(step.param_names, new)},
            {n: _f32(a) for n, a in zip(step.aux_names, new_aux)})


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, SHAPES["data"], dtype=np.uint8)
    labels = rng.integers(0, 10, BATCH).astype(np.float32)
    return u8, labels


def _l2(got, want):
    """|got - want| / |want| over the tensors of ``want`` as one vector
    (|got - want| where ``want`` is zero)."""
    d = sum(float(((got[n] - want[n]).astype(np.float64) ** 2).sum())
            for n in want)
    r = sum(float((want[n].astype(np.float64) ** 2).sum()) for n in want)
    return (d / r) ** 0.5 if r else d ** 0.5


def test_bench_step_f32_matches_jax(step_inputs, monkeypatch):
    """The step in float32 (bench.py's CPU branch), stem fused, plain
    units: the loss within 1e-5; the gradients within 1e-2 (relative L2
    over all parameters as one vector) and 5e-2 (each parameter's relative
    L2); the parameters after the SGD step within 1e-3 and the aux states
    within 1e-4 of each tensor's largest magnitude.  Measured: the loss
    equal to its last bit, the aux states within 2.7e-6; the gradients
    2.7e-3 and 1.0e-2 at most (stage1_unit2_bn2_beta) and the parameters
    6.9e-4, because one ReLU input of stage1_unit2 sits within f32 rounding
    of zero (-5.4e-7 in the JAX package, 3.2e-6 in the port), so one
    element's cotangent passes in one package and not the other, and
    bn2_beta's gradient is a sum that BatchNorm's backward nearly cancels.
    Away from such a kink the two agree to 7e-6 (relative L2)."""
    monkeypatch.delenv("MXNET_CONV1X1_FUSED_BWD", raising=False)
    jsym, tsym = _small("fused", pkg=mj), _small("fused")
    assert jsym.tojson() == tsym.tojson()
    args, aux = mt.convert.random_params(tsym, SHAPES, seed=0)
    ref = _jax_step(jsym, jnp.float32)(args, aux, *step_inputs)
    got = _port_step(tsym, torch.float32, args, aux, *step_inputs)
    assert abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0])
    for part in (1, 2, 3):
        assert set(got[part]) == set(ref[part])
    assert _l2(got[1], ref[1]) <= 1e-2
    for n in ref[1]:
        assert _l2({n: got[1][n]}, {n: ref[1][n]}) <= 5e-2, n
    for n in ref[2]:
        assert _rel(got[2][n], ref[2][n]) <= 1e-3, n
    for n in ref[3]:
        assert _rel(got[3][n], ref[3][n]) <= 1e-4, n


# The bf16 step against the JAX package's, on the same numpy weights and
# uint8 batch.  A bf16 step at batch 4 is chaotic: each op rounds its output
# to bf16, and the BatchNorms' batch statistics over a few hundred values
# amplify a bf16 step into the gradients below them.  The control: the JAX
# step with conv0_weight moved one bf16 step away from zero moves the loss
# by 1.9e-3 relative at most, the gradients by 0.22 (relative L2 over all
# parameters; up to 0.98 in one small tensor, bn0_gamma), the head's
# gradients (fc1, bn1, each) by 0.025, the parameters after the step by
# 3.5e-2 of their largest magnitude and the aux states by 1.7e-3.  The port
# against the JAX package measures 4.7e-4, 0.30, 0.038, 6.0e-2 (bn_data_beta,
# whose gradient BatchNorm bn0's backward nearly cancels) and 1.4e-3 (plain
# and fused units alike).  Each limit is about 2.5x the larger of the two;
# every op is held sharply in bf16 above, and the whole step in f32.
STEP_TOL = {"loss": 5e-3, "grads_l2": 0.75, "head_l2": 0.1,
            "params": 0.15, "aux": 5e-3}


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_bench_step_bf16_matches_jax(impl, step_inputs, monkeypatch):
    """bench.py's step in bf16 with the fused stem, unit_impl plain
    (bench.py's) and fused (with K8's 1x1 backward on): every gradient
    and new parameter in bf16 in both packages, the aux states f32, and
    the loss, the gradients (all together and the head's alone), the
    parameters after the step and the aux states within STEP_TOL."""
    monkeypatch.setenv("MXNET_CONV1X1_FUSED_BWD", "1")
    jsym, tsym = _small("fused", impl, mj), _small("fused", impl)
    assert jsym.tojson() == tsym.tojson()
    args, aux = mt.convert.random_params(tsym, SHAPES, seed=0)
    ref = _jax_step(jsym, jnp.bfloat16)(args, aux, *step_inputs)
    got = _port_step(tsym, torch.bfloat16, args, aux, *step_inputs)
    assert abs(got[0] - ref[0]) <= STEP_TOL["loss"] * abs(ref[0])
    assert _l2(got[1], ref[1]) <= STEP_TOL["grads_l2"]
    head = [n for n in ref[1] if n.startswith(("fc1_", "bn1_"))]
    assert len(head) == 4
    for n in head:
        assert _l2({n: got[1][n]}, {n: ref[1][n]}) <= STEP_TOL["head_l2"], n
    for n in ref[2]:
        assert _rel(got[2][n], ref[2][n]) <= STEP_TOL["params"], n
    for n in ref[3]:
        assert _rel(got[3][n], ref[3][n]) <= STEP_TOL["aux"], n
    assert not got[1]["bn_data_gamma"].any()


# ---------------------------------------------------------------------------
# (f): bf16 across the packages
# ---------------------------------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(a).view(np.uint16)


def test_bf16_round_trips_bit_exact():
    """The JAX package's bf16 arrays (ml_dtypes' bfloat16 in numpy) enter
    the port bit for bit through nd.array, convert.params_from_numpy and
    NDArray assignment; bf16 -> asnumpy (f32) -> bf16 keeps the bits; a
    dtype of torch.bfloat16 or "bfloat16" casts f32 arrays; an NDArray
    source keeps its dtype."""
    x = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    jb = np.asarray(mj.nd.array(x, dtype=jnp.bfloat16).asnumpy())
    assert jb.dtype.name == "bfloat16"
    a = mt.nd.array(jb, ctx=mt.cpu())
    assert a.dtype == torch.bfloat16
    np.testing.assert_array_equal(a._data.view(torch.int16).numpy()
                                  .view(np.uint16), _bits(jb))
    for dt in (torch.bfloat16, "bfloat16"):
        b = mt.nd.array(a.asnumpy(), ctx=mt.cpu(), dtype=dt)
        assert torch.equal(b._data.view(torch.int16),
                           a._data.view(torch.int16))
        c = mt.nd.array(x, ctx=mt.cpu(), dtype=dt)
        assert torch.equal(c._data, torch.from_numpy(x).to(torch.bfloat16))
    assert mt.nd.array(a, ctx=mt.cpu()).dtype == torch.bfloat16
    args, aux = mt.convert.params_from_numpy({"w": jb}, {"m": x},
                                             device=mt.cpu())
    assert args["w"].dtype == torch.bfloat16
    assert aux["m"].dtype == torch.float32
    assert torch.equal(args["w"]._data, a._data)
    args, aux = mt.convert.params_from_numpy({"w": x}, {"m": x},
                                             device=mt.cpu(),
                                             dtype="bfloat16")
    assert torch.equal(args["w"]._data, c._data)
    z = mt.nd.zeros((3, 5), ctx=mt.cpu(), dtype="bfloat16")
    z[:] = jb
    assert torch.equal(z._data, a._data)
    # and back: the port's bf16 through asnumpy into the JAX package
    back = mj.nd.array(a.asnumpy(), dtype=jnp.bfloat16).asnumpy()
    np.testing.assert_array_equal(_bits(np.asarray(back)), _bits(jb))


# ---------------------------------------------------------------------------
# (g): SGD
# ---------------------------------------------------------------------------

SGD_OPS = [
    ("sgd_update", ["weight", "grad"], np.float32),
    ("sgd_mom_update", ["weight", "grad", "mom"], np.float32),
    ("mp_sgd_update", ["weight", "grad", "weight32"], np.float16),
    ("mp_sgd_mom_update", ["weight", "grad", "mom", "weight32"],
     np.float16),
]


@pytest.mark.parametrize("op,names,wdtype", SGD_OPS)
def test_sgd_ops_match_jax(op, names, wdtype):
    """The registered update ops against the JAX package's, with the same
    params, aux write-backs and visible outputs: f32 results within 1e-6
    relative (the same arithmetic, which XLA may contract into fused
    multiply-adds), float16 weights within one float16 step; and the
    in-place nd helper of the same name gives the op's values bit for
    bit."""
    rng = np.random.default_rng(len(op))
    ins = {"weight": rng.standard_normal((4, 5)).astype(wdtype),
           "grad": rng.standard_normal((4, 5)).astype(wdtype),
           "mom": rng.standard_normal((4, 5)).astype(np.float32) * 0.1}
    ins["weight32"] = ins["weight"].astype(np.float32) + 1e-3
    arrs = [ins[n] for n in names]
    attrs = dict(lr=0.1, wd=1e-3, rescale_grad=0.5, clip_gradient=0.8)
    if "mom" in op:
        attrs["momentum"] = 0.9
    tdef, jdef = mt.ops.get_op(op), mj.ops.registry.get_op(op)
    for key in ("nin", "nout", "mutate_aux", "num_visible_outputs"):
        assert getattr(tdef, key) == getattr(jdef, key), key
    assert set(tdef.params) == set(jdef.params)
    assert tdef.input_names() == jdef.input_names()
    ours = invoke(op, attrs, *[torch.from_numpy(a) for a in arrs])
    ref = invoke_jax(op, attrs, *[jnp.asarray(a) for a in arrs])
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert str(o.dtype).split(".")[1] == str(r.dtype)
        tol = 1e-3 if o.dtype == torch.float16 else 1e-6
        np.testing.assert_allclose(_f32(o), _f32(r), rtol=tol, atol=tol)
    nds = [mt.nd.array(a, ctx=mt.cpu()) for a in arrs]
    getattr(mt.nd, op)(*nds, out=nds[0], **attrs)
    for i, o in zip([0] + sorted(tdef.mutate_aux)[1:], ours):
        assert torch.equal(nds[i]._data, o)
    assert getattr(mt.sym, op) is not None


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_multi_precision_matches_jax(momentum):
    """SGD(multi_precision=True) through the Updater on a float16 weight
    keeps an f32 master copy (and an f32 momentum), as the JAX package's
    does; three steps give the same master copy within 1e-6 relative and
    the same float16 weight within one float16 step.  A bf16 or f32
    weight takes the plain update and no master copy."""
    rng = np.random.default_rng(5)
    w0 = rng.standard_normal((6, 4)).astype(np.float16)
    grads = [rng.standard_normal((6, 4)).astype(np.float16) for _ in range(3)]
    kw = dict(learning_rate=0.1, momentum=momentum, wd=1e-3,
              multi_precision=True, rescale_grad=0.5)
    res = []
    for pkg, ctx in ((mj, mj.cpu()), (mt, mt.cpu())):
        u = pkg.optimizer.get_updater(pkg.optimizer.SGD(**kw))
        w = pkg.nd.array(w0, ctx=ctx)
        for g in grads:
            u(0, pkg.nd.array(g, ctx=ctx), w)
        res.append((w.asnumpy(), u.states[0]))
    (jw, jst), (tw, tst) = res
    assert isinstance(tst, tuple) and len(tst) == 2
    assert tw.dtype == np.float16 and tst[1].dtype == torch.float32
    np.testing.assert_allclose(tst[1].asnumpy(), jst[1].asnumpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw.astype(np.float32), jw.astype(np.float32),
                               rtol=1e-3, atol=1e-3)
    if momentum:
        assert tst[0].dtype == torch.float32
        np.testing.assert_allclose(tst[0].asnumpy(), jst[0].asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    else:
        assert tst[0] is None and jst[0] is None
    for dt in ("bfloat16", "float32"):
        opt = mt.optimizer.SGD(**kw)
        w = mt.nd.array(w0.astype(np.float32), ctx=mt.cpu(), dtype=dt)
        state = opt.create_state(0, w)
        assert not isinstance(state, tuple)


# ---------------------------------------------------------------------------
# (h): the kernels' plans at bench.py's batch
# ---------------------------------------------------------------------------

# ResNet-50 at 224x224 and bench.py's batch of 256: per stage (H = W, unit
# width C); K8's three stride-1 1x1 sites (H*W, Ci, Co)
BENCH_ROWS = [(56, 256), (28, 512), (14, 1024), (7, 2048)]
K8_SITES = [(14, 256, 1024), (14, 1024, 512), (7, 512, 2048)]
GRID_YZ = 65535


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_kernel_plans_at_batch_256(f32):
    """At 256 x 56 x 56 = 802,816 rows (8x any earlier run) every plan of
    K1-K8 keeps its grid's y and z within CUDA's 65,535, its chunks whole
    and its tiles known to the launchers; the split scratch the buffers
    allocate stays under 1 GB; the tap gathers' 32-bit index division
    holds; and every element offset the kernels form in 32-bit ints (a
    row or channel index, a k index) stays under 2^31: the offsets
    themselves are 64-bit (csrc/fu_mma.cuh, fu_halo.cuh), the largest,
    K6's tap gather, reaching 9 x rows x 64."""
    meta = torch.device("meta")
    n = 256
    tiles = {(128, 128), (128, 64), (64, 128)}
    scratch = []

    def grid_ok(plan, m, n_):
        bm, bn, splits, chunk = plan
        assert (bm, bn) in tiles and (f32 is False or (bm, bn) != (128, 128))
        assert -(-m // bm) <= GRID_YZ and splits <= GRID_YZ
        assert chunk % _cuda.MMA_K_ALIGN == 0

    for side, c in BENCH_ROWS:
        rows, cq = n * side * side, c // 4
        assert 9 * rows * 64 < 2 ** 31 and rows * c < 2 ** 31
        for ci, co in ((c, cq), (cq, c)):
            plan, ws, part, _, _ = tfu.mm_fwd_buffers(rows, ci, co, True,
                                                      meta, f32)
            grid_ok(plan, rows, co)
            scratch += [ws, part]
            dplan, wplan, part, _, _, dws, dw, wpart = tfu.mm_bwd_buffers(
                rows, ci, co, meta, f32)
            grid_ok(dplan, rows, ci)
            grid_ok(wplan, co, ci)
            scratch += [part, dws, wpart]
        plan, ws, part, _, _ = tfu.c3_fwd2d_buffers(rows, cq, cq, True, meta,
                                                    f32)
        grid_ok(plan, rows, cq)
        scratch += [ws, part]
        dplan, wplan, part, _, _, dws, dw, wpart = tfu.c3_bwd2d_buffers(
            rows, cq, cq, meta, f32)
        grid_ok(dplan, rows, cq)
        grid_ok(wplan, cq, 9 * cq)
        scratch += [part, dws, wpart]
        plan, ws, part, _, _ = tfu.c3_fwd4d_buffers(n, side, side, cq, cq,
                                                    True, meta, f32)
        grid_ok(plan, rows, cq)
        assert _cuda.halo_fwd_smem(plan[0], plan[1], side, f32) \
            <= 227 * 1024
        dplan, wplan, part, _, _, dws, dw, wpart = tfu.c3_bwd4d_buffers(
            n, side, side, cq, cq, meta, f32)
        grid_ok(dplan, rows, cq)
        assert _cuda.halo_dgrad_smem(dplan[0], dplan[1], side, f32) \
            <= 227 * 1024
        assert wplan[0] <= GRID_YZ and wplan[1] % _cuda.halo_wgrad_band(
            f32) == 0
        scratch += [part, dws, wpart]
        tfu._check_index_division("bench", rows, side, side, c)
    for hw, ci, co in K8_SITES:
        rows = n * hw * hw
        dplan, wplan, dws, dw, wpart = tnn.conv1x1_bwd_buffers(
            rows, ci, co, meta, f32)
        grid_ok(dplan, rows, ci)
        grid_ok(wplan, co, ci)
        scratch += [dws, wpart]
    biggest = max(t.numel() for t in scratch if t is not None)
    assert biggest * 4 < 2 ** 30, biggest
