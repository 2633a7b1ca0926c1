"""The ops, NDArray methods and autograd additions that Gluon needs, in
the PyTorch port against the JAX package.

Every op the port registers beyond the 45 it had before Gluon is run on
the same seeded numpy inputs through both registries' implementations
(``get_op(name).bound(attrs, training)``) and, where it is
differentiable, its vector-Jacobian product with the same seeded
cotangent (``jax.vjp`` against torch's autograd).  Tolerance: 1e-5
relative and 1e-6 absolute in float32 (the transcendental functions of
XLA and torch round differently by an ulp or two; the sums of dot,
Deconvolution and the reductions are taken in another order); data
movement, integer results and logic bit for bit.  Dropout draws from
torch's generator, so it is held by its own contract (kept share, scale,
identity outside training) rather than against JAX's stream.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6

# the port's registry before Gluon (PR 11's tree)
OLD_OPS = {
    "Activation", "BatchNorm", "Convolution", "Embedding", "Flatten",
    "FullyConnected", "Pad", "Pooling", "Reshape", "SoftmaxOutput", "_add",
    "_arange", "_cache_write_row", "_cache_write_rows",
    "_contrib_BNStemConv", "_contrib_FusedBottleneckUnit", "_div",
    "_div_scalar", "_greater_scalar", "_minus_scalar", "_mul", "_mul_scalar",
    "_plus_scalar", "_rdiv_scalar", "_rminus_scalar", "_sub", "adam_update",
    "argmax", "batch_dot", "expand_dims", "ftrl_update", "greater",
    "lesser_equal", "mp_sgd_mom_update", "mp_sgd_update", "one_hot",
    "rmsprop_update", "rmspropalex_update", "sgd_mom_update", "sgd_update",
    "signsgd_update", "signum_update", "slice_axis", "softmax", "transpose"}


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _u(rng, shape, lo=-0.9, hi=0.9):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _away(rng, shape, lo=0.2, hi=1.5):
    """Values of both signs at least ``lo`` away from zero."""
    return (_u(rng, shape, lo, hi) * rng.choice([-1.0, 1.0], shape)) \
        .astype(np.float32)


def _ints(rng, shape, lo=-2, hi=3):
    return rng.integers(lo, hi, shape).astype(np.float32)


POSITIVE = {"log", "log10", "log2", "sqrt", "rsqrt", "reciprocal", "rcbrt",
            "gammaln", "gamma"}
STEPS = {"sign", "round", "rint", "ceil", "floor", "trunc", "fix",
         "logical_not"}


def _unary(name):
    def make(rng):
        if name in POSITIVE:
            x = _u(rng, (3, 4), 0.5, 2.0)
        elif name == "arccosh":
            x = _u(rng, (3, 4), 1.1, 3.0)
        elif name in STEPS:
            x = _u(rng, (3, 4), -2.5, 2.5)
        elif name in ("relu", "abs", "cbrt"):
            x = _away(rng, (3, 4))
        else:
            x = _u(rng, (3, 4))
        return [x], {}, name not in STEPS
    return make


BINARY = ["_mod", "_power", "_maximum", "_minimum", "_hypot"]
LOGIC = ["equal", "not_equal", "greater_equal", "lesser", "logical_and",
         "logical_or", "logical_xor"]


def _binary(name):
    def make(rng):
        a = _u(rng, (2, 3, 4), 0.5, 2.0) if name == "_power" \
            else _away(rng, (2, 3, 4))
        b = _away(rng, (1, 3, 1))
        return [a, b], {}, True
    return make


def _logic(name):
    return lambda rng: ([_ints(rng, (2, 3, 4)), _ints(rng, (1, 3, 1))], {},
                        False)


SCALAR = ["_mod_scalar", "_rmod_scalar", "_power_scalar", "_rpow_scalar",
          "_maximum_scalar", "_minimum_scalar", "_hypot_scalar",
          "_scatter_plus_scalar", "_scatter_minus_scalar"]
SCALAR_LOGIC = ["_equal_scalar", "_not_equal_scalar",
                "_greater_equal_scalar", "_lesser_scalar",
                "_lesser_equal_scalar", "_logical_and_scalar",
                "_logical_or_scalar", "_logical_xor_scalar"]


def _scalar(name):
    def make(rng):
        x = _u(rng, (3, 4), 0.5, 2.0) if "pow" in name or "rmod" in name \
            else _away(rng, (3, 4))
        return [x], {"scalar": 0.7}, True
    return make


def _scalar_logic(name):
    return lambda rng: ([_ints(rng, (3, 4))], {"scalar": 1.0}, False)


REDUCE = ["sum", "mean", "prod", "nansum", "nanprod", "max", "min"]


def _reduce(name):
    return lambda rng: ([_away(rng, (2, 3, 4), 0.5, 1.5)],
                        {"axis": (1,), "keepdims": False}, True)


UNARY = ["sigmoid", "softsign", "reciprocal", "abs", "sign", "round",
           "rint", "ceil", "floor", "trunc", "fix", "square", "sqrt", "rsqrt",
           "cbrt", "rcbrt", "exp", "log", "log10", "log2", "log1p", "expm1",
           "gammaln", "erf", "erfinv", "sin", "cos", "tan", "arcsin",
           "arccos", "arctan", "degrees", "radians", "sinh", "cosh", "tanh",
           "arcsinh", "arccosh", "arctanh", "negative", "logical_not",
           "relu", "gamma"]
CASES = {}
for _n in UNARY:
    CASES[_n] = _unary(_n)
for _n in BINARY:
    CASES[_n] = _binary(_n)
for _n in LOGIC:
    CASES[_n] = _logic(_n)
for _n in SCALAR:
    CASES[_n] = _scalar(_n)
for _n in SCALAR_LOGIC:
    CASES[_n] = _scalar_logic(_n)
for _n in REDUCE:
    CASES[_n] = _reduce(_n)

CASES.update({
    "_copy": lambda r: ([_u(r, (3, 4))], {}, True),
    "BlockGrad": lambda r: ([_u(r, (3, 4))], {}, True),
    "make_loss": lambda r: ([_u(r, (3, 4))], {}, True),
    "smooth_l1": lambda r: ([_u(r, (3, 4), -3, 3)], {"scalar": 1.5}, True),
    "Cast": lambda r: ([_u(r, (3, 4), -3, 3)], {"dtype": "float16"}, False),
    "clip": lambda r: ([_u(r, (3, 4), -3, 3)], {"a_min": -1.0, "a_max": 1.5},
                       True),
    "_greater_equal_scalar": lambda r: ([_ints(r, (3, 4))], {"scalar": 1.0},
                                        False),
    "_scatter_elemwise_div": lambda r: ([_u(r, (3, 4)), _away(r, (3, 4))],
                                        {}, True),
    "add_n": lambda r: ([_u(r, (3, 4)) for _ in range(3)], {}, True),
    "_identity_with_attr_like_rhs": lambda r: ([_u(r, (3, 4)),
                                                _u(r, (3, 4))], {}, True),
    "LeakyReLU": lambda r: ([_away(r, (2, 3, 4))],
                            {"act_type": "leaky", "slope": 0.1}, True),
    "norm": lambda r: ([_u(r, (3, 4))], {"axis": (1,)}, True),
    "argmin": lambda r: ([_u(r, (3, 4))], {"axis": 1}, False),
    "argmax_channel": lambda r: ([_u(r, (3, 4))], {}, False),
    "pick": lambda r: ([_u(r, (3, 4)), _ints(r, (3,), 0, 4)],
                       {"axis": 1, "keepdims": True}, True),
    "broadcast_to": lambda r: ([_u(r, (1, 4))], {"shape": (3, 4)}, True),
    "broadcast_axis": lambda r: ([_u(r, (3, 1))], {"axis": (1,),
                                                    "size": (4,)}, True),
    "squeeze": lambda r: ([_u(r, (3, 1, 4))], {"axis": (1,)}, True),
    "SwapAxis": lambda r: ([_u(r, (2, 3, 4))], {"dim1": 0, "dim2": 2}, True),
    "reshape_like": lambda r: ([_u(r, (3, 4)), _u(r, (2, 6))], {}, True),
    "shape_array": lambda r: ([_u(r, (3, 4))], {}, False),
    "size_array": lambda r: ([_u(r, (3, 4))], {}, False),
    "slice": lambda r: ([_u(r, (4, 5))], {"begin": (1, 0), "end": (3, 5),
                                          "step": (1, 2)}, True),
    "_slice_assign": lambda r: ([_u(r, (4, 5)), _u(r, (2, 3))],
                                {"begin": (1, 0), "end": (3, 5),
                                 "step": (1, 2)}, True),
    "_slice_assign_scalar": lambda r: ([_u(r, (4, 5))],
                                       {"begin": (1, 1), "end": (3, 4),
                                        "scalar": 2.5}, True),
    "slice_like": lambda r: ([_u(r, (4, 5)), _u(r, (2, 3))], {}, True),
    "repeat": lambda r: ([_u(r, (2, 3))], {"repeats": 2, "axis": 1}, True),
    "tile": lambda r: ([_u(r, (2, 3))], {"reps": (2, 2)}, True),
    "reverse": lambda r: ([_u(r, (2, 3, 4))], {"axis": (0, 2)}, True),
    "stack": lambda r: ([_u(r, (2, 3)), _u(r, (2, 3))], {"axis": 1,
                                                          "num_args": 2},
                        True),
    "Concat": lambda r: ([_u(r, (2, 3)), _u(r, (2, 2))], {"dim": 1,
                                                           "num_args": 2},
                         True),
    "SliceChannel": lambda r: ([_u(r, (2, 4, 3))],
                               {"num_outputs": 2, "axis": 1}, True),
    "take": lambda r: ([_u(r, (5, 3)), _ints(r, (2, 2), -1, 7)], {}, True),
    "batch_take": lambda r: ([_u(r, (3, 4)), _ints(r, (3,), 0, 4)], {},
                             True),
    "gather_nd": lambda r: ([_u(r, (3, 4)),
                             np.array([[0, 2, 1], [1, 3, 0]], np.float32)],
                            {}, True),
    "scatter_nd": lambda r: ([_u(r, (3,)),
                              np.array([[0, 2, 0], [1, 3, 1]], np.float32)],
                             {"shape": (3, 4)}, True),
    "_scatter_set_nd": lambda r: ([_u(r, (3,)),
                                   np.array([[0, 2, 1], [1, 3, 0]],
                                            np.float32)],
                                  {"shape": (3, 4)}, True),
    "where": lambda r: ([_ints(r, (3, 4), 0, 2), _u(r, (3, 4)),
                         _u(r, (3, 4))], {}, True),
    "topk": lambda r: ([_u(r, (3, 5))], {"k": 2, "ret_typ": "both"}, False),
    "sort": lambda r: ([_u(r, (3, 5))], {"is_ascend": False}, True),
    "argsort": lambda r: ([_u(r, (3, 5))], {}, False),
    "_zeros": lambda r: ([], {"shape": (2, 3)}, False),
    "_ones": lambda r: ([], {"shape": (2, 3), "dtype": "float16"}, False),
    "_full": lambda r: ([], {"shape": (2, 3), "value": 2.5}, False),
    "_eye": lambda r: ([], {"N": 3, "M": 4, "k": 1}, False),
    "_constant": lambda r: ([], {"value": (1.0, 2.0, 3.5, -1.0),
                                 "shape": (2, 2)}, False),
    "zeros_like": lambda r: ([_u(r, (2, 3))], {}, False),
    "ones_like": lambda r: ([_u(r, (2, 3))], {}, False),
    "softmax_cross_entropy": lambda r: ([_u(r, (3, 5), -2, 2),
                                         _ints(r, (3,), 0, 5)], {}, True),
    "dot": lambda r: ([_u(r, (3, 4)), _u(r, (3, 5))],
                      {"transpose_a": True}, True),
    "log_softmax": lambda r: ([_u(r, (3, 5), -2, 2)], {"axis": 1}, True),
    "InstanceNorm": lambda r: ([_u(r, (2, 3, 4, 5), -2, 2),
                                _u(r, (3,), 0.5, 1.5), _u(r, (3,))],
                               {"eps": 1e-5}, True),
    "Deconvolution": lambda r: ([_u(r, (2, 3, 4, 5)), _u(r, (3, 4, 3, 3)),
                                 _u(r, (4,))],
                                {"kernel": (3, 3), "stride": (2, 2),
                                 "pad": (1, 1), "adj": (1, 0),
                                 "num_filter": 4, "no_bias": False}, True),
    "Dropout": None,
})
_ELEMWISE_NAMES = set(UNARY + BINARY + LOGIC + SCALAR + SCALAR_LOGIC) | {
    "_copy", "BlockGrad", "make_loss", "smooth_l1", "Cast", "clip",
    "_scatter_elemwise_div", "add_n", "_identity_with_attr_like_rhs",
    "LeakyReLU"}

EXTRA_CASES = {
    "LeakyReLU elu": ("LeakyReLU", lambda r: ([_away(r, (2, 3, 4))],
                                              {"act_type": "elu",
                                               "slope": 0.3}, True)),
    "LeakyReLU selu": ("LeakyReLU", lambda r: ([_away(r, (2, 3, 4))],
                                               {"act_type": "selu"}, True)),
    "LeakyReLU rrelu": ("LeakyReLU", lambda r: ([_away(r, (2, 3, 4))],
                                                {"act_type": "rrelu"}, True)),
    "LeakyReLU prelu": ("LeakyReLU", lambda r: ([_away(r, (2, 3, 4)),
                                                 _u(r, (3,))],
                                                {"act_type": "prelu"}, True)),
    "mean exclude": ("mean", lambda r: ([_u(r, (2, 3, 4))],
                                        {"axis": 0, "exclude": True}, True)),
    "sum all keepdims": ("sum", lambda r: ([_u(r, (2, 3, 4))],
                                           {"keepdims": True}, True)),
    "norm ord 1": ("norm", lambda r: ([_away(r, (3, 4))], {"ord": 1}, True)),
    "topk mask": ("topk", lambda r: ([_u(r, (3, 5))],
                                     {"k": 2, "ret_typ": "mask"}, False)),
    "topk value ascending": ("topk", lambda r: ([_u(r, (3, 5))],
                                                {"k": 3, "ret_typ": "value",
                                                 "is_ascend": True}, True)),
    "take wrap": ("take", lambda r: ([_u(r, (5, 3)), _ints(r, (4,), -6, 9)],
                                     {"mode": "wrap", "axis": 0}, True)),
    "Pooling full": ("Pooling", lambda r: ([_u(r, (2, 3, 7, 6))],
                                           {"kernel": (3, 3),
                                            "stride": (2, 2),
                                            "pooling_convention": "full"},
                                           True)),
    "Pooling avg full": ("Pooling", lambda r: ([_u(r, (2, 3, 7, 6))],
                                               {"kernel": (3, 2),
                                                "stride": (2, 2),
                                                "pad": (1, 0),
                                                "pool_type": "avg",
                                                "pooling_convention": "full"},
                                               True)),
    "Pooling sum": ("Pooling", lambda r: ([_u(r, (2, 3, 6, 6))],
                                          {"kernel": (2, 2), "stride": (2, 2),
                                           "pool_type": "sum"}, True)),
    "Deconvolution NHWC": ("Deconvolution", lambda r: (
        [_u(r, (2, 4, 5, 3)), _u(r, (3, 3, 3, 4))],
        {"kernel": (3, 3), "stride": (1, 2), "pad": (1, 1),
         "num_filter": 4, "layout": "NHWC"}, True)),
    "dot vectors": ("dot", lambda r: ([_u(r, (5,)), _u(r, (5,))], {}, True)),
    "slice negative begin": ("slice", lambda r: ([_u(r, (4, 5))],
                                                 {"begin": (-3, 1),
                                                  "end": (-1, 4)}, True)),
}


# the recurrent slice's ops, held against the JAX package in
# test_torch_rnn_op.py (and test_torch_rnn_op_*.py for the RNN's modes);
# SSD's ops are held in test_torch_detection.py (its OPS)
RNN_OPS = {"RNN", "_begin_state", "SequenceMask", "SequenceLast",
           "SequenceReverse"}


def test_every_new_op_has_a_case():
    from test_torch_rnn_op import SEQ_CASES
    from test_torch_detection import OPS as DET_OPS
    assert {op for op, _ in SEQ_CASES} | {"RNN", "_begin_state"} == RNN_OPS
    new = set(treg._REGISTRY) - OLD_OPS - RNN_OPS - DET_OPS
    assert new == set(CASES), (sorted(new - set(CASES)),
                               sorted(set(CASES) - new))
    assert set(treg._REGISTRY) <= set(jreg._REGISTRY)


def _run_both(name, inputs, attrs, grad, training=True):
    jop, top = jreg.get_op(name), treg.get_op(name)
    jattrs, tattrs = jop.normalize(dict(attrs)), top.normalize(dict(attrs))
    jfn = jop.bound(jattrs, training)
    tfn = top.bound(tattrs, training)
    jins = [jnp.asarray(a) for a in inputs]
    tins = [torch.from_numpy(a.copy()) for a in inputs]
    float_in = [i for i, a in enumerate(inputs) if name not in (
        "take", "batch_take", "pick", "gather_nd", "scatter_nd",
        "_scatter_set_nd", "softmax_cross_entropy") or i == 0]
    if name == "where":
        float_in = [1, 2]
    for i in float_in:
        tins[i].requires_grad_(True)
    with torch.set_grad_enabled(grad):
        touts = tfn(*tins)
    nvis = top.num_visible_outputs
    nvis = nvis(tattrs) if callable(nvis) else nvis
    jouts = jax.jit(jfn)(*jins)
    assert len(touts) >= nvis
    for t, j in zip(touts[:nvis], jouts[:nvis]):
        t, j = t.detach().numpy(), np.asarray(j)
        assert t.shape == j.shape, (t.shape, j.shape)
        if t.dtype.kind == "f" and t.dtype != np.float16 \
                and name not in LOGIC + SCALAR_LOGIC:
            np.testing.assert_allclose(t, j.astype(t.dtype), rtol=RTOL,
                                       atol=ATOL)
        else:
            np.testing.assert_array_equal(t, j.astype(t.dtype))
    if not grad:
        return
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal(np.asarray(j).shape).astype(np.float32)
            for j in jouts[:nvis]]

    def jf(*fl):
        full = list(jins)
        for i, v in zip(float_in, fl):
            full[i] = v
        return tuple(jfn(*full)[:nvis])
    jg = jax.jit(lambda prim, ct: jax.vjp(jf, *prim)[1](ct))(
        tuple(jins[i] for i in float_in), tuple(jnp.asarray(c) for c in cots))
    diff_outs = [(t, torch.from_numpy(c)) for t, c in zip(touts[:nvis], cots)
                 if t.requires_grad]
    if diff_outs:
        tg = torch.autograd.grad([t for t, _ in diff_outs],
                                 [tins[i] for i in float_in],
                                 [c for _, c in diff_outs],
                                 allow_unused=True)
    else:
        tg = [None] * len(float_in)
    for t, j in zip(tg, jg):
        j = np.asarray(j)
        t = np.zeros_like(j) if t is None else t.numpy()
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-5)


# the elementwise ops are held here, the rest in
# test_torch_gluon_ops_tensor.py (a file each, so that --dist loadfile
# runs them side by side)
ELEMWISE = {n for n in CASES if n in _ELEMWISE_NAMES}


@pytest.mark.parametrize("name", sorted(ELEMWISE))
def test_op_against_jax(name):
    inputs, attrs, grad = CASES[name](_rng(name))
    _run_both(name, inputs, attrs, grad)
