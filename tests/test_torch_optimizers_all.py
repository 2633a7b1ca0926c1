"""The port's optimizers and update ops against the JAX package's.

Each of the fourteen optimizers the port adds to SGD (SignSGD, Signum,
DCASGD, NAG, SGLD, ccSGD, Adam, AdaGrad, RMSProp plain and centered,
AdaDelta, Ftrl, Adamax, Nadam, Test) takes five updates of one seeded
weight in both packages, with weight decay, ``rescale_grad``,
``clip_gradient`` (which clips some of the gradients) and a learning-rate
schedule; SGLD is fed the same noise in both.  Both compute in float32 in
the same order, so the weights and states agree to 1e-6 of their largest
magnitude (XLA may fuse an expression into a fused multiply-add where
torch rounds twice).  The six update ops
(``nd.adam_update`` and the others) are held the same way, through the
imperative wrappers and the registered op; the states round-trip through
``Updater.get_states`` and continue bit for bit; states the JAX package
pickled load and continue in the port.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops.registry import invoke as port_invoke

torch.set_num_threads(1)

RTOL = 1e-6
STEPS = 5
SHAPE = (4, 6)
COMMON = dict(learning_rate=0.05, wd=1e-3, rescale_grad=0.5,
              clip_gradient=0.8)

# name -> its own hyper-parameters (beside COMMON and a scheduler)
OPTIMIZERS = {
    "signsgd": {},
    "signum": dict(momentum=0.9, wd_lh=1e-3),
    "dcasgd": dict(momentum=0.9, lamda=0.1),
    "nag": dict(momentum=0.9),
    "sgld": {},
    "ccsgd": dict(momentum=0.9),
    "adam": dict(beta1=0.8, beta2=0.95),
    "adagrad": dict(eps=1e-6),
    "rmsprop": dict(gamma1=0.8, clip_weights=2.0),
    "rmsprop-centered": dict(gamma1=0.8, gamma2=0.7, centered=True),
    "adadelta": dict(rho=0.8),
    "ftrl": dict(lamda1=0.01, beta=1.5),
    "adamax": dict(beta1=0.8, beta2=0.95),
    "nadam": dict(beta1=0.8, beta2=0.95),
    "test": {},
}


def _data(seed=11):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(SHAPE).astype(np.float32)
    grads = [(2 * rng.standard_normal(SHAPE)).astype(np.float32)
             for _ in range(STEPS)]
    noise = [(0.01 * rng.standard_normal(SHAPE)).astype(np.float32)
             for _ in range(STEPS)]
    return w, grads, noise


def _optimizer(pkg, name):
    kwargs = dict(COMMON, **OPTIMIZERS[name])
    kwargs["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(step=2,
                                                              factor=0.5)
    return pkg.optimizer.create(name.split("-")[0],
                                param_idx2name={0: "fc_weight"}, **kwargs)


@pytest.fixture
def same_noise(monkeypatch):
    """Both SGLDs draw the next array of ``noise`` (set by the test)."""
    feed = {}

    def jax_normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, **_):
        return mx.nd.array(feed["jax"].pop(0), ctx=ctx)

    def port_noise(self, weight, lr):
        return torch.from_numpy(feed["port"].pop(0))
    monkeypatch.setattr(mx.nd.random, "normal", jax_normal)
    monkeypatch.setattr(mt.optimizer.SGLD, "_noise", port_noise)
    return feed


def _states(state):
    """An optimizer state's arrays, as numpy, in order."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _states(s)]
    return [state.asnumpy()]


def _rel(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got) - want).max()) / scale


def _run(pkg, name, w, grads, ctx, updater=None, weight=None):
    updater = updater or pkg.optimizer.get_updater(_optimizer(pkg, name))
    weight = weight if weight is not None else pkg.nd.array(w, ctx=ctx)
    for g in grads:
        updater(0, pkg.nd.array(g, ctx=ctx), weight)
    return updater, weight


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_five_updates_match_jax(name, same_noise):
    w, grads, noise = _data()
    same_noise.update(jax=list(noise), port=list(noise))
    ju, jw = _run(mx, name, w, grads, mx.cpu())
    tu, tw = _run(mt, name, w, grads, mt.cpu())
    assert _rel(tw.asnumpy(), jw.asnumpy()) <= RTOL
    js, ts = _states(ju.states.get(0)), _states(tu.states.get(0))
    assert len(js) == len(ts)
    for a, b in zip(ts, js):
        assert a.dtype == b.dtype == np.float32
        assert _rel(a, b) <= RTOL
    # the clip and the schedule were in play (Test counts no updates)
    assert np.abs(np.asarray(grads) * COMMON["rescale_grad"]).max() \
        > COMMON["clip_gradient"]
    assert name == "test" \
        or tu.optimizer._get_lr(0) < COMMON["learning_rate"]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_states_round_trip_and_continue_bit_for_bit(name, same_noise):
    """Two updates, ``get_states`` (with the optimizer, whose counters and
    schedule Adam and Nadam read), ``set_states`` into a fresh updater,
    three more: the bits of five updates in one run."""
    w, grads, noise = _data()
    same_noise.update(port=list(noise) + list(noise))
    _, whole = _run(mt, name, w, grads, mt.cpu())
    first, part = _run(mt, name, w, grads[:2], mt.cpu())
    second = mt.optimizer.get_updater(_optimizer(mt, name))
    second.set_states(first.get_states(dump_optimizer=True))
    _run(mt, name, w, grads[2:], mt.cpu(), second, part)
    np.testing.assert_array_equal(part.asnumpy(), whole.asnumpy())


@pytest.mark.parametrize("name", ["adam", "rmsprop-centered", "dcasgd",
                                  "nadam", "ftrl", "signum"])
def test_states_pickled_by_jax_continue_in_the_port(name, same_noise):
    """Two updates in the JAX package, its ``get_states`` loaded into a
    fresh updater of each package, three more updates in each from the
    same weight: the port continues as the JAX package does."""
    w, grads, noise = _data()
    same_noise.update(jax=list(noise), port=list(noise[2:]))
    first, jw = _run(mx, name, w, grads[:2], mx.cpu())
    blob, w2 = first.get_states(), jw.asnumpy()
    ju = mx.optimizer.get_updater(_optimizer(mx, name))
    ju.set_states(blob)
    _run(mx, name, w, grads[2:], mx.cpu(), ju, jw)
    tu = mt.optimizer.get_updater(_optimizer(mt, name))
    tu.set_states(blob)
    _, tw = _run(mt, name, w, grads[2:], mt.cpu(), tu,
                 mt.nd.array(w2, ctx=mt.cpu()))
    assert _rel(tw.asnumpy(), jw.asnumpy()) <= RTOL
    for a, b in zip(_states(tu.states[0]), _states(ju.states[0])):
        assert _rel(a, b) <= RTOL


# the six update ops: (name, their states' kinds, hyper-parameters); a
# state starts signed ("s", 0.5 r), positive ("p", 1 + |r|) or, as
# RMSProp-centered's n, above the square of its g ("n", 4 + r^2)
UPDATE_OPS = [
    ("adam_update", "sp", dict(beta1=0.8, beta2=0.95, epsilon=1e-7)),
    ("rmsprop_update", "p", dict(gamma1=0.8, epsilon=1e-7,
                                 clip_weights=1.0)),
    ("rmspropalex_update", "nss", dict(gamma1=0.8, gamma2=0.7, epsilon=1e-7,
                                       clip_weights=1.0)),
    ("ftrl_update", "sp", dict(lamda1=0.05, beta=1.5)),
    ("signsgd_update", "", {}),
    ("signum_update", "s", dict(momentum=0.8, wd_lh=1e-2)),
]


@pytest.mark.parametrize("name,kinds,hyper", UPDATE_OPS,
                         ids=[u[0] for u in UPDATE_OPS])
def test_update_ops_match_jax(name, kinds, hyper):
    """Five calls of ``nd.<op>(weight, grad, *states, out=weight)`` in
    each package, and the registered op on the same inputs in the port:
    weight and states within RTOL, the registered op's bits equal to the
    in-place form's."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal(SHAPE).astype(np.float32)
    start = {"s": lambda r: 0.5 * r, "p": lambda r: 1 + np.abs(r),
             "n": lambda r: 4 + r * r}
    states = [start[k](rng.standard_normal(SHAPE)).astype(np.float32)
              for k in kinds]
    attrs = dict(lr=0.05, wd=1e-3, rescale_grad=0.5, clip_gradient=0.8,
                 **hyper)
    jw, tw = mx.nd.array(w), mt.nd.array(w, ctx=mt.cpu())
    js = [mx.nd.array(s) for s in states]
    ts = [mt.nd.array(s, ctx=mt.cpu()) for s in states]
    for _ in range(STEPS):
        g = (2 * rng.standard_normal(SHAPE)).astype(np.float32)
        before = [tw._data.clone()] + [s._data.clone() for s in ts]
        getattr(mx.nd, name)(jw, mx.nd.array(g), *js, out=jw, **attrs)
        getattr(mt.nd, name)(tw, mt.nd.array(g, ctx=mt.cpu()), *ts, out=tw,
                             **attrs)
        op = port_invoke(name, attrs, before[0], torch.from_numpy(g),
                         *before[1:])
        assert torch.equal(op[0], tw._data)
        for a, b in zip(op[1:], ts):
            assert torch.equal(a, b._data)
    assert _rel(tw.asnumpy(), jw.asnumpy()) <= RTOL
    for a, b in zip(ts, js):
        assert _rel(a.asnumpy(), b.asnumpy()) <= RTOL


def test_every_reference_optimizer_name_is_registered():
    """``--optimizer`` (examples/common.py) takes any name the JAX
    package registers."""
    assert set(mx.optimizer.Optimizer.opt_registry) \
        <= set(mt.optimizer.Optimizer.opt_registry)


def test_row_sparse_gradients_raise_a_named_error():
    class RowSparse:
        stype = "row_sparse"
    opt = mt.optimizer.create("adam")
    w = mt.nd.array(np.ones(SHAPE, np.float32), ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="row_sparse"):
        opt.update(0, w, RowSparse(), opt.create_state(0, w))


def test_sgld_draws_from_the_weight_devices_generator():
    """Seeded twice, SGLD's noise repeats; its spread is sqrt(lr)."""
    def draw():
        mt.random.seed(3)
        w = mt.nd.array(np.zeros((200, 200), np.float32), ctx=mt.cpu())
        return mt.optimizer.SGLD(learning_rate=0.04)._noise(w, 0.04)
    a, b = draw(), draw()
    assert torch.equal(a, b)
    assert abs(float(a.std()) - math.sqrt(0.04)) < 0.01
