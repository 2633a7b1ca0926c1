"""The port's ``Updater`` state round trip: ``get_states`` then
``set_states`` on the host, into a run that continues as the uninterrupted
one does, with tuple states and the optimizer itself carried too, and
states written by the JAX package's ``Updater`` loaded by the port's."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)


def _arrays(seed=3):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32)
             for _ in range(4)]
    return w, grads


def _host(a):
    return mt.nd.array(a, ctx=mt.cpu())


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("dump_optimizer", [False, True],
                         ids=["states", "states-and-optimizer"])
def test_sgd_momentum_round_trip_continues_the_run(no_card, dump_optimizer):
    """Two steps, get_states, set_states into a fresh updater, two more
    steps: the same bits as four steps without the round trip."""
    w0, grads = _arrays()
    whole = _host(w0)
    u = mt.optimizer.get_updater(mt.optimizer.SGD(**SGD))
    for g in grads:
        u(0, _host(g), whole)
    part = _host(w0)
    first = mt.optimizer.get_updater(mt.optimizer.SGD(**SGD))
    for g in grads[:2]:
        first(0, _host(g), part)
    blob = first.get_states(dump_optimizer=dump_optimizer)
    second = mt.optimizer.get_updater(
        mt.optimizer.SGD(learning_rate=0.5) if dump_optimizer
        else mt.optimizer.SGD(**SGD))
    second.set_states(blob)
    assert second.states[0].context == mt.cpu()
    if dump_optimizer:
        assert second.optimizer.momentum == SGD["momentum"]
        assert second.optimizer.lr == SGD["learning_rate"]
    for g in grads[2:]:
        second(0, _host(g), part)
    np.testing.assert_array_equal(part.asnumpy(), whole.asnumpy())
    np.testing.assert_array_equal(second.states[0].asnumpy(),
                                  u.states[0].asnumpy())


def test_tuple_and_list_states_load_on_the_host(no_card):
    """A state that is a tuple or list of arrays (the reference's to_nd
    recursion, which Adam-style optimizers need) loads leaf by leaf onto
    the host and writes back the same values."""
    a, b = np.arange(3, dtype=np.float32), np.ones((2, 2), np.float32)
    u = mt.optimizer.get_updater(mt.optimizer.SGD(**SGD))
    u.set_states(pickle.dumps({0: (a, [b, None]), 1: None}))
    s0 = u.states[0]
    assert isinstance(s0, tuple) and isinstance(s0[1], list)
    assert s0[0].context == s0[1][0].context == mt.cpu()
    assert s0[1][1] is None and u.states[1] is None
    back = pickle.loads(u.get_states())
    np.testing.assert_array_equal(back[0][0], a)
    np.testing.assert_array_equal(back[0][1][0], b)


def test_updates_leave_the_numpy_source_alone(no_card):
    """``nd.array`` copies, as the reference's does: an update written in
    place into the weight (``out=weight``) leaves the numpy array it was
    made from, and an NDArray made from that weight, unchanged."""
    w0, grads = _arrays()
    keep = w0.copy()
    w = mt.nd.array(w0, ctx=mt.cpu())
    twin = mt.nd.array(w, ctx=mt.cpu())
    u = mt.optimizer.get_updater(mt.optimizer.SGD(**SGD))
    u(0, _host(grads[0]), w)
    u(0, _host(grads[1]), twin)
    np.testing.assert_array_equal(w0, keep)
    assert not np.array_equal(w.asnumpy(), keep)
    assert not np.array_equal(twin.asnumpy(), w.asnumpy())


def test_states_of_the_jax_package_load_and_continue(no_card):
    """The JAX package's SGD momentum states after two steps, loaded by
    the port's set_states, continue the run as the JAX package does."""
    w0, grads = _arrays(5)
    ju = mx.optimizer.get_updater(mx.optimizer.SGD(**SGD))
    jw = mx.nd.array(w0)
    for g in grads:
        ju(0, mx.nd.array(g), jw)
    jw2 = mx.nd.array(w0)
    ju2 = mx.optimizer.get_updater(mx.optimizer.SGD(**SGD))
    for g in grads[:2]:
        ju2(0, mx.nd.array(g), jw2)
    u = mt.optimizer.get_updater(mt.optimizer.SGD(**SGD))
    u.set_states(ju2.get_states())
    w = _host(jw2.asnumpy())
    for g in grads[2:]:
        u(0, _host(g), w)
    np.testing.assert_allclose(w.asnumpy(), jw.asnumpy(), rtol=1e-6,
                               atol=1e-7)
