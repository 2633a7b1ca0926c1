"""Training telemetry outside ``Module.fit``, on the CPU: Gluon's
``Trainer.step``, ``DataLoader`` and a hybridized block's ``CachedOp`` in
the port against the JAX package (each package on a fresh registry of
its own: the same families, label sets and counts; times differ).
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jt
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt

torch.set_num_threads(1)

_GENERATIONS = itertools.count(3 * 10 ** 6)


@pytest.fixture
def fresh(monkeypatch):
    """Point each package's telemetry at a fresh registry (a generation
    no memoized instrument child has seen), with alert rules off so no
    watchdog rule lands in either package's process-wide manager, and
    with throwaway heartbeat and default-timer tables: fit timers are
    never closed, and a ``train.<loop>`` heartbeat left behind would
    show in a later test's leak gate in the same worker."""
    monkeypatch.setenv("MXNET_TELEMETRY_ALERTS", "0")
    regs = {}
    for pkg in (jt, tt):
        reg = pkg.Registry()
        reg.generation = next(_GENERATIONS)
        monkeypatch.setattr(pkg, "_REGISTRY", reg)
        regs[pkg] = reg
        rec = importlib.import_module(pkg.__name__ + ".recorder")
        stp = importlib.import_module(pkg.__name__ + ".step")
        monkeypatch.setattr(rec, "_HEARTBEATS", {})
        monkeypatch.setattr(stp, "_HB_LOOPS", {})
        monkeypatch.setattr(stp, "_DEFAULT", {})
    yield regs[jt], regs[tt]


def _counts(reg):
    """{family: {label tuple: (value or observation count)}}."""
    out = {}
    for name, fam in reg.collect().items():
        out[name] = {tuple(sorted(s["labels"].items())):
                     s["count"] if fam["kind"] == "histogram"
                     else s["value"] for s in fam["series"]}
    return out


def _gluon(pkg, w, x, y):
    """Two epochs of a hybridized Dense block fed by a DataLoader,
    stepped by a Trainer outside any fit loop."""
    gluon = pkg.gluon
    net = gluon.nn.Dense(3, in_units=6, prefix="dense_")
    net.initialize(ctx=pkg.cpu())
    net.weight.set_data(pkg.nd.array(w, ctx=pkg.cpu()))
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(x, y), batch_size=4)
    with pkg.cpu():
        for _ in range(2):
            for xb, yb in loader:
                with pkg.autograd.record():
                    loss = loss_fn(net(xb), yb)
                loss.backward()
                trainer.step(4)
    return net.weight.data().asnumpy()


def test_gluon_trainer_dataloader_and_cached_op(fresh):
    jreg, treg = fresh
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 6)).astype(np.float32)
    x = rng.standard_normal((12, 6)).astype(np.float32)
    y = rng.integers(0, 3, 12).astype(np.float32)
    jw = _gluon(mx, w, x, y)
    tw = _gluon(mt, w, x, y)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
    jc, tc = _counts(jreg), _counts(treg)
    assert sorted(tc) == sorted(jc)
    for name in ("mxnet_train_steps_total", "mxnet_train_step_seconds",
                 "mxnet_train_step_phase_seconds",
                 "mxnet_io_batch_latency_ms"):
        assert tc[name] == jc[name], name
    assert tc["mxnet_train_steps_total"] == {(("loop", "trainer"),): 6}
    assert tc["mxnet_io_batch_latency_ms"] == {
        (("iter", "DataLoader"),): 6}
    assert sorted(tc["mxnet_xla_traces_total"]) == \
        sorted(jc["mxnet_xla_traces_total"])
