"""Monitor's telemetry in the port against the JAX package, on the CPU: a
small fully connected ``Module.fit`` with a ``Monitor`` installed, in
both packages on the same data and weights, each package on a fresh
registry of its own.  The ``mxnet_monitor_tensor_stat`` gauges must
carry the same label sets and the same values (the statistic of the same
tensor), and ``Monitor.close()`` must reclaim them.
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

BATCH, N = 4, 8
STEPS = N // BATCH
_GENERATIONS = itertools.count(5 * 10 ** 6)


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


def _gauges(reg):
    """{label tuple: value} of the monitor's gauge family."""
    fam = reg.collect().get("mxnet_monitor_tensor_stat") or {"series": ()}
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in fam["series"]}


def _fit(pkg, w, x, y, monitor):
    data = pkg.sym.Variable("data")
    fc = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
    sym = pkg.sym.SoftmaxOutput(fc, name="softmax")
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(x, y, BATCH, label_name="softmax_label"),
            num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1}, monitor=monitor,
            arg_params={"fc_weight": pkg.nd.array(w, ctx=pkg.cpu()),
                        "fc_bias": pkg.nd.zeros((3,), ctx=pkg.cpu())})


def test_monitor_gauges_match_the_reference_and_are_reclaimed(fresh):
    jreg, treg = fresh
    rng = np.random.default_rng(7)
    w = rng.standard_normal((3, 6)).astype(np.float32)
    x = rng.standard_normal((N, 6)).astype(np.float32)
    y = rng.integers(0, 3, N).astype(np.float32)
    jmon = mx.Monitor(STEPS, pattern=".*_output")
    tmon = mt.Monitor(STEPS, pattern=".*_output")
    _fit(mx, w, x, y, jmon)
    _fit(mt, w, x, y, tmon)
    jg, tg = _gauges(jreg), _gauges(treg)
    assert tg and sorted(tg) == sorted(jg)
    for key in jg:
        np.testing.assert_allclose(tg[key], jg[key], rtol=1e-5, atol=1e-6)
    jmon.close()
    tmon.close()
    assert _gauges(treg) == {} == _gauges(jreg)
