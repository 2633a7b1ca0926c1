"""Training-step telemetry in the port against the JAX package, on the
CPU: ``Module.fit`` (the StepTimer's phases, the executor's dispatch and
program-build counters, the io batch histogram), run in both packages on
the same data and weights, each package on a fresh registry of its own.
Plain SGD and no Monitor: each program the JAX package compiles costs
the file time (Gluon's counterpart is ``test_torch_train_telemetry.py``,
Monitor's ``test_torch_monitor_telemetry.py``).

The registries must hold the same families with the same label sets,
and the same counts (steps, phase observations, dispatches, batches,
builds); times differ.  ``peak_flops_for`` and ``device_memory_peak``
are the port's own (Hopper names, torch's allocator).
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.models as jax_models
from mxnet_tpu import telemetry as jt
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.telemetry.devicemem import device_memory_peak

torch.set_num_threads(1)

BATCH, N, EPOCHS = 16, 32, 1
STEPS = EPOCHS * N // BATCH
_GENERATIONS = itertools.count(10 ** 6)


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


@pytest.fixture(scope="module")
def lenet():
    with mx.base.NameManager(), mt.base.NameManager():
        jsym, tsym = jax_models.get_lenet(), mt.models.get_lenet()
    rng = np.random.default_rng(1)
    x = rng.random((N, 1, 28, 28), dtype=np.float32) - 0.5
    y = rng.integers(0, 10, N).astype(np.float32)
    shapes, _, _ = tsym.infer_shape(data=(BATCH, 1, 28, 28))
    args = {n: (rng.uniform(-0.1, 0.1, s) if n.endswith("_weight")
                else np.zeros(s)).astype(np.float32)
            for n, s in zip(tsym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    return jsym, tsym, args, x, y


def _fit(pkg, sym, args, x, y):
    mod = pkg.mod.Module(sym, context=pkg.cpu())
    mod.fit(pkg.io.NDArrayIter(x, y, BATCH, label_name="softmax_label"),
            num_epoch=EPOCHS, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05},
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_registers_the_reference_series(fresh, lenet):
    jreg, treg = fresh
    jsym, tsym, args, x, y = lenet
    _fit(mx, jsym, args, x, y)
    _fit(mt, tsym, args, x, y)
    jc, tc = _counts(jreg), _counts(treg)
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert sorted(tc[name]) == sorted(jc[name]), name
    for name in ("mxnet_train_steps_total", "mxnet_train_step_seconds",
                 "mxnet_train_step_phase_seconds",
                 "mxnet_train_step_compiles_total",
                 "mxnet_executor_dispatch_total",
                 "mxnet_io_batch_latency_ms", "mxnet_xla_traces_total",
                 "mxnet_train_step_flops"):
        assert tc[name] == jc[name], name
    fit = (("loop", "fit"),)
    assert tc["mxnet_train_steps_total"][fit] == STEPS
    phases = {dict(k)["phase"]: v for k, v in
              tc["mxnet_train_step_phase_seconds"].items()}
    assert phases == dict.fromkeys(
        ("data_wait", "h2d", "fwd_bwd", "optimizer", "metric"), STEPS)


def test_fit_parameters_do_not_depend_on_telemetry(fresh, lenet):
    _jreg, treg = fresh
    _jsym, tsym, args, x, y = lenet
    tt.set_enabled(False)
    try:
        off = _fit(mt, tsym, args, x, y)
        calls = treg.instrument_calls()
    finally:
        tt.set_enabled(None)
    assert calls == 0 and treg.collect() == {}
    on = _fit(mt, tsym, args, x, y)
    assert treg.instrument_calls() > 0
    for k in off:
        assert np.array_equal(on[k], off[k]), k


def test_peak_flops_by_card_name():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB",
                 "NVIDIA H200"):
        assert tt.peak_flops_for(name) == 989e12
    for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA H200 NVL",
                 "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        assert tt.peak_flops_for(name) is None
    assert tt.peak_flops_for(torch.device("cpu")) is None
    assert tt.peak_flops_for(mt.cpu()) is None


def test_device_memory_peak_on_the_cpu_is_none():
    assert device_memory_peak(torch.device("cpu")) is None
    assert device_memory_peak(mt.cpu()) is None
    assert device_memory_peak("cpu") is None
