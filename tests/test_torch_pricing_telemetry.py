"""Which graphs the port's telemetry prices, on the CPU: a graph holding a
contraction that ``analysis.flops`` has no rule for (the fused ResNet
units) is left unpriced by the serving FLOPs ledger and by the fit's
MFU; the plain graph of the same model is priced at ``count_flops``.
Port only: the JAX package prices the fused graph at the default rule's
count.
"""
import itertools

import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.telemetry import goodput, step

torch.set_num_threads(1)

_GENERATIONS = itertools.count(6 * 10 ** 6)


@pytest.fixture
def fresh(monkeypatch):
    """A fresh registry for the port's telemetry (a generation no
    memoized instrument child has seen), with alert rules off."""
    monkeypatch.setenv("MXNET_TELEMETRY_ALERTS", "0")
    reg = tt.Registry()
    reg.generation = next(_GENERATIONS)
    monkeypatch.setattr(tt, "_REGISTRY", reg)
    yield reg


def _counts(reg):
    """{family: {label tuple: (value or observation count)}}."""
    out = {}
    for name, fam in reg.collect().items():
        out[name] = {tuple(sorted(s["labels"].items())):
                     s["count"] if fam["kind"] == "histogram"
                     else s["value"] for s in fam["series"]}
    return out


def test_fused_contractions_leave_a_graph_unpriced(fresh):
    """The fused ResNet-50's units fall to ``count_flops``'s default rule
    (one FLOP per output element, a third of the step's FLOPs counted),
    so neither the serving ledger nor the fit's MFU prices it; the plain
    graph of the same model is priced at ``count_flops``."""
    treg = fresh
    kw = dict(num_classes=10, num_layers=50, image_shape=(3, 32, 32),
              layout="NHWC")
    data, label = ("data", (2, 32, 32, 3)), ("softmax_label", (2,))
    fused = mt.models.get_resnet_symbol(unit_impl="fused", **kw)
    plain = mt.models.get_resnet_symbol(**kw)
    assert "_contrib_FusedBottleneckUnit" in goodput.UNPRICED_OPS
    assert goodput.price_graph(fused, dict([data])) is None
    assert goodput.price_graph(plain, dict([data])) == int(round(
        mt.analysis.count_flops(plain, dict([data]))["total"]))
    want = mt.analysis.count_flops(plain, dict([data, label]),
                                   training=True)["total"]
    for sym, flops in ((fused, 0.0), (plain, want)):
        timer = step.fit_timer(sym, [data], [label], loop="unpriced",
                               device=torch.device("cpu"))
        try:
            assert timer.flops_per_step == flops
        finally:
            timer.close()
    fams = _counts(treg)
    assert fams["mxnet_train_step_flops"] == {}
    assert fams["mxnet_train_mfu"] == {}


def test_an_unpriced_fit_resets_its_labels_gauges(fresh):
    """Fits on one loop label share its FLOPs and MFU gauges, and the fit
    default is never closed: a later fit of the fused graph publishes 0,
    not the FLOPs and MFU of an earlier priced fit on the label."""
    treg = fresh
    kw = dict(num_classes=10, num_layers=50, image_shape=(3, 32, 32),
              layout="NHWC")
    data, label = ("data", (2, 32, 32, 3)), ("softmax_label", (2,))
    priced = step.StepTimer(loop="shared", flops_per_step=5e9,
                            peak_flops=1e12, device=torch.device("cpu"))
    with priced.step():
        pass
    key = (("loop", "shared"),)
    fams = _counts(treg)
    assert fams["mxnet_train_step_flops"][key] == 5e9
    assert fams["mxnet_train_mfu"][key] > 0
    fused = mt.models.get_resnet_symbol(unit_impl="fused", **kw)
    timer = step.fit_timer(fused, [data], [label], loop="shared",
                           device=torch.device("cpu"))
    try:
        fams = _counts(treg)
        assert timer.flops_per_step == 0.0
        assert fams["mxnet_train_step_flops"][key] == 0.0
        assert fams["mxnet_train_mfu"][key] == 0.0
    finally:
        timer.close()
        priced.close()
