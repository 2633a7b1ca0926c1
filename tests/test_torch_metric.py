"""The port's metrics against the JAX package's.

Every metric, by each of its names and aliases, takes the same seeded
labels and predictions (two batches, as NDArrays in each package) and must
give the JAX package's name and value: the metric math is numpy on the
host in both, so the values are equal to float64 rounding.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)

N, K = 12, 5


def _batches(kind, seed=2):
    """Two (labels, preds) batches as numpy, by what the metric reads."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        if kind == "binary":
            p = rng.random((N, 2)).astype(np.float32)
            out.append((rng.integers(0, 2, N).astype(np.float32),
                        p / p.sum(1, keepdims=True)))
        elif kind == "regression":
            y = rng.standard_normal(N).astype(np.float32)
            out.append((y, (y + 0.3 * rng.standard_normal(N))
                        .astype(np.float32)))
        elif kind == "sequence":
            p = rng.random((3, 4, K)).astype(np.float32)
            out.append((rng.integers(0, K, (3, 4)).astype(np.float32),
                        p / p.sum(-1, keepdims=True)))
        else:
            p = rng.random((N, K)).astype(np.float32)
            out.append((rng.integers(0, K, N).astype(np.float32),
                        p / p.sum(1, keepdims=True)))
    return out


# (name to create, constructor arguments, data kind)
CASES = [
    ("acc", {}, "class"), ("accuracy", {}, "class"),
    ("top_k_accuracy", dict(top_k=3), "class"),
    ("top_k_acc", dict(top_k=2), "class"),
    ("topkaccuracy", dict(top_k=4), "class"),
    ("f1", {}, "binary"),
    ("perplexity", dict(ignore_label=None), "sequence"),
    ("perplexity", dict(ignore_label=1), "sequence"),
    ("mae", {}, "regression"), ("mse", {}, "regression"),
    ("rmse", {}, "regression"),
    ("ce", {}, "class"), ("crossentropy", {}, "class"),
    ("nll_loss", {}, "class"), ("negativeloglikelihood", {}, "class"),
    ("pearsonr", {}, "regression"), ("pearsoncorrelation", {}, "regression"),
    ("loss", {}, "class"), ("torch", {}, "class"), ("caffe", {}, "class"),
]


def _update(pkg, metric, batches):
    for labels, preds in batches:
        metric.update([pkg.nd.array(labels, ctx=pkg.cpu())],
                      [pkg.nd.array(preds, ctx=pkg.cpu())])
    return metric.get()


@pytest.mark.parametrize("name,kwargs,kind", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_metric_matches_jax(name, kwargs, kind):
    batches = _batches(kind)
    jname, jval = _update(mx, mx.metric.create(name, **kwargs), batches)
    tname, tval = _update(mt, mt.metric.create(name, **kwargs), batches)
    assert tname == jname
    np.testing.assert_allclose(tval, jval, rtol=1e-12)


def test_composite_custom_and_np_metrics_match_jax():
    """A list of metrics, a CustomMetric from a callable, ``np`` and a
    composite's ``update_dict`` with output and label names."""
    batches = _batches("class")

    def top_prob(label, pred):
        return float(pred.max(1).sum()), pred.shape[0]

    def build(pkg):
        comp = pkg.metric.create(["acc", "ce", top_prob])
        comp.add(pkg.metric.np(lambda y, p: float((p.argmax(1) == y)
                                                  .mean()), name="np_acc"))
        return comp
    results = []
    for pkg in (mx, mt):
        comp = build(pkg)
        named = pkg.metric.CompositeEvalMetric(
            ["acc"], output_names=["softmax_output"],
            label_names=["softmax_label"])
        for labels, preds in batches:
            comp.update([pkg.nd.array(labels, ctx=pkg.cpu())],
                        [pkg.nd.array(preds, ctx=pkg.cpu())])
            named.update_dict(
                {"softmax_label": pkg.nd.array(labels, ctx=pkg.cpu()),
                 "other_label": pkg.nd.array(labels * 0, ctx=pkg.cpu())},
                {"softmax_output": pkg.nd.array(preds, ctx=pkg.cpu())})
        results.append((comp.get(), named.get(),
                        comp.get_metric(0).get_config()))
    (jc, jn, jconf), (tc, tn, tconf) = results
    assert tc[0] == jc[0] and tn[0] == jn[0] and tconf == jconf
    np.testing.assert_allclose(tc[1], jc[1], rtol=1e-12)
    np.testing.assert_allclose(tn[1], jn[1], rtol=1e-12)
