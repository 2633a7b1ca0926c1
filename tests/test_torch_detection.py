"""SSD's ops in the port against the JAX package: MultiBoxPrior,
MultiBoxTarget and MultiBoxDetection (``ops/contrib_det.py``), MakeLoss
and SoftmaxOutput's multi-output head (``ops/nn.py``).

Every input is drawn from seeded numpy and goes through both packages;
each JAX reference is computed once per module, jitted.  Tolerances:

- MultiBoxPrior: atol 1e-6 (both compute the same float32 expressions).
- MultiBoxTarget: ``cls_target`` and ``loc_mask`` equal, ``loc_target``
  within atol 1e-5.  Hard-negative mining ranks anchors by their largest
  non-background probability, and the two packages' softmaxes differ in
  the last bits, so near ties could flip between them: the inputs keep
  those probabilities at least MIN_SCORE_GAP apart (checked below).
- MultiBoxDetection: kept class ids equal, scores and boxes within atol
  1e-6.
- MakeLoss and SoftmaxOutput: gradients within atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.models.ssd import _DEFAULT_RATIOS, _DEFAULT_SIZES
from mxnet_tpu.ops.registry import invoke_jax
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import invoke

# the ops this file holds against the JAX package
OPS = {"_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
       "_contrib_MultiBoxDetection", "MakeLoss"}

PRIOR_ATOL = 1e-6
LOC_ATOL = 1e-5
DET_ATOL = 1e-6
GRAD_ATOL = 1e-6
MIN_SCORE_GAP = 1e-5

# B samples, A anchors, G label rows (the last sample has none), C classes
B, A, G, C = 4, 120, 5, 6
# the example's six scales at 300x300: (feature side, sizes, ratios)
SCALES = list(zip((38, 19, 10, 5, 3, 2), _DEFAULT_SIZES, _DEFAULT_RATIOS))
TARGET_CASES = {
    "no mining": {"overlap_threshold": 0.5},
    "mining": {"overlap_threshold": 0.5, "negative_mining_ratio": 3.0,
               "negative_mining_thresh": 0.5},
    "mining, minimum 20, no threshold matching": {
        "overlap_threshold": 0.0, "negative_mining_ratio": 2.0,
        "minimum_negative_samples": 20},
}
DETECT_CASES = {
    "per class, every anchor": {"nms_threshold": 0.45, "nms_topk": -1},
    "per class, top 40": {"nms_threshold": 0.45, "nms_topk": 40},
    "forced, every anchor": {"nms_threshold": 0.45, "nms_topk": -1,
                             "force_suppress": True},
    "forced, top 40": {"nms_threshold": 0.45, "nms_topk": 40,
                       "force_suppress": True, "threshold": 0.2},
}


def _boxes(rng, n, lo=0.05, hi=0.45):
    xy = rng.uniform(0.0, 0.6, (n, 2))
    wh = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def det_inputs():
    rng = np.random.default_rng(0)
    anchors = _boxes(rng, A)[None]
    labels = np.full((B, G, 5), -1.0, np.float32)
    for b in range(B - 1):
        n = b + 2
        labels[b, :n, 0] = rng.integers(0, C - 1, n)
        labels[b, :n, 1:] = _boxes(rng, n, 0.1, 0.4)
    cls_pred = rng.standard_normal((B, C, A)).astype(np.float32) * 2.0
    prob = torch.softmax(torch.from_numpy(cls_pred), 1).numpy()
    fg = np.sort(prob[:, 1:].max(axis=1), axis=1)
    assert np.diff(fg, axis=1).min() >= MIN_SCORE_GAP
    loc = (rng.standard_normal((B, A * 4)) * 0.5).astype(np.float32)
    return anchors, labels, cls_pred, prob, loc


def _jit(name, attrs, *arrays):
    out = jax.jit(lambda *xs: invoke_jax(name, attrs, *xs))(*arrays)
    return [np.asarray(o) for o in out]


def _port(name, attrs, *arrays):
    return [o.numpy() for o in invoke(name, attrs,
                                      *map(torch.from_numpy, arrays))]


@pytest.fixture(scope="module")
def target_refs(det_inputs):
    anchors, labels, cls_pred, _, _ = det_inputs
    return {k: _jit("_contrib_MultiBoxTarget", a, anchors, labels, cls_pred)
            for k, a in TARGET_CASES.items()}


@pytest.fixture(scope="module")
def detect_refs(det_inputs):
    anchors, _, _, prob, loc = det_inputs
    return {k: _jit("_contrib_MultiBoxDetection", a, prob, loc, anchors)[0]
            for k, a in DETECT_CASES.items()}


@pytest.mark.parametrize("side,sizes,ratios", SCALES)
def test_multibox_prior_matches_jax(side, sizes, ratios):
    data = np.zeros((1, 8, side, side), np.float32)
    attrs = {"sizes": sizes, "ratios": ratios}
    want = _jit("_contrib_MultiBoxPrior", attrs, data)[0]
    got = _port("_contrib_MultiBoxPrior", attrs, data)[0]
    assert got.shape == (1, side * side * (len(sizes) + len(ratios) - 1), 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRIOR_ATOL)


def test_multibox_prior_clip_steps_offsets_match_jax():
    data = np.zeros((1, 3, 4, 6), np.float32)
    attrs = {"sizes": (0.9, 0.4), "ratios": (1.0, 3.0), "clip": True,
             "steps": (0.3, 0.2), "offsets": (0.25, 0.75)}
    np.testing.assert_allclose(
        _port("_contrib_MultiBoxPrior", attrs, data)[0],
        _jit("_contrib_MultiBoxPrior", attrs, data)[0],
        rtol=0, atol=PRIOR_ATOL)


@pytest.mark.parametrize("case", list(TARGET_CASES))
def test_multibox_target_matches_jax(det_inputs, target_refs, case):
    anchors, labels, cls_pred, _, _ = det_inputs
    loc_t, loc_m, cls_t = _port("_contrib_MultiBoxTarget",
                                TARGET_CASES[case], anchors, labels, cls_pred)
    want_t, want_m, want_c = target_refs[case]
    np.testing.assert_array_equal(cls_t, want_c)
    np.testing.assert_array_equal(loc_m, want_m)
    np.testing.assert_allclose(loc_t, want_t, rtol=0, atol=LOC_ATOL)
    # every sample with boxes has positives; the one without has none
    assert (cls_t[:-1] > 0).any(axis=1).all() and not (cls_t[-1] > 0).any()
    if "negative_mining_ratio" in TARGET_CASES[case]:
        assert (cls_t == -1).any() and (cls_t == 0).any()


@pytest.mark.parametrize("case", list(DETECT_CASES))
def test_multibox_detection_matches_jax(det_inputs, detect_refs, case):
    anchors, _, _, prob, loc = det_inputs
    got = _port("_contrib_MultiBoxDetection", DETECT_CASES[case], prob, loc,
                anchors)[0]
    want = detect_refs[case]
    assert got.shape == (B, A, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=0,
                               atol=DET_ATOL)
    kept = got[..., 0] >= 0
    assert 0 < kept.sum() < kept.size


def test_multibox_detection_refuses_another_background_id(det_inputs):
    anchors, _, _, prob, loc = det_inputs
    with pytest.raises(MXNetError, match="background_id"):
        _port("_contrib_MultiBoxDetection", {"background_id": 1}, prob, loc,
              anchors)


def _jax_grad(name, attrs, x, *rest):
    def f(x):
        return invoke_jax(name, attrs, x, *map(jnp.asarray, rest))[0]
    out, vjp = jax.vjp(f, jnp.asarray(x))
    # a head gradient the loss layers must ignore
    return np.asarray(out), np.asarray(vjp(jnp.full(out.shape, 7.0))[0])


def _port_grad(name, attrs, x, *rest):
    t = torch.from_numpy(x).requires_grad_()
    out = invoke(name, attrs, t, *map(torch.from_numpy, rest),
                 training=True)[0]
    out.backward(torch.full(out.shape, 7.0))
    return out.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_make_loss_gradient_matches_jax(normalization):
    x = np.random.default_rng(1).standard_normal((4, 30)).astype(np.float32)
    attrs = {"grad_scale": 2.5, "normalization": normalization}
    out, grad = _port_grad("MakeLoss", attrs, x)
    want_out, want_grad = _jax_grad("MakeLoss", attrs, x)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=GRAD_ATOL)


def test_softmax_output_multi_output_ignore_valid_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, C, 50)).astype(np.float32)
    label = rng.integers(-1, C, (3, 50)).astype(np.float32)
    assert (label == -1).any()
    attrs = {"multi_output": True, "use_ignore": True, "ignore_label": -1,
             "normalization": "valid"}
    out, grad = _port_grad("SoftmaxOutput", attrs, x, label)
    want_out, want_grad = _jax_grad("SoftmaxOutput", attrs, x, label)
    np.testing.assert_allclose(out, want_out, rtol=0, atol=GRAD_ATOL)
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=GRAD_ATOL)
    assert not grad.transpose(0, 2, 1)[label == -1].any()
