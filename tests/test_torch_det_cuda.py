"""SSD's path on the card against its own CPU run: MultiBoxTarget and
MultiBoxDetection at the example's 8040 anchors, and one training step
of the ``testnet`` graph through the Executor.

The tests need a CUDA card and skip where there is none.  This file
imports neither JAX nor the JAX package, so on a machine without JAX it
runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_det_cuda.py -q

TF32 is off, so both sides compute in float32.  Mining ranks anchors by
their largest non-background probability, which the card's softmax
rounds in other bits than the CPU's: the inputs keep those
probabilities at least 1e-5 apart (checked), so no anchor flips.
Tolerances: loc_target and detections within 1e-5, gradients within
1e-4 relative L2.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.ssd import _DEFAULT_RATIOS, _DEFAULT_SIZES
from mxnet_tpu_torch.ops.registry import invoke

ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _vgg_anchors():
    """The example's anchors at 300x300: its six feature sides, sizes
    and ratios."""
    return torch.cat([
        invoke("_contrib_MultiBoxPrior", {"sizes": sizes, "ratios": ratios},
               torch.zeros(1, 1, side, side))[0]
        for side, sizes, ratios in zip((38, 19, 10, 5, 3, 2),
                                       _DEFAULT_SIZES, _DEFAULT_RATIOS)],
        dim=1)


def _inputs(n_anchors, batch=8, classes=21, pad=24):
    rng = np.random.default_rng(0)
    labels = np.full((batch, pad, 5), -1.0, np.float32)
    for b in range(batch):
        n = 1 + b % 8
        xy = rng.uniform(0.0, 0.6, (n, 2))
        labels[b, :n, 0] = rng.integers(0, classes - 1, n)
        labels[b, :n, 1:] = np.concatenate(
            [xy, xy + rng.uniform(0.1, 0.4, (n, 2))], axis=1)
    # one foreground logit an anchor, spread evenly over [-3, 3] in a
    # random order, the others far below: distinct largest probabilities
    cls_pred = np.full((batch, classes, n_anchors), -10.0, np.float32)
    cls_pred[:, 0] = 0.0
    anchor = np.arange(n_anchors)
    for b in range(batch):
        cls_pred[b, 1 + anchor % (classes - 1), anchor] = rng.permutation(
            np.linspace(-3.0, 3.0, n_anchors))
    loc = rng.standard_normal((batch, n_anchors * 4)) * 0.5
    return (torch.from_numpy(labels), torch.from_numpy(cls_pred),
            torch.from_numpy(loc.astype(np.float32)))


@pytest.mark.cuda
def test_multibox_ops_on_card_match_cpu(cuda_device):
    anchors = _vgg_anchors()
    assert anchors.shape == (1, 8040, 4)
    labels, cls_pred, loc = _inputs(anchors.shape[1])
    prob = torch.softmax(cls_pred, dim=1)
    fg = prob[:, 1:].amax(dim=1).sort(dim=1).values
    assert (fg[:, 1:] - fg[:, :-1]).min() >= 1e-5
    attrs = {"negative_mining_ratio": 3.0, "overlap_threshold": 0.5}
    cpu = invoke("_contrib_MultiBoxTarget", attrs, anchors, labels, cls_pred)
    card = [o.cpu() for o in invoke(
        "_contrib_MultiBoxTarget", attrs, anchors.to(cuda_device),
        labels.to(cuda_device), cls_pred.to(cuda_device))]
    assert torch.equal(card[2], cpu[2]) and torch.equal(card[1], cpu[1])
    assert (card[0] - cpu[0]).abs().max() <= ATOL
    for force in (False, True):
        attrs = {"nms_topk": 400, "nms_threshold": 0.45,
                 "force_suppress": force}
        want = invoke("_contrib_MultiBoxDetection", attrs, prob, loc,
                      anchors)[0]
        got = invoke("_contrib_MultiBoxDetection", attrs,
                     prob.to(cuda_device), loc.to(cuda_device),
                     anchors.to(cuda_device))[0].cpu()
        assert torch.equal(got[..., 0], want[..., 0])
        assert (got[..., 1:] - want[..., 1:]).abs().max() <= ATOL
        assert (got[..., 0] >= 0).any()


def _step(sym, args, ctx):
    with mt.cpu():
        arrays = {k: mt.nd.array(v, ctx=ctx) for k, v in args.items()}
    req = {n: "null" if n in ("data", "label") else "write"
           for n in sym.list_arguments()}
    ex = sym.bind(ctx, args=arrays, grad_req=req)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward()
    return outs, {k: ex.grad_dict[k].asnumpy() for k in req
                  if req[k] == "write"}


@pytest.mark.cuda
def test_ssd_testnet_step_on_card_matches_cpu(cuda_device):
    sym = mt.models.get_ssd_symbol("testnet", num_classes=3, mode="train")
    shapes = {"data": (4, 3, 64, 64), "label": (4, 4, 5)}
    args, _ = mt.convert.random_params(sym, shapes, seed=0)
    rng = np.random.default_rng(1)
    args["data"] = rng.uniform(-1, 1, shapes["data"]).astype(np.float32)
    label = np.full(shapes["label"], -1.0, np.float32)
    label[:, 0] = [1, 0.1, 0.2, 0.6, 0.7]
    label[::2, 1] = [2, 0.5, 0.4, 0.95, 0.9]
    args["label"] = label
    cpu_outs, cpu_grads = _step(sym, args, mt.cpu())
    card_outs, card_grads = _step(sym, args, mt.gpu(0))
    np.testing.assert_array_equal(card_outs[2], cpu_outs[2])
    for got, want in zip(card_outs[:2], cpu_outs[:2]):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    num = sum(float(((card_grads[k] - cpu_grads[k]).astype(np.float64) ** 2)
                    .sum()) for k in cpu_grads)
    den = sum(float((cpu_grads[k].astype(np.float64) ** 2).sum())
              for k in cpu_grads)
    assert (num / den) ** 0.5 <= GRAD_RTOL
