"""Detection ops (counterpart of ``mxnet_tpu/ops/contrib_det.py``):
``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget`` and
``_contrib_MultiBoxDetection``, with their ``contrib_*`` aliases.

Plain torch on whole tensors, batched over the batch axis where the JAX
package maps one sample at a time.  The sequential parts keep their
order: bipartite matching is a loop of G batched rounds (G, the label
rows), each an argmax over the masked (B, A, G) IoU, and NMS is a loop
of ``nms_topk`` batched rounds.  Ties break as in the JAX package:
``torch.argmax`` gives the first maximal index, and the sorts are
stable.  No output has a data-dependent shape, and none carries a
gradient.
"""
import torch

from .registry import register, P
from ..base import MXNetError

_BIG_NEG = -1e9


@register("_contrib_MultiBoxPrior", aliases=["contrib_MultiBoxPrior"],
          nin=1, input_names=["data"],
          params={"sizes": P("float_tuple", (1.0,)),
                  "ratios": P("float_tuple", (1.0,)),
                  "clip": P(bool, False),
                  "steps": P("float_tuple", (-1.0, -1.0)),
                  "offsets": P("float_tuple", (0.5, 0.5))})
def multibox_prior(attrs, data):
    """Anchor boxes for one (N, C, H, W) feature map: (1, H*W*A, 4)
    corners in [0, 1], A = len(sizes) + len(ratios) - 1; the sizes at
    ratio 1 first, then sizes[0] at the other ratios."""
    in_h, in_w = data.shape[2], data.shape[3]
    sizes = [float(s) for s in attrs["sizes"]]
    ratios = [float(r) for r in attrs["ratios"]]
    steps, offsets = attrs["steps"], attrs["offsets"]
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    dev = data.device
    f32 = torch.float32
    cy = (torch.arange(in_h, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(in_w, dtype=f32, device=dev) + offsets[1]) * step_x
    wh = [(s * in_h / in_w / 2.0, s / 2.0) for s in sizes]
    wh += [(sizes[0] * in_h / in_w * r ** 0.5 / 2.0, sizes[0] / r ** 0.5 / 2.0)
           for r in ratios[1:]]
    half = torch.tensor(wh, dtype=f32, device=dev)[None, None]   # (1,1,A,2)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    c = torch.stack([cxg, cyg], dim=-1)[:, :, None, :]           # (H,W,1,2)
    out = torch.cat([c - half, c + half], dim=-1).reshape(1, -1, 4)
    if attrs["clip"]:
        out = out.clamp(0.0, 1.0)
    return out.to(data.dtype)


def _iou(a, b):
    """IoU of corner boxes a (..., M, 4) against b (..., N, 4):
    (..., M, N)."""
    ax1, ay1, ax2, ay2 = (a[..., i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _centers(box):
    return (box[..., 2] - box[..., 0], box[..., 3] - box[..., 1],
            (box[..., 0] + box[..., 2]) * 0.5,
            (box[..., 1] + box[..., 3]) * 0.5)


def _encode_box(anchor, gt, variances):
    """The anchor-relative regression target of ``gt`` (the reference's
    AssignLocTargets)."""
    vx, vy, vw, vh = variances
    aw, ah, ax, ay = _centers(anchor)
    gw, gh, gx, gy = _centers(gt)
    aw = aw.clamp_min(1e-8)
    ah = ah.clamp_min(1e-8)
    return torch.stack([(gx - ax) / aw / vx, (gy - ay) / ah / vy,
                        torch.log((gw / aw).clamp_min(1e-8)) / vw,
                        torch.log((gh / ah).clamp_min(1e-8)) / vh], dim=-1)


def _decode_box(anchor, pred, variances, clip):
    """Predicted offsets -> corner boxes (TransformLocations)."""
    vx, vy, vw, vh = variances
    aw, ah, ax, ay = _centers(anchor)
    ox = pred[..., 0] * vx * aw + ax
    oy = pred[..., 1] * vy * ah + ay
    ow = torch.exp(pred[..., 2] * vw) * aw * 0.5
    oh = torch.exp(pred[..., 3] * vh) * ah * 0.5
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    return out.clamp(0.0, 1.0) if clip else out


def _match(anchors, labels, cls_pred, overlap_threshold, mining_ratio,
           mining_thresh, min_negative, variances):
    """Match anchors (A, 4) to each sample's gt rows of labels (B, G, W)
    ([cls, x1, y1, x2, y2, ...], padded with -1); cls_pred (B, C, A).
    Returns loc_target (B, A*4), loc_mask (B, A*4), cls_target (B, A)."""
    bsz, num_labels = labels.shape[:2]
    num_anchors = anchors.shape[0]
    dev = anchors.device
    valid_gt = labels[:, :, 0] >= 0                            # (B, G)
    gt_boxes = labels[:, :, 1:5]
    iou = _iou(anchors.expand(bsz, -1, -1), gt_boxes)          # (B, A, G)
    iou = torch.where(valid_gt[:, None, :], iou, torch.zeros_like(iou))

    # stage 1: greedy bipartite matching, one gt per round; invalid gt
    # slots count as matched already
    matched_gt = torch.full((bsz, num_anchors), -1, dtype=torch.long,
                            device=dev)
    anchor_pos = torch.zeros((bsz, num_anchors), dtype=torch.bool,
                             device=dev)
    gt_used = ~valid_gt
    zero = torch.zeros((), device=dev)
    rows = torch.arange(bsz, device=dev)
    for _ in range(num_labels):
        m = torch.where(anchor_pos[:, :, None] | gt_used[:, None, :],
                        zero, iou).reshape(bsz, -1)
        flat = torch.argmax(m, dim=1)
        aj, gk = flat // num_labels, flat % num_labels
        good = m[rows, flat] > 1e-6
        matched_gt[rows, aj] = torch.where(good, gk, matched_gt[rows, aj])
        anchor_pos[rows, aj] |= good
        gt_used[rows, gk] |= good

    # stage 2: threshold matching for the rest
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.amax(iou, dim=2)
    thresh_pos = (~anchor_pos) & (best_iou > overlap_threshold) \
        & (overlap_threshold > 0)
    matched_gt = torch.where(thresh_pos, best_gt, matched_gt)
    positive = anchor_pos | thresh_pos

    # stage 3: negatives, mined by the predicted max non-background
    # probability (ranked by a stable sort, as jnp.argsort), or all
    if mining_ratio > 0:
        num_pos = positive.sum(dim=1)
        max_neg = torch.minimum(
            (mining_ratio * num_pos).to(torch.int32).clamp_min(min_negative),
            num_anchors - num_pos)
        max_prob = torch.amax(torch.softmax(cls_pred, dim=1)[:, 1:, :],
                              dim=1)
        cand = (~positive) & (best_iou < mining_thresh)
        score = torch.where(cand, max_prob, torch.full_like(max_prob,
                                                            _BIG_NEG))
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(num_anchors, device=dev)
            .expand(bsz, -1).contiguous())
        negative = cand & (rank < max_neg[:, None])
    else:
        negative = ~positive

    idx = matched_gt.clamp_min(0)
    gt_cls = torch.gather(labels[:, :, 0], 1, idx)
    cls_t = torch.where(positive, gt_cls + 1.0,
                        torch.where(negative, 0.0, -1.0))
    gt = torch.gather(gt_boxes, 1, idx[:, :, None].expand(-1, -1, 4))
    loc_t = _encode_box(anchors, gt, variances)
    pos4 = positive[:, :, None].expand(-1, -1, 4)
    loc_t = torch.where(pos4, loc_t, torch.zeros_like(loc_t))
    loc_m = pos4.to(torch.float32)
    return loc_t.reshape(bsz, -1), loc_m.reshape(bsz, -1), cls_t


@register("_contrib_MultiBoxTarget", aliases=["contrib_MultiBoxTarget"],
          nin=3, nout=3, input_names=["anchor", "label", "cls_pred"],
          params={"overlap_threshold": P(float, 0.5),
                  "ignore_label": P(float, -1.0),
                  "negative_mining_ratio": P(float, -1.0),
                  "negative_mining_thresh": P(float, 0.5),
                  "minimum_negative_samples": P(int, 0),
                  "variances": P("float_tuple", (0.1, 0.1, 0.2, 0.2))})
def multibox_target(attrs, anchor, label, cls_pred):
    """Anchor-to-gt assignment: anchor (1, A, 4), label (B, G, W),
    cls_pred (B, num_classes, A) -> loc_target (B, A*4), loc_mask
    (B, A*4), cls_target (B, A)."""
    with torch.no_grad():
        outs = _match(anchor.detach().reshape(-1, 4).float(),
                      label.detach().float(), cls_pred.detach().float(),
                      attrs["overlap_threshold"],
                      attrs["negative_mining_ratio"],
                      attrs["negative_mining_thresh"],
                      attrs["minimum_negative_samples"],
                      tuple(attrs["variances"]))
    return tuple(o.to(anchor.dtype) for o in outs)


def _detect(cls_prob, loc_pred, anchors, threshold, clip, variances,
            nms_threshold, force_suppress, nms_topk):
    """Decode and greedy per-class NMS of cls_prob (B, C, A) and
    loc_pred (B, A*4) -> (B, A, 6)."""
    bsz, _, num_anchors = cls_prob.shape
    dev = cls_prob.device
    fg = cls_prob[:, 1:, :]
    score = torch.amax(fg, dim=1)
    cid = torch.argmax(fg, dim=1).to(torch.float32)
    valid = score >= threshold
    cid = torch.where(valid, cid, -1.0)
    boxes = _decode_box(anchors, loc_pred.reshape(bsz, -1, 4), variances,
                        clip)
    # by score, descending; invalid rows sink
    order = torch.argsort(torch.where(valid, -score, -_BIG_NEG), dim=1,
                          stable=True)
    cid = torch.gather(cid, 1, order)
    score = torch.gather(score, 1, order)
    boxes = torch.gather(boxes, 1, order[:, :, None].expand(-1, -1, 4))
    k = num_anchors if nms_topk <= 0 else min(nms_topk, num_anchors)
    # rows past the NMS window are dropped (id -1)
    ar = torch.arange(num_anchors, device=dev)
    keep = (ar < k)[None, :] & (cid >= 0)
    # Only rows i < k of the pairwise suppression matrix are ever read, so
    # only those are built: (B, k, A) instead of the JAX package's (A, A)
    # per sample, the same output in k/A of the memory (0.4 GB in place
    # of 8.3 GB at B 32, A 8040, nms_topk 400).
    suppress = (_iou(boxes[:, :k], boxes) > nms_threshold) \
        & (ar[:k, None] < ar[None, :])
    if not force_suppress:
        suppress &= cid[:, :k, None] == cid[:, None, :]
    cid = torch.where(nms_keep(keep, suppress), cid, -1.0)
    return torch.cat([cid[..., None], score[..., None], boxes], dim=2)


def nms_keep(keep, suppress):
    """The greedy rounds of NMS: round i, if box i is still kept, drops
    every later box that box i suppresses.  keep (B, A) bool, suppress
    (B, k, A) bool; one round per row of ``suppress``, a few launches
    each."""
    for i in range(suppress.shape[1]):
        keep = keep & ~(suppress[:, i] & keep[:, i:i + 1])
    return keep


@register("_contrib_MultiBoxDetection", aliases=["contrib_MultiBoxDetection"],
          nin=3, input_names=["cls_prob", "loc_pred", "anchor"],
          params={"clip": P(bool, True), "threshold": P(float, 0.01),
                  "background_id": P(int, 0),
                  "nms_threshold": P(float, 0.5),
                  "force_suppress": P(bool, False),
                  "variances": P("float_tuple", (0.1, 0.1, 0.2, 0.2)),
                  "nms_topk": P(int, -1)})
def multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode + per-class greedy NMS: cls_prob (B, num_classes, A),
    loc_pred (B, A*4), anchor (1, A, 4) -> (B, A, 6) rows [class_id,
    score, x1, y1, x2, y2]; suppressed and invalid rows have class_id -1.
    The higher score suppresses the lower; among equal scores, the
    earlier anchor."""
    if attrs["background_id"] != 0:
        # the reference takes the parameter but its kernel treats class 0
        # as background whatever it says
        raise MXNetError("MultiBoxDetection: background_id != 0 is not "
                         "supported (the reference kernel hardcodes 0)")
    with torch.no_grad():
        out = _detect(cls_prob.detach().float(), loc_pred.detach().float(),
                      anchor.detach().reshape(-1, 4).float(),
                      attrs["threshold"], attrs["clip"],
                      tuple(attrs["variances"]), attrs["nms_threshold"],
                      attrs["force_suppress"], attrs["nms_topk"])
    return out.to(cls_prob.dtype)
