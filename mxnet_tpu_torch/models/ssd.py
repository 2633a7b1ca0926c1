"""SSD detection model (counterpart of ``mxnet_tpu/models/ssd.py``).

The reference's example/ssd symbol_builder.py (get_symbol_train: the
backbone, multi-scale feature layers, per-scale loc/cls convolution heads,
MultiBoxPrior/Target, SoftmaxOutput and a smooth-L1 MakeLoss; get_symbol:
the MultiBoxDetection head) over vgg16_reduced.py, with the same node and
parameter names, so both packages build identical symbol JSON and
checkpoints interchange.  ``testnet`` is a two-scale backbone for tests.
"""
from .. import symbol as sym


def _conv_act(data, name, num_filter, kernel, stride=(1, 1), pad=(0, 0),
              dilate=(1, 1)):
    c = sym.Convolution(data, name=name, num_filter=num_filter,
                        kernel=kernel, stride=stride, pad=pad, dilate=dilate)
    return sym.Activation(c, act_type="relu", name=name + "_relu")


def _vgg16_reduced(data):
    """VGG16 with reduced fc6/fc7 convs (example/ssd/symbol/vgg16_reduced.py).

    Returns the two feature symbols SSD taps (relu4_3, relu7)."""
    x = data
    for blk, (n_convs, nf) in enumerate([(2, 64), (2, 128), (3, 256)]):
        for i in range(n_convs):
            x = _conv_act(x, "conv%d_%d" % (blk + 1, i + 1), nf,
                          (3, 3), pad=(1, 1))
        # pool3 uses ceil-mode ("full") in the reference
        # (vgg16_reduced.py:59): 75 -> 38, keeping relu4_3 at 38x38 for a
        # 300x300 input
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        pooling_convention="full" if blk == 2 else "valid",
                        name="pool%d" % (blk + 1))
    for i in range(3):
        x = _conv_act(x, "conv4_%d" % (i + 1), 512, (3, 3), pad=(1, 1))
    relu4_3 = x
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool4")
    for i in range(3):
        x = _conv_act(x, "conv5_%d" % (i + 1), 512, (3, 3), pad=(1, 1))
    x = sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                    pad=(1, 1), name="pool5")
    # atrous fc6: dilate=(6,6) like the reference (vgg16_reduced.py:87),
    # keeps fc7 at 19x19 for a 300x300 input (anchor-geometry parity)
    x = _conv_act(x, "fc6", 1024, (3, 3), pad=(6, 6), dilate=(6, 6))
    relu7 = _conv_act(x, "fc7", 1024, (1, 1))
    return [relu4_3, relu7]


def _testnet(data):
    """Tiny backbone for tests: two scales, fast to compile."""
    x = _conv_act(data, "tconv1", 16, (3, 3), stride=(2, 2), pad=(1, 1))
    x = _conv_act(x, "tconv2", 32, (3, 3), stride=(2, 2), pad=(1, 1))
    s1 = x
    x = _conv_act(x, "tconv3", 32, (3, 3), stride=(2, 2), pad=(1, 1))
    return [s1, x]


_BACKBONES = {"vgg16_reduced": _vgg16_reduced, "testnet": _testnet}

# per-network default anchor config (example/ssd/train.py defaults)
_DEFAULT_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
                  (0.71, 0.79), (0.88, 0.961)]
_DEFAULT_RATIOS = [(1.0, 2.0, 0.5)] * 2 + [(1.0, 2.0, 0.5, 3.0, 1.0 / 3)] * 3 \
    + [(1.0, 2.0, 0.5)]


def _multiscale_features(feats, num_extra, prefix="multi_feat"):
    """Append stride-2 1x1/3x3 conv pyramids (symbol_builder.py
    multi_layer_feature)."""
    x = feats[-1]
    out = list(feats)
    for i in range(num_extra):
        nf = max(128 // 2, 256 // (2 ** i))
        x = _conv_act(x, "%s_%d_1x1" % (prefix, i), nf, (1, 1))
        x = _conv_act(x, "%s_%d_3x3" % (prefix, i), nf * 2, (3, 3),
                      stride=(2, 2), pad=(1, 1))
        out.append(x)
    return out


def _multibox_layer(feats, num_classes, sizes, ratios):
    """Per-scale loc/cls heads + priors, concatenated
    (symbol_builder.py multibox_layer)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_cls_total = num_classes + 1  # + background
    for i, feat in enumerate(feats):
        num_anchors = len(sizes[i]) + len(ratios[i]) - 1
        loc = sym.Convolution(feat, name="loc_pred_%d" % i,
                              num_filter=num_anchors * 4, kernel=(3, 3),
                              pad=(1, 1))
        # (N, A*4, H, W) -> (N, H*W*A*4)
        loc = sym.Flatten(sym.transpose(loc, axes=(0, 2, 3, 1)))
        loc_layers.append(loc)
        cls = sym.Convolution(feat, name="cls_pred_%d" % i,
                              num_filter=num_anchors * num_cls_total,
                              kernel=(3, 3), pad=(1, 1))
        cls = sym.Flatten(sym.transpose(cls, axes=(0, 2, 3, 1)))
        cls_layers.append(cls)
        anchor_layers.append(sym.Reshape(
            sym.contrib_MultiBoxPrior(feat, sizes=sizes[i], ratios=ratios[i],
                                      clip=False,
                                      name="anchor_%d" % i),
            shape=(1, -1, 4)))
    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_concat = sym.Concat(*cls_layers, dim=1)
    # (N, A*C) -> (N, C, A): class axis first for SoftmaxOutput multi-output
    cls_preds = sym.transpose(
        sym.Reshape(cls_concat, shape=(0, -1, num_cls_total)),
        axes=(0, 2, 1), name="multibox_cls_pred")
    anchors = sym.Concat(*anchor_layers, dim=1, name="multibox_anchors")
    return loc_preds, cls_preds, anchors


def get_ssd_symbol(network="vgg16_reduced", num_classes=20, mode="train",
                   sizes=None, ratios=None, num_extra_scales=None,
                   nms_thresh=0.45, nms_topk=400, force_suppress=False,
                   overlap_threshold=0.5, negative_mining_ratio=3.0):
    """Build the SSD train or detect symbol (symbol_builder.py:60,150).

    mode='train' output: [cls_prob, loc_loss, cls_label]
    mode='detect' output: MultiBoxDetection (N, A, 6)
    """
    backbone = _BACKBONES[network]
    data = sym.Variable("data")
    label = sym.Variable("label")
    feats = backbone(data)
    if network == "testnet":
        sizes = sizes or [(0.2, 0.3), (0.5, 0.7)]
        ratios = ratios or [(1.0, 2.0), (1.0, 2.0)]
        extra = 0 if num_extra_scales is None else num_extra_scales
    else:
        sizes = sizes or _DEFAULT_SIZES
        ratios = ratios or _DEFAULT_RATIOS
        extra = 4 if num_extra_scales is None else num_extra_scales
    feats = _multiscale_features(feats, extra)
    loc_preds, cls_preds, anchors = _multibox_layer(
        feats, num_classes, sizes, ratios)

    if mode == "detect":
        cls_prob = sym.softmax(cls_preds, axis=1, name="cls_prob")
        return sym.contrib_MultiBoxDetection(
            cls_prob, loc_preds, anchors, name="detection",
            nms_threshold=nms_thresh, nms_topk=nms_topk,
            force_suppress=force_suppress, clip=True,
            variances=(0.1, 0.1, 0.2, 0.2))

    loc_target, loc_mask, cls_target = sym.contrib_MultiBoxTarget(
        anchors, label, cls_preds, name="multibox_target",
        overlap_threshold=overlap_threshold,
        negative_mining_ratio=negative_mining_ratio,
        negative_mining_thresh=0.5, minimum_negative_samples=0,
        variances=(0.1, 0.1, 0.2, 0.2))
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target, name="cls_prob",
                                 multi_output=True, use_ignore=True,
                                 ignore_label=-1, normalization="valid")
    loc_diff = loc_mask * (loc_preds - loc_target)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    # surface the label for metrics (reference keeps cls_label output)
    cls_label = sym.MakeLoss(cls_target, grad_scale=0.0, name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])
