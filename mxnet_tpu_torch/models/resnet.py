"""ResNet symbol builder.

Counterpart of ``mxnet_tpu/models/resnet.py`` (pre-activation ResNet,
He et al. 1512.03385 / 1603.05027): the same graph with the same node
and parameter names, so both packages build identical symbol JSON, with
each of the three stems: ``conv7`` (the input BatchNorm, then the 7x7
convolution), ``fused`` (both as one ``_contrib_BNStemConv``) and ``s2d``
(the 7x7 convolution as a 4x4 one over the space-to-depth input).
"""
from .. import symbol as sym


def _fused_unit(data, num_filter, name, bn_mom, height=0, width=0):
    """The stride-1 dim-match bottleneck unit as ONE fused op backed by
    the CUDA kernels of ops/fused_unit.py: the BN+ReLU prologues live
    inside the conv kernels, so normalized activations never reach device
    memory.  With height/width set the op takes and returns 2D (rows, C)
    activations, so consecutive fused units chain with no relayout at
    their boundaries.  Parameter and aux names match the unfused subgraph
    exactly, so checkpoints interchange."""
    v = sym.Variable
    return sym._contrib_FusedBottleneckUnit(
        data,
        gamma1=v(name + "_bn1_gamma"), beta1=v(name + "_bn1_beta"),
        weight1=v(name + "_conv1_weight"),
        gamma2=v(name + "_bn2_gamma"), beta2=v(name + "_bn2_beta"),
        weight2=v(name + "_conv2_weight"),
        gamma3=v(name + "_bn3_gamma"), beta3=v(name + "_bn3_beta"),
        weight3=v(name + "_conv3_weight"),
        moving_mean1=v(name + "_bn1_moving_mean"),
        moving_var1=v(name + "_bn1_moving_var"),
        moving_mean2=v(name + "_bn2_moving_mean"),
        moving_var2=v(name + "_bn2_moving_var"),
        moving_mean3=v(name + "_bn3_moving_mean"),
        moving_var3=v(name + "_bn3_moving_var"),
        num_filter=num_filter, eps=2e-5, momentum=bn_mom,
        height=height, width=width,
        layout="NHWC", name=name + "_fused")


def _residual_unit(data, num_filter, stride, dim_match, name,
                   bottle_neck=True, bn_mom=0.9, layout="NCHW",
                   bn_axis=1, unit_impl="plain"):
    """Pre-activation residual unit (symbols/resnet.py residual_unit).
    (Fused-unit dispatch lives in ONE place: _resnet's stage loop.)"""
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn1", axis=bn_axis)
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=int(num_filter * 0.25),
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1", layout=layout)
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn2", axis=bn_axis)
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=int(num_filter * 0.25),
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2", layout=layout)
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn3", axis=bn_axis)
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3", layout=layout)
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc", layout=layout)
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn1", axis=bn_axis)
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1", layout=layout)
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn2", axis=bn_axis)
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2", layout=layout)
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                                   stride=stride, no_bias=True,
                                   name=name + "_sc", layout=layout)
    return conv2 + shortcut


def _s2d_stem(data, num_filter, height, layout):
    """The 7x7/s2 stem as an exact space-to-depth reformulation: the
    kernel's 7x7 taps padded to 8x8 (one zero row and column in front),
    kernel and image taken to depth by 2, and the convolution becomes
    4x4/s1 over 12 channels (2y+i-3 = 2(y+a)+b with i+1 = 2A+b), so
    conv0_weight keeps its shape and values and checkpoints interchange.
    The 113x113 output is cropped to the 112x112 of the strided original.
    """
    if layout != "NHWC":
        raise ValueError("the s2d stem is channels-last only")
    b_sym = 0  # batch placeholder in reshape specs
    h2 = height // 2
    # image: (B, H, W, 3) -> (B, H/2, W/2, 12); channel order (di, dj, c)
    z = sym.Reshape(data, shape=(b_sym, h2, 2, h2, 2, 3))
    z = sym.transpose(z, axes=(0, 1, 3, 2, 4, 5))
    z = sym.Reshape(z, shape=(b_sym, h2, h2, 12), name="stem_s2d")
    # kernel: (64, 7, 7, 3) --pad front--> (64, 8, 8, 3) -> (64, 4, 4, 12)
    w = sym.Variable("conv0_weight", shape=(num_filter, 7, 7, 3))
    w8 = sym.transpose(w, axes=(0, 3, 1, 2))          # (64, 3, 7, 7)
    w8 = sym.Pad(w8, mode="constant",
                 pad_width=(0, 0, 0, 0, 1, 0, 1, 0))  # front-pad taps
    w8 = sym.transpose(w8, axes=(0, 2, 3, 1))          # (64, 8, 8, 3)
    ws = sym.Reshape(w8, shape=(num_filter, 4, 2, 4, 2, 3))
    ws = sym.transpose(ws, axes=(0, 1, 3, 2, 4, 5))
    ws = sym.Reshape(ws, shape=(num_filter, 4, 4, 12))
    y = sym.Convolution(z, weight=ws, num_filter=num_filter, kernel=(4, 4),
                        stride=(1, 1), pad=(2, 2), no_bias=True,
                        name="conv0", layout="NHWC")
    # pad 2 symmetric gives H/2+1 rows; the original (pad 3, stride 2)
    # needs rows [0, H/2): drop the trailing one
    y = sym.slice_axis(y, axis=1, begin=0, end=h2)
    return sym.slice_axis(y, axis=2, begin=0, end=h2)


def _resnet(units, num_stages, filter_list, num_classes, image_shape,
            bottle_neck=True, bn_mom=0.9, layout="NCHW", stem="conv7",
            unit_impl="plain"):
    """symbols/resnet.py resnet()."""
    bn_axis = 3 if layout == "NHWC" else 1
    data = sym.Variable("data")
    nchannel, height, _ = image_shape
    fused_stem = stem == "fused" and height > 32
    if not fused_stem:
        data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                             name="bn_data", axis=bn_axis)
    if height <= 32:  # cifar-style stem
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0", layout=layout)
    else:  # imagenet stem
        if stem == "s2d":
            body = _s2d_stem(data, filter_list[0], height, layout)
        elif fused_stem:
            # the input BatchNorm and the stem convolution as one op whose
            # backward takes bn_data's dbeta from rectangle sums instead of
            # a stem dgrad (ops/nn.py _contrib_BNStemConv); parameter and
            # aux names match the unfused graph's, so checkpoints
            # interchange
            body = sym._contrib_BNStemConv(
                data,
                gamma=sym.Variable("bn_data_gamma"),
                beta=sym.Variable("bn_data_beta"),
                weight=sym.Variable("conv0_weight"),
                moving_mean=sym.Variable("bn_data_moving_mean"),
                moving_var=sym.Variable("bn_data_moving_var"),
                eps=2e-5, momentum=bn_mom, fix_gamma=True,
                num_filter=filter_list[0], kernel=(7, 7), stride=(2, 2),
                pad=(3, 3), layout=layout, name="stem_fused")
        else:
            body = sym.Convolution(data, num_filter=filter_list[0],
                                   kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                                   no_bias=True, name="conv0", layout=layout)
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name="bn0", axis=bn_axis)
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", layout=layout)

    # exact running spatial dims (non-square capable; conv7/s2/p3 and
    # pool3/s2/p1 both map x -> (x-1)//2 + 1, transition 3x3/s2/p1 the
    # same) — the fused 2D chain needs the true shape, not height//4
    width = image_shape[2]
    if height > 32:
        cur_h = ((height - 1) // 2 + 1 - 1) // 2 + 1
        cur_w = ((width - 1) // 2 + 1 - 1) // 2 + 1
    else:
        cur_h, cur_w = height, width
    from .. import config as _cfg
    min_filter = _cfg.get("MXNET_FUSED_UNIT_MIN_FILTER")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 and height > 32 else (2, 2) \
            if i > 0 else (1, 1)
        if stride == (2, 2):
            cur_h = (cur_h - 1) // 2 + 1
            cur_w = (cur_w - 1) // 2 + 1
        body = _residual_unit(body, filter_list[i + 1], stride, False,
                              name="stage%d_unit%d" % (i + 1, 1),
                              bottle_neck=bottle_neck, bn_mom=bn_mom,
                              layout=layout, bn_axis=bn_axis,
                              unit_impl=unit_impl)
        rest = units[i] - 1
        fuse_run = (rest > 0 and unit_impl == "fused" and bottle_neck
                    and layout == "NHWC"
                    and filter_list[i + 1] >= min_filter)
        if fuse_run:
            # chain the whole dim-match run in the 2D row layout: ONE
            # pair of reshapes per stage instead of relayout copies at
            # every unit boundary
            body = sym.Reshape(body, shape=(-1, filter_list[i + 1]),
                               name="stage%d_rows" % (i + 1))
            for j in range(rest):
                body = _fused_unit(body, filter_list[i + 1],
                                   "stage%d_unit%d" % (i + 1, j + 2),
                                   bn_mom, height=cur_h, width=cur_w)
            body = sym.Reshape(body,
                               shape=(-1, cur_h, cur_w,
                                      filter_list[i + 1]),
                               name="stage%d_grid" % (i + 1))
        else:
            for j in range(rest):
                body = _residual_unit(body, filter_list[i + 1], (1, 1),
                                      True,
                                      name="stage%d_unit%d" % (i + 1, j + 2),
                                      bottle_neck=bottle_neck,
                                      bn_mom=bn_mom, layout=layout,
                                      bn_axis=bn_axis,
                                      unit_impl=unit_impl)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1", axis=bn_axis)
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1", layout=layout)
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


# layer-count → (units, bottle_neck) for imagenet (symbols/resnet.py get_symbol)
_SPECS = {
    18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True), 200: ([3, 24, 36, 3], True),
}


def get_resnet_symbol(num_classes=1000, num_layers=50,
                      image_shape=(3, 224, 224), layout="NCHW",
                      stem="conv7", unit_impl="plain"):
    """Build a ResNet symbol (symbols/resnet.py get_symbol).

    stem='fused': the input BatchNorm and the 7x7 stem convolution as one
    ``_contrib_BNStemConv`` (above 32x32; the same parameters and math).
    stem='s2d' (NHWC only): the exact space-to-depth form of the 7x7/s2
    stem, with the same parameters and outputs (see _s2d_stem).

    unit_impl='fused' (NHWC bottleneck only): stride-1 dim-match units
    run as single fused ops over the CUDA kernels of ops/fused_unit.py —
    same parameters, same math, fewer passes over device memory;
    transition units keep the plain graph."""
    nchannel, height, _ = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
        else:
            filter_list = [64, 64, 128, 256, 512]
        num_stages = 4
        if num_layers not in _SPECS:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units, bottle_neck = _SPECS[num_layers]
    return _resnet(units, num_stages, filter_list, num_classes, image_shape,
                   bottle_neck, layout=layout, stem=stem,
                   unit_impl=unit_impl)
