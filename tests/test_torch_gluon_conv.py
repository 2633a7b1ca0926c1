"""The convolution and transposed-convolution layers of the PyTorch
port's ``gluon.nn`` against the JAX package's (Conv2D in NCHW and NHWC,
with groups and dilation), by the comparison of
test_torch_gluon_layers.py: same seeded weights, training and predict
mode, the port imperative and hybridized.  Tolerance: 1e-5 relative and
1e-6 absolute in float32 (1e-5 absolute for parameter gradients).
"""
import pytest
import torch

from test_torch_gluon_layers import LAYERS, _check_layer

torch.set_num_threads(1)

CONV = {
    "Conv1D": (lambda nn: nn.Conv1D(4, 3, strides=2, padding=1,
                                    prefix="l_"), (2, 3, 9)),
    "Conv2D": (lambda nn: nn.Conv2D(4, (3, 2), strides=(2, 1), padding=1,
                                    dilation=(1, 2), activation="relu",
                                    prefix="l_"), (2, 3, 8, 7)),
    "Conv2D groups": (lambda nn: nn.Conv2D(4, 3, groups=2, padding=1,
                                           use_bias=False, prefix="l_"),
                      (2, 4, 6, 6)),
    "Conv2D NHWC": (lambda nn: nn.Conv2D(4, 3, strides=2, padding=1,
                                         layout="NHWC", prefix="l_"),
                    (2, 8, 7, 3)),
    "Conv3D": (lambda nn: nn.Conv3D(2, 2, prefix="l_"), (2, 3, 4, 4, 3)),
    "Conv1DTranspose": (lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, prefix="l_"),
        (2, 3, 5)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, prefix="l_"), (2, 3, 4, 5)),
    "Conv2DTranspose NHWC": (lambda nn: nn.Conv2DTranspose(
        4, 3, strides=(2, 1), padding=1, output_padding=(1, 0),
        layout="NHWC", prefix="l_"), (2, 4, 5, 3)),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(
        2, 2, strides=2, prefix="l_"), (2, 3, 2, 3, 2)),
}
LAYERS.update(CONV)


@pytest.mark.parametrize("name", sorted(CONV))
@pytest.mark.parametrize("hybrid", [False, True])
def test_layer_against_jax(name, hybrid):
    _check_layer(name, hybrid)
