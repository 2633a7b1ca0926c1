"""The pooling layers of the PyTorch port's ``gluon.nn`` (max, average
and global, 1-3D, the ``ceil_mode`` ones on the ``full`` convention)
against the JAX package's, by the comparison of
test_torch_gluon_layers.py: same seeded inputs, training and predict
mode, the port imperative and hybridized.  Tolerance: 1e-5 relative and
1e-6 absolute in float32.
"""
import pytest
import torch

from test_torch_gluon_layers import LAYERS, _check_layer

torch.set_num_threads(1)

POOL = {
    "MaxPool1D": (lambda nn: nn.MaxPool1D(3, 2, prefix="l_"), (2, 3, 9)),
    "MaxPool2D": (lambda nn: nn.MaxPool2D(3, 2, padding=1, prefix="l_"),
                  (2, 3, 8, 8)),
    "MaxPool2D ceil": (lambda nn: nn.MaxPool2D(3, 2, ceil_mode=True,
                                               prefix="l_"), (2, 3, 8, 7)),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(2, prefix="l_"), (2, 2, 4, 4, 4)),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(2, prefix="l_"), (2, 3, 8)),
    "AvgPool2D": (lambda nn: nn.AvgPool2D(3, 2, padding=1, prefix="l_"),
                  (2, 3, 8, 8)),
    "AvgPool2D ceil": (lambda nn: nn.AvgPool2D(2, 2, ceil_mode=True,
                                               prefix="l_"), (2, 3, 7, 7)),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(2, prefix="l_"), (2, 2, 4, 4, 4)),
    "GlobalMaxPool1D": (lambda nn: nn.GlobalMaxPool1D(prefix="l_"),
                        (2, 3, 5)),
    "GlobalMaxPool2D": (lambda nn: nn.GlobalMaxPool2D(prefix="l_"),
                        (2, 3, 5, 4)),
    "GlobalMaxPool3D": (lambda nn: nn.GlobalMaxPool3D(prefix="l_"),
                        (2, 3, 3, 2, 2)),
    "GlobalAvgPool1D": (lambda nn: nn.GlobalAvgPool1D(prefix="l_"),
                        (2, 3, 5)),
    "GlobalAvgPool2D NHWC": (lambda nn: nn.GlobalAvgPool2D(
        layout="NHWC", prefix="l_"), (2, 5, 4, 3)),
    "GlobalAvgPool3D": (lambda nn: nn.GlobalAvgPool3D(prefix="l_"),
                        (2, 3, 3, 2, 2)),
}
LAYERS.update(POOL)


@pytest.mark.parametrize("name", sorted(POOL))
@pytest.mark.parametrize("hybrid", [False, True])
def test_layer_against_jax(name, hybrid):
    _check_layer(name, hybrid)
