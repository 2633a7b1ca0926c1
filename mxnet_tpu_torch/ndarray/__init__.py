"""NDArray over torch tensors (counterpart of ``mxnet_tpu/ndarray``)."""
from .ndarray import (NDArray, array, zeros, zeros_like, sgd_update,
                      sgd_mom_update)
from .utils import save, load
