"""Model builders (counterpart of ``mxnet_tpu/models``)."""
from .lenet import get_lenet, get_mlp
from .resnet import get_resnet_symbol
from .lstm_lm import lstm_lm_symbol
from .ssd import get_ssd_symbol
