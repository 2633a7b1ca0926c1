"""NDArray over torch tensors (counterpart of ``mxnet_tpu/ndarray``), and
``mt.nd.<op>`` for every op the registry holds."""
import sys as _sys

from .ndarray import (NDArray, array, from_numpy, zeros, zeros_like, ones,
                      ones_like, full, empty, arange, concatenate, waitall,
                      invoke,
                      sgd_update, sgd_mom_update, mp_sgd_update,
                      mp_sgd_mom_update, adam_update, rmsprop_update,
                      rmspropalex_update, ftrl_update, signsgd_update,
                      signum_update)
from .utils import save, load
from . import register as _register

_mod = _sys.modules[__name__]
for _name, _fn in _register.build_namespace().items():
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _fn)
_register.attach_methods()
