"""Declarative graph API (counterpart of ``mxnet_tpu/symbol``)."""
import sys as _sys

from .symbol import (Symbol, var, Variable, Group, load, load_json, zeros,
                     ones)
from . import register as _register

_mod = _sys.modules[__name__]
for _name, _fn in _register.build_namespace().items():
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _fn)
_register.attach_methods()
