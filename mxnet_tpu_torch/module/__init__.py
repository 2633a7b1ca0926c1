"""Symbolic training modules (counterpart of ``mxnet_tpu/module``)."""
from .base_module import BaseModule
from .module import Module
