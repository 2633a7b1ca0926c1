"""Symbolic training modules (counterpart of ``mxnet_tpu/module``)."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
