"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for NVIDIA Hopper.

The JAX package ``mxnet_tpu`` stays beside it, unchanged, as the
reference.  Module names follow the reference's so each counterpart is
easy to find.  The port serves a frozen ResNet-50 (Symbol -> Executor ->
Predictor / ServingEngine) and trains it (Module.fit -> Executor forward
and backward -> SGD) through hand-written CUDA kernels for the fused
bottleneck units and the 1x1-convolution backward (ops/fused_unit.py,
ops/nn.py, csrc/), and serves continuous-batching greedy decode of an
attention decoder (serving.DecodeEngine -> StepProgram -> the KV-cache
write kernels of ops/cache.py).  ``bench_step.TrainStep`` is the repo's
benchmark step (bench.py's: bfloat16 parameters, batch statistics and
loss in f32).  The data path of ``examples/train_imagenet.py`` is here
too: RecordIO files (``recordio``), ``io.ImageRecordIter`` with its
augmenters (``image``, on host threads or worker processes), the
learning-rate schedulers and the checkpoint callbacks, and the rest of
the training loop of ``examples/train_mnist.py`` (LeNet and the MLP in
``models``, sixteen optimizers, the initializers, the metrics, Monitor,
optimizer-state checkpoints).  The imperative
frontend (``nd.<op>``, ``autograd``) runs the same ops eagerly, ``gluon``
builds Blocks over it (the model zoo's networks, hybridized through
``CachedOp``), and ``rtc`` compiles CUDA C++ at run time and registers
ops.  Entry points run on the first CUDA card
unless the caller passes ``ctx=cpu()`` (``context=cpu()`` for Module) or
opens a ``with cpu():`` scope.
"""
__version__ = "0.12.0.torch1"

from .base import MXNetError
from . import config
from . import profiler
from . import telemetry
from .context import Context, cpu, gpu, current_context
from . import ops
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import autograd
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from .executor import Executor
from . import model
from . import models
from . import predict
from .predict import Predictor, load_checkpoint_predictor
from . import serving
from .serving import ServingEngine, DecodeEngine
from . import convert
from . import analysis
from . import random
from . import initializer
from . import initializer as init
from . import optimizer
from . import optimizer as opt
from . import lr_scheduler
from . import metric
from . import monitor
from .monitor import Monitor
from . import io
from . import recordio
from . import image
from . import callback
from . import module
from . import module as mod
from . import rnn
from . import bench_step
from . import rtc
from . import cached_op
from .cached_op import CachedOp
from . import gluon
from . import test_utils
