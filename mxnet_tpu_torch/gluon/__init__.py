"""Gluon, the imperative-first API (counterpart of ``mxnet_tpu/gluon``):
Blocks run define-by-run on NDArrays, and ``hybridize()`` runs a
HybridBlock's symbol through a ``CachedOp``; ``rnn`` holds the recurrent
cells and the fused RNN layers.  The vision datasets are not ported yet
(``ROADMAP.md`` Queue A item 2)."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import utils
from . import data
from . import model_zoo
from . import rnn
