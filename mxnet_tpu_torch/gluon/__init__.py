"""Gluon, the imperative-first API (counterpart of ``mxnet_tpu/gluon``):
Blocks run define-by-run on NDArrays, and ``hybridize()`` runs a
HybridBlock's symbol through a ``CachedOp``.  The recurrent cells and
layers (``gluon.rnn``) and the vision datasets are not ported yet
(``ROADMAP.md`` Queue A items 2-3)."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import utils
from . import data
from . import model_zoo
