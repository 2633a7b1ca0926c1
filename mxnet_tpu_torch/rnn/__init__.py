"""The symbolic RNN toolkit (counterpart of ``mxnet_tpu/rnn``): cells and
their unroll, bucketed sentence batches, RNN checkpoints."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       SequentialRNNCell, DropoutCell, ModifierCell,
                       ResidualCell, ZoneoutCell, BidirectionalCell,
                       FusedRNNCell)
from .io import encode_sentences, BucketSentenceIter
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ResidualCell", "ZoneoutCell", "BidirectionalCell",
           "FusedRNNCell", "encode_sentences", "BucketSentenceIter",
           "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]
