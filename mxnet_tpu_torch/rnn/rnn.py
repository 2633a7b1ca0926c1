"""RNN checkpoints: the standard Module checkpoint, with each cell's
weights packed on save and unpacked on load.

Counterpart of ``mxnet_tpu/rnn/rnn.py``, so a model trained with
FusedRNNCell restores into unfused cells and back, and either package
reads the other's files.
"""
from .. import model as _model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """``model.save_checkpoint`` with ``cells``' weights packed."""
    cells = cells if isinstance(cells, (list, tuple)) else [cells]
    for cell in cells:
        arg_params = cell.pack_weights(arg_params)
    _model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``model.load_checkpoint`` with ``cells``' weights unpacked."""
    sym, arg, aux = _model.load_checkpoint(prefix, epoch)
    cells = cells if isinstance(cells, (list, tuple)) else [cells]
    for cell in cells:
        arg = cell.unpack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback saving through ``save_rnn_checkpoint`` every
    ``period`` epochs."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
