"""The LSTM language model over the fused ``RNN`` op.

Counterpart of ``mxnet_tpu/models/lstm_lm.py`` (``BASELINE.json`` config
4, the PTB LSTM trained through BucketingModule): ``lstm_lm_symbol`` is a
``sym_gen`` keyed on the sequence length; its default vocabulary, 10000,
is PTB's.
"""
from .. import symbol as sym

__all__ = ["lstm_lm_symbol"]


def lstm_lm_symbol(seq_len, vocab_size=10000, num_embed=200, num_hidden=200,
                   num_layers=2):
    """(symbol, data_names, label_names) for sequences of ``seq_len``:
    Embedding, the fused LSTM (time-major inside), FullyConnected to the
    vocabulary, SoftmaxOutput."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data, input_dim=vocab_size, output_dim=num_embed,
                          name="embed")
    body = sym.transpose(embed, axes=(1, 0, 2))
    params = sym.Variable("lstm_parameters")
    init_h = sym.Variable("lstm_init_h")
    init_c = sym.Variable("lstm_init_c")
    out = sym.RNN(body, params, init_h, init_c, state_size=num_hidden,
                  num_layers=num_layers, mode="lstm", name="lstm")
    out = sym.transpose(out, axes=(1, 0, 2))
    pred = sym.Reshape(out, shape=(-1, num_hidden))
    pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
    lab = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(pred, lab, name="softmax"), ("data",), \
        ("softmax_label",)
