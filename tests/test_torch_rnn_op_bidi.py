"""The fused ``RNN`` op's bidirectional LSTM against the JAX package's on
the CPU, at test_torch_rnn_op.py's sizes and tolerances (1e-5 absolute
forward, 1e-4 relative L2 on every input's gradient): the reverse
direction's outputs in the original time order, its last states, and a
second layer that reads both directions."""
import pytest

from test_torch_rnn_op import check_rnn_against_jax


@pytest.mark.parametrize("layers", [1, 2])
def test_bidirectional_lstm_matches_jax(layers):
    check_rnn_against_jax("lstm", True, True, layers)
