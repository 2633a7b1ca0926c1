"""The fused ``RNN`` op's GRU, and a bidirectional Elman RNN, against the
JAX package's on the CPU, at test_torch_rnn_op.py's sizes and tolerances
(1e-5 absolute forward, 1e-4 relative L2 on every input's gradient): the
GRU's h2h bias inside ``r * nh``."""
import pytest

from test_torch_rnn_op import check_rnn_against_jax


@pytest.mark.parametrize("mode,bidi,state_outputs,layers", [
    ("gru", False, False, 1), ("gru", True, True, 1),
    ("rnn_relu", True, True, 1)])
def test_gru_matches_jax(mode, bidi, state_outputs, layers):
    check_rnn_against_jax(mode, bidi, state_outputs, layers)
