"""The fused ``RNN`` op's Elman modes against the JAX package's on the
CPU, at test_torch_rnn_op.py's sizes and tolerances (1e-5 absolute
forward, 1e-4 relative L2 on every input's gradient)."""
import pytest

from test_torch_rnn_op import check_rnn_against_jax


@pytest.mark.parametrize("mode,state_outputs,layers", [
    ("rnn_relu", False, 1), ("rnn_tanh", True, 2)])
def test_elman_rnn_matches_jax(mode, state_outputs, layers):
    check_rnn_against_jax(mode, False, state_outputs, layers)
