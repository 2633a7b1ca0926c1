"""Gluon's GRU cell and the cells with ``valid_length``, against the JAX
package's, and hybridized cells against imperative, on the CPU.

``valid_length`` masks the outputs at and past each sequence's length
(SequenceMask) and takes each state at its last valid step
(SequenceLast): outputs and states within 1e-5 absolute, gradients within
1e-4 relative L2 of the JAX package's (test_torch_gluon_rnn_cells.py's
comparison).  A hybridized cell (each step one ``CachedOp``) gives the
imperative one's outputs and gradients bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from test_torch_gluon_rnn_cells import (H, N, T, _check, _make, _values,
                                        _x, check_cell, run_cell)

torch.set_num_threads(1)


def test_gru_cell_matches_jax():
    check_cell("gru", True)


@pytest.mark.parametrize("kind,layout", [("lstm", "NTC"), ("bidi", "TNC")])
def test_valid_length_matches_jax(kind, layout):
    """(The reference's BidirectionalCell cannot merge NTC outputs under
    valid_length: its two directions come back in different layouts.  So
    the bidirectional case runs TNC, in both packages.)"""
    values = _values(_make(mt.gluon, kind))
    x = _x(2)
    if layout == "TNC":
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    vl = np.array([4, 1, 2], np.float32)
    got = run_cell(mt, kind, values, x, True, False, valid_length=vl,
                   layout=layout)
    want = run_cell(mx, kind, values, x, True, True, valid_length=vl,
                    layout=layout)
    _check(got, want)
    # merged outputs come back time-major with valid_length, as in the
    # reference
    assert got[0].shape == (T, N, H * (2 if kind == "bidi" else 1))
    assert not got[0][1:, 1].any() and not got[0][2:, 2].any()


@pytest.mark.parametrize("kind", ["lstm", "stack", "bidi"])
def test_hybridized_cells_equal_imperative(kind):
    """In training mode, but the stack (with DropoutCell and ZoneoutCell)
    in predict mode: a hybridized step draws its masks in the graph's
    order, not the eager calls', so the masks differ."""
    values = _values(_make(mt.gluon, kind))
    x = _x(3)
    runs = []
    for hyb in (False, True):
        runs.append(run_cell(mt, kind, values, x, True, hyb,
                             training=kind != "stack"))
    eager, hyb = runs
    assert np.array_equal(eager[0], hyb[0])
    assert all(np.array_equal(a, b) for a, b in zip(eager[1], hyb[1]))
    assert np.array_equal(eager[2], hyb[2])
    assert all(np.array_equal(eager[3][k], hyb[3][k]) for k in eager[3])
