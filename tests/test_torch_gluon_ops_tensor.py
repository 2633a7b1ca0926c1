"""The port's reductions, shape, indexing, ordering, creation and
layer ops that Gluon needs, against the JAX package's: the cases and the
comparison of ``test_torch_gluon_ops.py`` (same inputs through both
registries, forward and vector-Jacobian product; 1e-5 relative and 1e-6
absolute in float32, data movement and integer results bit for bit), for
the ops that are not elementwise, and the variants of a few ops' attrs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from test_torch_gluon_ops import CASES, ELEMWISE, EXTRA_CASES, _rng, \
    _run_both

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items()
                                        if c and n not in ELEMWISE))
def test_op_against_jax(name):
    inputs, attrs, grad = CASES[name](_rng(name))
    _run_both(name, inputs, attrs, grad)


@pytest.mark.parametrize("case", sorted(EXTRA_CASES))
def test_op_variant_against_jax(case):
    name, make = EXTRA_CASES[case]
    inputs, attrs, grad = make(_rng(case))
    _run_both(name, inputs, attrs, grad)


def test_dropout_contract():
    """Dropout keeps about 1 - p of the elements, scales them by 1/(1-p)
    and zeroes the rest in training (the same mask for the same seed);
    outside training, or at p = 0, it is the identity, as the reference's."""
    op = treg.get_op("Dropout")
    x = torch.ones(200, 50)
    mt.random.seed(5)
    y = op.bound(op.normalize({"p": 0.3}), True)(x)[0]
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.02
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))
    mt.random.seed(5)
    assert torch.equal(op.bound(op.normalize({"p": 0.3}), True)(x)[0], y)
    assert op.bound(op.normalize({"p": 0.3}), False)(x)[0] is x
    ya = op.bound(op.normalize({"p": 0.5, "axes": (1,)}), True)(x)[0]
    assert bool((ya == ya[:, :1]).all())
    jx = jreg.get_op("Dropout").bound(
        jreg.get_op("Dropout").normalize({"p": 0.3}), False)(
        jax.random.PRNGKey(0), jnp.ones((3, 4)))[0]
    np.testing.assert_array_equal(np.asarray(jx), np.ones((3, 4)))


