"""The fused bottleneck unit of the PyTorch port against the JAX package.

The same numpy inputs go through the JAX package's Pallas kernels (in
interpret mode on the CPU, as its own tests run them) and through the
port's kernel wrappers, which take their plain PyTorch versions for CPU
tensors.  Tolerance: 2e-5 in float32, the f32 rounding of a product summed
in another order (the same bound tests/test_fused_unit.py uses).

tests/test_torch_kernels.py holds the CUDA kernels against these plain
versions on the card.
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops import fused_unit as jfu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_unit as tfu
from mxnet_tpu_torch.ops.registry import invoke

# Small CPU cases: one torch thread runs them faster and leaves the
# cores to the other test workers.
torch.set_num_threads(1)

TOL = 2e-5
EPS = 2e-5
CASES = [(2, 8, 8, 32), (3, 7, 5, 16), (2, 14, 14, 64)]


def _case_rng(case):
    return np.random.default_rng(sum(d * 31 ** i for i, d in enumerate(case)))


def _vec(rng, n, lo=0.5, hi=1.5):
    return rng.uniform(lo, hi, n).astype(np.float32)


def _unit_inputs(rng, c):
    """data-free unit parameters in the op's input order, with moving
    statistics that differ per BatchNorm (a mix-up between them shows)."""
    cq = c // 4
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    return [_vec(rng, c), mk(c), mk(cq, 1, 1, c),
            _vec(rng, cq), mk(cq), mk(cq, 3, 3, cq),
            _vec(rng, cq), mk(cq), mk(c, 1, 1, cq),
            mk(c), _vec(rng, c), mk(cq), _vec(rng, cq, 0.2, 3.0),
            mk(cq), _vec(rng, cq, 0.1, 2.0)]


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _kernel_inputs(case):
    n, h, w, c = case
    cq = c // 4
    rng = _case_rng(case)
    x = rng.standard_normal((n * h * w, c)).astype(np.float32)
    y1 = rng.standard_normal((n * h * w, cq)).astype(np.float32)
    w1 = (rng.standard_normal((cq, 1, 1, c)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((cq, 3, 3, cq)) * 0.1).astype(np.float32)
    w3 = (rng.standard_normal((c, 1, 1, cq)) * 0.1).astype(np.float32)
    sc, sh = _vec(rng, c), (rng.standard_normal(c) * 0.3).astype(np.float32)
    sc2 = _vec(rng, cq)
    sh2 = (rng.standard_normal(cq) * 0.3).astype(np.float32)
    return x, y1, w1, w2, w3, sc, sh, sc2, sh2


def _close_stats(st, sst, sj, ssj):
    scale = float(np.abs(np.asarray(ssj)).max())
    _close(st / scale, np.asarray(sj) / scale)
    _close(sst / scale, np.asarray(ssj) / scale)


@pytest.mark.parametrize("case", CASES)
def test_mm_fwd_plain_matches_pallas(case):
    x, _, w1, _, _, sc, sh, _, _ = _kernel_inputs(case)
    yj, sj, ssj = jfu._mm_fwd(jnp.asarray(x), jfu._w2d(jnp.asarray(w1)),
                              jnp.asarray(sc), jnp.asarray(sh), True,
                              jnp.float32)
    args = [torch.from_numpy(a) for a in (x, w1, sc, sh)]
    yt, st, sst = tfu.mm_fwd(*args, with_stats=True)
    _close(yt, yj)
    _close_stats(st, sst, sj, ssj)
    yt, st, sst = tfu.mm_fwd(*args, with_stats=False)
    _close(yt, yj)
    assert st is None and sst is None


@pytest.mark.parametrize("case", CASES)
def test_mm_skip_fwd_plain_matches_pallas(case):
    x, y1, _, _, w3, _, _, sc2, sh2 = _kernel_inputs(case)
    yj = jfu._mm_skip_fwd(jnp.asarray(y1), jfu._w2d(jnp.asarray(w3)),
                          jnp.asarray(sc2), jnp.asarray(sh2), jnp.asarray(x),
                          jnp.float32)
    yt = tfu.mm_skip_fwd(torch.from_numpy(y1), torch.from_numpy(w3),
                         torch.from_numpy(sc2), torch.from_numpy(sh2),
                         torch.from_numpy(x))
    _close(yt, yj)


@pytest.mark.parametrize("case", CASES)
def test_c3_fwd2d_plain_matches_pallas(case):
    n, h, w, _ = case
    _, y1, _, w2, _, _, _, sc2, sh2 = _kernel_inputs(case)
    yj, sj, ssj = jfu._c3_fwd2d(jnp.asarray(y1), jfu._w4(jnp.asarray(w2)),
                                jnp.asarray(sc2), jnp.asarray(sh2), n, h, w,
                                jnp.float32)
    args = [torch.from_numpy(a) for a in (y1, w2, sc2, sh2)]
    yt, st, sst = tfu.c3_fwd2d(*args, n, h, w, with_stats=True)
    _close(yt, yj)
    _close_stats(st, sst, sj, ssj)
    yt, st, sst = tfu.c3_fwd2d(*args, n, h, w, with_stats=False)
    _close(yt, yj)
    assert st is None and sst is None


def _unit_attrs(c, form, h, w):
    attrs = {"num_filter": c, "eps": EPS, "momentum": 0.9, "layout": "NHWC"}
    if form == "2d":
        attrs.update(height=h, width=w)
    return attrs


@pytest.mark.parametrize("case", CASES)
def test_unit_eval_matches_jax(case):
    """The eval op (moving statistics, kernel chain) in its 4D NHWC and
    2D row forms against the JAX op, which runs the same 2D chain for
    both."""
    n, h, w, c = case
    rng = _case_rng(case)
    data = rng.standard_normal((n, h, w, c)).astype(np.float32)
    params = _unit_inputs(rng, c)
    ref = jfu.fused_bottleneck_unit(
        dict(_unit_attrs(c, "4d", h, w), _training=False),
        *[jnp.asarray(a) for a in [data] + params])
    for form in ("4d", "2d"):
        x = data.reshape(n * h * w, c) if form == "2d" else data
        out = invoke("_contrib_FusedBottleneckUnit",
                     _unit_attrs(c, form, h, w),
                     *[torch.from_numpy(a) for a in [x] + params])
        assert len(out) == len(ref) == 7
        assert out[0].shape == x.shape
        _close(out[0].reshape(data.shape), ref[0])
        for o, r in zip(out[1:], ref[1:]):     # aux pass through unchanged
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_unit_c3_xla_mode_matches_jax(monkeypatch):
    """MXNET_FUSED_UNIT_C3=xla: the middle conv as a plain convolution
    segment in both packages."""
    monkeypatch.setenv("MXNET_FUSED_UNIT_C3", "xla")
    n, h, w, c = CASES[0]
    rng = _case_rng(CASES[0])
    ins = [rng.standard_normal((n, h, w, c)).astype(np.float32)] \
        + _unit_inputs(rng, c)
    attrs = _unit_attrs(c, "4d", h, w)
    ref = jfu.fused_bottleneck_unit(dict(attrs, _training=False),
                                    *[jnp.asarray(a) for a in ins])
    out = invoke("_contrib_FusedBottleneckUnit", attrs,
                 *[torch.from_numpy(a) for a in ins])
    _close(out[0], ref[0])


@pytest.mark.parametrize("mode", ["4d", "bogus"])
def test_unit_unported_c3_modes_raise(monkeypatch, mode):
    """MXNET_FUSED_UNIT_C3=4d runs the middle conv through K4 (its plain
    version here) and matches the JAX op in its 4d mode; an unknown mode
    raises."""
    monkeypatch.setenv("MXNET_FUSED_UNIT_C3", mode)
    n, h, w, c = CASES[0]
    rng = _case_rng(CASES[0])
    ins = [rng.standard_normal((n, h, w, c)).astype(np.float32)] \
        + _unit_inputs(rng, c)
    attrs = _unit_attrs(c, "4d", h, w)
    if mode == "bogus":
        with pytest.raises(MXNetError, match="MXNET_FUSED_UNIT_C3"):
            invoke("_contrib_FusedBottleneckUnit", attrs,
                   *[torch.from_numpy(a) for a in ins])
        return
    before = (tfu.c3_fwd4d.launches, tfu.c3_fwd2d.launches)
    ref = jfu.fused_bottleneck_unit(dict(attrs, _training=False),
                                    *[jnp.asarray(a) for a in ins])
    out = invoke("_contrib_FusedBottleneckUnit", attrs,
                 *[torch.from_numpy(a) for a in ins])
    _close(out[0], ref[0])
    # CPU tensors take the plain versions: no launch is counted
    assert (tfu.c3_fwd4d.launches, tfu.c3_fwd2d.launches) == before


def test_unit_training_mode_raises(monkeypatch):
    """Training under MXNET_FUSED_UNIT_C3=4d (K4 forward, K7 backward)
    against the JAX op's 4d training in its interpret mode: output, the
    six write-backs and the ten gradients, at the shape of
    tests/test_fused_unit.py's 4d case."""
    monkeypatch.setenv("MXNET_FUSED_UNIT_C3", "4d")
    _check_training_unit(CASES[0])


@pytest.mark.parametrize("case", CASES)
def test_c3_fwd4d_plain_matches_pallas(case):
    n, h, w, _ = case
    cq = case[-1] // 4
    _, y1, _, w2, _, _, _, sc2, sh2 = _kernel_inputs(case)
    x4 = y1.reshape(n, h, w, cq)
    yj, sj, ssj = jfu._c3_fwd(jnp.asarray(x4), jfu._w4(jnp.asarray(w2)),
                              jnp.asarray(sc2), jnp.asarray(sh2),
                              jnp.float32)
    args = [torch.from_numpy(a) for a in (x4, w2, sc2, sh2)]
    yt, st, sst = tfu.c3_fwd4d(*args, with_stats=True)
    assert yt.shape == (n, h, w, cq)
    _close_rel(yt, yj)
    _close_stats(st, sst, sj, ssj)
    yt, st, sst = tfu.c3_fwd4d(*args, with_stats=False)
    _close_rel(yt, yj)
    assert st is None and sst is None


# ---------------------------------------------------------------------------
# Training: the backward kernels' plain versions and the unit's gradients
# ---------------------------------------------------------------------------

def _bwd_inputs(case, co, ci):
    """Cotangent, raw output, finalize vectors, input, (Co, Ci) weight and
    the four BatchNorm vectors of one conv's backward."""
    n, h, w, _ = case
    rng = _case_rng(case + (co, ci))
    rows = n * h * w
    r = lambda *s, scale=1.0: (rng.standard_normal(s)  # noqa: E731
                               * scale).astype(np.float32)
    g, yraw, x = r(rows, co), r(rows, co), r(rows, ci)
    fin = (_vec(rng, co), r(co, scale=0.1), r(co, scale=0.1))
    vecs = (_vec(rng, ci), r(ci, scale=0.3), _vec(rng, ci), r(ci, scale=0.3))
    return g, yraw, fin, x, vecs


def _close_rel(got, want, tol=TOL):
    """Within tol of the largest magnitude of the reference."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) / scale <= tol


@pytest.mark.parametrize("deferred", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_mm_bwd_plain_matches_pallas(case, deferred):
    """K5 at the unit's conv3 (final, Co = C) and conv1 (deferred, Co =
    C/4) shapes against _mm_bwd in interpret mode; the port's dW is the
    reference's transposed."""
    c = case[-1]
    co, ci = (c // 4, c) if deferred else (c, c // 4)
    g, yraw, fin, x, vecs = _bwd_inputs(case, co, ci)
    w = (_case_rng(case).standard_normal((co, ci)) * 0.1).astype(np.float32)
    fin = fin if deferred else None
    ref = jfu._mm_bwd(jnp.asarray(g), jnp.asarray(yraw) if deferred else None,
                      None if fin is None else tuple(map(jnp.asarray, fin)),
                      jnp.asarray(x), jnp.asarray(w),
                      *map(jnp.asarray, vecs), jnp.float32)
    t = torch.from_numpy
    out = tfu.mm_bwd(t(g), t(yraw) if deferred else None,
                     None if fin is None else tuple(map(t, fin)), t(x),
                     t(w).reshape(co, 1, 1, ci), *map(t, vecs))
    _close_rel(out[0], ref[0])
    _close_rel(out[1].t(), ref[1])
    _close_rel(out[2], ref[2])
    _close_rel(out[3], ref[3])


@pytest.mark.parametrize("case", CASES)
def test_c3_bwd2d_plain_matches_pallas(case):
    n, h, w, c = case
    cq = c // 4
    g, yraw, fin, x, vecs = _bwd_inputs(case, cq, cq)
    w2 = (_case_rng(case).standard_normal((cq, 3, 3, cq)) * 0.1) \
        .astype(np.float32)
    ref = jfu._c3_bwd2d(jnp.asarray(g), jnp.asarray(yraw),
                        tuple(map(jnp.asarray, fin)), jnp.asarray(x),
                        jfu._w4(jnp.asarray(w2)), *map(jnp.asarray, vecs),
                        n, h, w, jnp.float32)
    t = torch.from_numpy
    out = tfu.c3_bwd2d(t(g), t(yraw), tuple(map(t, fin)), t(x), t(w2),
                       *map(t, vecs), n, h, w)
    _close_rel(out[0], ref[0])
    _close_rel(out[1].permute(1, 2, 3, 0), ref[1])
    _close_rel(out[2], ref[2])
    _close_rel(out[3], ref[3])


@pytest.mark.parametrize("case", CASES)
def test_c3_bwd4d_plain_matches_pallas(case):
    """K7's plain version against _c3_bwd in interpret mode; the port's dW
    is (Co, 3, 3, Ci), the reference's (3, 3, Ci, Co)."""
    n, h, w, c = case
    cq = c // 4
    g, yraw, fin, x, vecs = _bwd_inputs(case, cq, cq)
    g, yraw, x = (a.reshape(n, h, w, cq) for a in (g, yraw, x))
    w2 = (_case_rng(case).standard_normal((cq, 3, 3, cq)) * 0.1) \
        .astype(np.float32)
    ref = jfu._c3_bwd(jnp.asarray(g), jnp.asarray(yraw),
                      tuple(map(jnp.asarray, fin)), jnp.asarray(x),
                      jfu._w4(jnp.asarray(w2)), *map(jnp.asarray, vecs),
                      jnp.float32)
    t = torch.from_numpy
    out = tfu.c3_bwd4d(t(g), t(yraw), tuple(map(t, fin)), t(x), t(w2),
                       *map(t, vecs))
    _close_rel(out[0], ref[0])
    _close_rel(out[1].permute(1, 2, 3, 0), ref[1])
    _close_rel(out[2], ref[2])
    _close_rel(out[3], ref[3])


_PARAM_NAMES = ["data", "g1", "b1", "w1", "g2", "b2", "w2", "g3", "b3", "w3"]


# (case, MXNET_FUSED_UNIT_C3) -> _jax_training_unit's result, computed once
# a module
_JAX_TRAINING_UNITS = {}


def _jax_training_unit(attrs, ins):
    """JAX: outputs and the gradients of sum(tanh(out)) with respect to
    the data and the nine parameters, jitted (a third of the eager
    interpret mode's time; the two agree within 2.4e-6 of each array's
    largest magnitude)."""
    import jax
    aux = [jnp.asarray(a) for a in ins[10:]]

    def loss(*diff):
        outs = jfu.fused_bottleneck_unit(dict(attrs, _training=True),
                                         *diff, *aux)
        return jnp.sum(jnp.tanh(outs[0])), outs
    (_, outs), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(10)), has_aux=True))(
        *[jnp.asarray(a) for a in ins[:10]])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_training_unit(attrs, ins):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins[:10]]
    outs = invoke("_contrib_FusedBottleneckUnit", attrs, *leaves,
                  *[torch.from_numpy(a) for a in ins[10:]], training=True)
    torch.tanh(outs[0]).sum().backward()
    return ([o.detach().numpy() for o in outs],
            [leaf.grad.numpy() for leaf in leaves])


def _check_training_unit(case, form="4d"):
    n, h, w, c = case
    rng = _case_rng(case)
    data = rng.standard_normal((n, h, w, c)).astype(np.float32)
    ins = [data] + _unit_inputs(rng, c)
    attrs = _unit_attrs(c, "4d", h, w)
    key = (case, os.environ.get("MXNET_FUSED_UNIT_C3"))
    if key not in _JAX_TRAINING_UNITS:
        _JAX_TRAINING_UNITS[key] = _jax_training_unit(attrs, ins)
    ref_outs, ref_grads = _JAX_TRAINING_UNITS[key]
    if form == "2d":
        ins[0] = data.reshape(n * h * w, c)
        attrs = _unit_attrs(c, "2d", h, w)
    outs, grads = _port_training_unit(attrs, ins)
    assert len(outs) == len(ref_outs) == 7
    _close(outs[0].reshape(data.shape), ref_outs[0])
    for o, r in zip(outs[1:], ref_outs[1:]):         # the six write-backs
        _close(o, r)
    # the atol rule of tests/test_fused_unit.py: 3e-5 of the gradient's
    # largest magnitude, at least 3e-5
    for name, g, r in zip(_PARAM_NAMES, grads, ref_grads):
        scale = float(np.abs(r).max()) + 1e-6
        np.testing.assert_allclose(g.reshape(r.shape), r, rtol=0,
                                   atol=3e-5 * max(scale, 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_unit_training_matches_jax(case):
    """Output, the six moving-average write-backs, and the gradients of
    the data and all nine parameters against jax.grad of the JAX op, with
    non-trivial gammas and moving statistics."""
    _check_training_unit(case)


def test_unit_training_2d_and_c3_xla_match_jax(monkeypatch):
    """The 2D row form, and MXNET_FUSED_UNIT_C3=xla (the middle conv and
    its backward as torch convolutions) in both packages."""
    _check_training_unit(CASES[0], form="2d")
    monkeypatch.setenv("MXNET_FUSED_UNIT_C3", "xla")
    _check_training_unit(CASES[1])
