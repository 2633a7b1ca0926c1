"""The tensor-core arithmetic and tiling of K1-K8, emulated on the CPU.

The CUDA kernels (csrc/fu_mma.cuh, and the halo-resident csrc/fu_halo.cuh
of K4 and K7) compute float32 products as 3xTF32 on the tensor cores, over
output tiles and splits of the summed axis chosen in Python from the
shapes alone.  Here:

- ``_tf32`` rounds as ``cvt.rna.tf32.f32`` on crafted bit patterns, and
  ``_mma_step`` rounds as the card's m16n8k8 tf32 MMA on 48 of its results
  (``tests/fixtures/mma_tf32_h100.npz``);
- ``mm_fwd_tf32x3`` / ``mm_skip_fwd_tf32x3`` / ``c3_fwd2d_tf32x3`` /
  ``c3_fwd4d_tf32x3`` / ``mm_bwd_tf32x3`` / ``c3_bwd2d_tf32x3`` /
  ``c3_bwd4d_tf32x3`` / ``conv1x1_bwd_tf32x3``, which walk the kernels' k
  order and splits in their order, against the JAX package's ``_mm_fwd``
  / ``_mm_skip_fwd`` / ``_c3_fwd2d`` / ``_c3_fwd`` / ``_mm_bwd`` /
  ``_c3_bwd2d`` / ``_c3_bwd`` / ``_fused1x1_bwd_pallas`` (in interpret
  mode, as its own tests run them) at ResNet-50's widths or on ragged
  images with split plans, within chip_smoke.py's float32 tolerance; a
  single TF32 pass fails it;
- the tile and split plans: pure functions of the shapes at every
  main-path shape, and the scratch the wrappers allocate from them.

tests/test_torch_kernels.py holds the kernels themselves against the
plain versions on the card.
"""
import contextlib
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops import fused_unit as jfu
from mxnet_tpu.ops.nn import _fused1x1_bwd_pallas
from mxnet_tpu_torch.ops import _cuda
from mxnet_tpu_torch.ops import fused_unit as tfu
from mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
TOL = SMOKE.TOL["float32"]

# (input bits, cvt.rna.tf32.f32's bits): 13 bits dropped, to nearest, ties
# away from zero
TF32_CASES = [
    (0x3F800000, 0x3F800000),   # 1.0 is exact
    (0x3F800FFF, 0x3F800000),   # just below the tie: down
    (0x3F801000, 0x3F802000),   # the tie: away from zero
    (0x3F801001, 0x3F802000),   # just above the tie: up
    (0x3FFFF000, 0x40000000),   # the tie carries into the exponent: 2.0
    (0xBF801000, 0xBF802000),   # a negative tie: away from zero
    (0xC0FFF000, 0xC1000000),   # a negative tie carries: -8.0
    (0x00000000, 0x00000000),   # zero
    (0x80000000, 0x80000000),   # negative zero keeps its sign
]


def _bits(v):
    return torch.tensor([v], dtype=torch.int64).to(torch.int32) \
        .view(torch.float32)


@pytest.mark.parametrize("bits,want", TF32_CASES,
                         ids=["%08x" % b for b, _ in TF32_CASES])
def test_tf32_rounds_like_cvt_rna(bits, want):
    got = tfu._tf32(_bits(bits)).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, "%08x -> %08x, want %08x" % (bits, got, want)


# 48 tf32 MMAs (m16n8k8) on an NVIDIA H100 80GB HBM3: inputs and the
# card's results, written by chip_mma_probe.py --fixture (a third each of
# one scale, spread exponents and cancelling sums)
MMA_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "mma_tf32_h100.npz")


def test_mma_model_reproduces_the_card_bitwise():
    """fused_unit._mma_step, the model of how an m16n8k8 tf32 MMA rounds
    that the exact emulations use, gives the card's bits for the fixture's
    MMAs; adding the products in f32 does not."""
    f = np.load(MMA_FIXTURE)
    a, b, c, d = (torch.from_numpy(f[k]) for k in "abcd")
    assert a.shape[0] == 48
    for i in range(a.shape[0]):
        got = tfu._mma_step(c[i], a[i], b[i])
        assert torch.equal(got, d[i]), i
    f32 = [torch.equal(c[i] + a[i] @ b[i], d[i]) for i in range(48)]
    assert not all(f32)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# stage 4 of ResNet-50: C = 2048, C/4 = 512, at a small row count
ROWS, C, CQ = 64, 2048, 512


def _rng():
    return np.random.default_rng(20480)


def _fwd_inputs():
    rng = _rng()
    x = rng.standard_normal((ROWS, C)).astype(np.float32)
    w = (rng.standard_normal((CQ, 1, 1, C)) * C ** -0.5).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, C).astype(np.float32)
    sh = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return x, w, sc, sh


@pytest.fixture(scope="module")
def fwd_case():
    x, w, sc, sh = _fwd_inputs()
    ref = jfu._mm_fwd(jnp.asarray(x), jfu._w2d(jnp.asarray(w)),
                      jnp.asarray(sc), jnp.asarray(sh), True, jnp.float32)
    return [torch.from_numpy(a) for a in (x, w, sc, sh)], ref


def test_mm_fwd_tf32x3_matches_pallas(fwd_case):
    args, (yj, sj, ssj) = fwd_case
    plan = _cuda.mma_plan(ROWS, CQ, C)
    assert plan[2] > 1                      # the emulation walks a split
    y, s, ss = tfu.mm_fwd_tf32x3(*args, with_stats=True)
    assert _rel(y, yj) <= TOL
    assert _rel(s, sj) <= SMOKE.TOL["stats"]
    assert _rel(ss, ssj) <= SMOKE.TOL["stats"]


def test_one_tf32_pass_fails_the_float32_tolerance(fwd_case):
    """The control: the same walk with a_hi b_hi alone (one TF32 pass)
    misses chip_smoke's float32 bound that 3xTF32 meets."""
    args, (yj, _, _) = fwd_case
    y = tfu.mm_fwd_tf32x3(*args, passes=1)[0]
    assert _rel(y, yj) > 4 * TOL


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one-pass"])
@pytest.mark.parametrize("rows,cq", [(ROWS, CQ), (100, 64)],
                         ids=["stage4-split", "stage1-ragged"])
def test_mm_skip_fwd_tf32x3_matches_pallas(rows, cq, passes):
    """K2 at stage 4's widths (its k = C/4 = 512 split in two) and at
    stage 1's on 100 rows (no split, rows off every tile): the residual
    added to the complete 3xTF32 sum within the float32 tolerance, one
    TF32 pass outside it."""
    rng = _rng()
    c = 4 * cq
    x = rng.standard_normal((rows, cq)).astype(np.float32)
    w = (rng.standard_normal((c, 1, 1, cq)) * cq ** -0.5).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, cq).astype(np.float32)
    sh = (rng.standard_normal(cq) * 0.1).astype(np.float32)
    skip = rng.standard_normal((rows, c)).astype(np.float32)
    assert (_cuda.mma_plan(rows, c, cq)[2] > 1) == (cq == CQ)
    j = jnp.asarray
    ref = jfu._mm_skip_fwd(j(x), jfu._w2d(j(w)), j(sc), j(sh), j(skip),
                           jnp.float32)
    t = torch.from_numpy
    y = tfu.mm_skip_fwd_tf32x3(t(x), t(w), t(sc), t(sh), t(skip),
                               passes=passes)
    err = _rel(y, ref)
    if passes == 3:
        assert err <= TOL, err
    else:
        assert err > TOL, err


def _bwd_inputs(deferred):
    rng = _rng()
    co, ci = (CQ, C) if deferred else (C, CQ)
    g = rng.standard_normal((ROWS, co)).astype(np.float32)
    yraw = rng.standard_normal((ROWS, co)).astype(np.float32)
    x = rng.standard_normal((ROWS, ci)).astype(np.float32)
    w = (rng.standard_normal((co, ci)) * ci ** -0.5).astype(np.float32)
    vecs = [rng.uniform(0.5, 1.5, ci).astype(np.float32),
            (rng.standard_normal(ci) * 0.3).astype(np.float32),
            rng.uniform(0.5, 1.5, ci).astype(np.float32),
            (rng.standard_normal(ci) * 0.3).astype(np.float32)]
    fin = (rng.uniform(0.5, 1.5, co).astype(np.float32),
           (rng.standard_normal(co) * 0.1).astype(np.float32),
           (rng.standard_normal(co) * 0.1).astype(np.float32))
    return g, yraw if deferred else None, fin if deferred else None, x, w, \
        vecs


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one-pass"])
@pytest.mark.parametrize("deferred", [False, True],
                         ids=["final", "deferred"])
def test_mm_bwd_tf32x3_matches_pallas(deferred, passes):
    """K5 at conv3's (final, Co = 2048) and conv1's (deferred, Ci = 2048)
    stage-4 shapes: 3xTF32 within the float32 tolerance in every output;
    one TF32 pass outside it in dP."""
    g, yraw, fin, x, w, vecs = _bwd_inputs(deferred)
    j = jnp.asarray
    ref = jfu._mm_bwd(j(g), None if yraw is None else j(yraw),
                      None if fin is None else tuple(map(j, fin)), j(x),
                      j(w), *map(j, vecs), jnp.float32)
    t = torch.from_numpy
    co, ci = w.shape
    out = tfu.mm_bwd_tf32x3(t(g), None if yraw is None else t(yraw),
                            None if fin is None else tuple(map(t, fin)),
                            t(x), t(w).reshape(co, 1, 1, ci),
                            *map(t, vecs), passes=passes)
    errs = [_rel(out[0], ref[0]), _rel(out[1].t(), ref[1]),
            _rel(out[2], ref[2]), _rel(out[3], ref[3])]
    if passes == 3:
        assert max(errs) <= TOL, errs
    else:
        assert errs[0] > TOL, errs


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one-pass"])
@pytest.mark.parametrize("case", [(2, 7, 7, 256), (2, 28, 28, 64)],
                         ids=["stage3-width", "wgrad-split"])
def test_c3_bwd2d_tf32x3_matches_pallas(case, passes):
    """K6 at stage 3's width (its dgrad split 8 ways over k = (tap, o))
    and at stage 1's width on 1568 rows (its wgrad split over the rows):
    3xTF32 within the float32 tolerance in every output, one TF32 pass
    outside it in dP.  The port's dW is (Co, 3, 3, Ci), the reference's
    (3, 3, Ci, Co)."""
    n, h, w, c = case
    rows = n * h * w
    assert _cuda.mma_plan(rows, c, 9 * c)[2] > 1 \
        or _cuda.mma_wgrad_plan(c, 9 * c, rows)[2] > 1
    rng = _rng()
    r = lambda *s, scale=1.0: (rng.standard_normal(s)  # noqa: E731
                               * scale).astype(np.float32)
    g, yraw, x = r(rows, c), r(rows, c), r(rows, c)
    w2 = r(c, 3, 3, c, scale=(9 * c) ** -0.5)
    fin = (rng.uniform(0.5, 1.5, c).astype(np.float32), r(c, scale=0.1),
           r(c, scale=0.1))
    vecs = (rng.uniform(0.5, 1.5, c).astype(np.float32), r(c, scale=0.3),
            rng.uniform(0.5, 1.5, c).astype(np.float32), r(c, scale=0.3))
    j = jnp.asarray
    ref = jfu._c3_bwd2d(j(g), j(yraw), tuple(map(j, fin)), j(x),
                        jfu._w4(j(w2)), *map(j, vecs), n, h, w, jnp.float32)
    t = torch.from_numpy
    out = tfu.c3_bwd2d_tf32x3(t(g), t(yraw), tuple(map(t, fin)), t(x),
                              t(w2), *map(t, vecs), n, h, w, passes=passes)
    errs = [_rel(out[0], ref[0]), _rel(out[1].permute(1, 2, 3, 0), ref[1]),
            _rel(out[2], ref[2]), _rel(out[3], ref[3])]
    if passes == 3:
        assert max(errs) <= TOL, errs
    else:
        assert errs[0] > TOL, errs


@functools.lru_cache(maxsize=None)
def _c3_case(n, h, w, c):
    """Seeded inputs of a 3x3 at c channels in and out over n h x w images,
    K3's (x, w, sc, sh) and K7's (g, y_raw, fin, x, w, sc, sh, xs, xh), with
    the JAX package's ``_c3_fwd2d`` (y, sums) and ``_c3_bwd`` (dP, dW,
    sums) on them."""
    rng = np.random.default_rng(n * 1000 + h * 100 + w + c)
    rows = n * h * w
    r = lambda *s, scale=1.0: (rng.standard_normal(s)  # noqa: E731
                               * scale).astype(np.float32)
    u = lambda k: rng.uniform(0.5, 1.5, k).astype(np.float32)  # noqa: E731
    fwd = (r(rows, c), r(c, 3, 3, c, scale=(9 * c) ** -0.5), u(c),
           r(c, scale=0.3))
    bwd = (r(n, h, w, c), r(n, h, w, c), (u(c), r(c, scale=0.1),
                                          r(c, scale=0.1)),
           r(n, h, w, c), r(c, 3, 3, c, scale=(9 * c) ** -0.5), u(c),
           r(c, scale=0.3), u(c), r(c, scale=0.3))
    j = jnp.asarray
    yj = jfu._c3_fwd2d(j(fwd[0]), jfu._w4(j(fwd[1])), j(fwd[2]), j(fwd[3]),
                       n, h, w, jnp.float32)
    g, yraw, fin, x, w2 = bwd[:5]
    bj = jfu._c3_bwd(j(g), j(yraw), tuple(map(j, fin)), j(x),
                     jfu._w4(j(w2)), *map(j, bwd[5:]), jnp.float32)
    return fwd, bwd, [np.asarray(a) for a in yj], [np.asarray(a) for a in bj]


def _torch(a):
    return tuple(map(_torch, a)) if isinstance(a, tuple) \
        else torch.from_numpy(a)


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one-pass"])
def test_c3_fwd2d_tf32x3_matches_pallas(passes):
    """K3 on two ragged 13 x 11 images at 64 channels (its k = 9 * 64
    split in two): 3xTF32 within the float32 tolerance in y and the
    statistics of the f32 accumulator, one TF32 pass outside it in y."""
    n, h, w, c = 2, 13, 11, 64
    assert _cuda.mma_plan(n * h * w, c, 9 * c)[2] > 1
    fwd, _, (yj, sj, ssj), _ = _c3_case(n, h, w, c)
    y, s, ss = tfu.c3_fwd2d_tf32x3(*_torch(fwd), n, h, w, with_stats=True,
                                   passes=passes)
    errs = [_rel(y, yj), _rel(s, sj), _rel(ss, ssj)]
    if passes == 3:
        assert max(errs) <= TOL, errs
    else:
        assert errs[0] > TOL, errs


@functools.lru_cache(maxsize=None)
def _c3_fwd4d_ref(n, h, w, c):
    """The JAX package's ``_c3_fwd`` (y, sums) on K3's inputs of
    ``_c3_case`` viewed as NHWC."""
    x, wt, sc, sh = _c3_case(n, h, w, c)[0]
    j = jnp.asarray
    out = jfu._c3_fwd(j(x.reshape(n, h, w, c)), jfu._w4(j(wt)), j(sc),
                      j(sh), jnp.float32)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one-pass"])
@pytest.mark.parametrize("case", [(2, 13, 11, 64), (1, 13, 11, 128)],
                         ids=["ragged", "ragged-split"])
def test_c3_fwd4d_tf32x3_matches_pallas(case, passes):
    """K4 on two ragged 13 x 11 images at 64 channels and on one at 128
    (its Ci split in two): 3xTF32 within the float32 tolerance in y and
    the statistics of the f32 sum, one TF32 pass outside it in y."""
    n, h, w, c = case
    assert (_cuda.halo_fwd_plan(n * h * w, c, c, w)[2] > 1) == (c == 128)
    x, wt, sc, sh = _torch(_c3_case(n, h, w, c)[0])
    yj, sj, ssj = _c3_fwd4d_ref(n, h, w, c)
    y, s, ss = tfu.c3_fwd4d_tf32x3(x.reshape(n, h, w, c), wt, sc, sh,
                                   with_stats=True, passes=passes)
    errs = [_rel(y, yj), _rel(s, sj), _rel(ss, ssj)]
    if passes == 3:
        assert errs[0] <= TOL and max(errs[1:]) <= SMOKE.TOL["stats"], errs
    else:
        assert errs[0] > TOL, errs


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one-pass"])
@pytest.mark.parametrize("case", [(1, 13, 11, 128), (2, 28, 28, 64)],
                         ids=["ragged-dgrad-split", "wgrad-split"])
def test_c3_bwd4d_tf32x3_matches_pallas(case, passes):
    """K7 on a ragged 13 x 11 image at 128 channels (its dgrad's Co split
    in two) and at stage 1's width on 1568 pixels (its wgrad's pixels
    split): 3xTF32 within the float32 tolerance in every output, one TF32
    pass outside it in dP.  The port's dW is (Co, 3, 3, Ci), the
    reference's (3, 3, Ci, Co)."""
    n, h, w, c = case
    rows = n * h * w
    assert _cuda.halo_dgrad_plan(rows, c, c, w)[2] > 1 \
        or _cuda.halo_wgrad_plan(rows, c, c)[0] > 1
    _, bwd, _, ref = _c3_case(n, h, w, c)
    out = tfu.c3_bwd4d_tf32x3(*_torch(bwd), passes=passes)
    errs = [_rel(out[0], ref[0]), _rel(out[1].permute(1, 2, 3, 0), ref[1]),
            _rel(out[2], ref[2]), _rel(out[3], ref[3])]
    if passes == 3:
        assert max(errs) <= TOL, errs
    else:
        assert errs[0] > TOL, errs


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "one-pass"])
@pytest.mark.parametrize("rows,ci,co", [(256, 512, 2048), (1024, 256, 1024)],
                         ids=["stage4-site", "wgrad-split"])
def test_conv1x1_bwd_tf32x3_matches_pallas(rows, ci, co, passes):
    """K8 at its stage-4 site's widths (its dgrad split over Co) and at
    its stage-3 site's on 1024 rows (its wgrad split): 3xTF32 within the
    float32 tolerance in dx and dW, one TF32 pass outside it in dx."""
    rng = _rng()
    x = rng.standard_normal((rows, ci)).astype(np.float32)
    dy = rng.standard_normal((rows, co)).astype(np.float32)
    w = (rng.standard_normal((co, ci)) * ci ** -0.5).astype(np.float32)
    dx_ref, dw_ref = _fused1x1_bwd_pallas(jnp.asarray(x), jnp.asarray(dy),
                                          jnp.asarray(w))
    t = torch.from_numpy
    dx, dw = tfu.conv1x1_bwd_tf32x3(t(x), t(dy), t(w).reshape(co, 1, 1, ci),
                                    passes=passes)
    errs = [_rel(dx, dx_ref), _rel(dw.reshape(co, ci), dw_ref)]
    if passes == 3:
        assert max(errs) <= TOL, errs
    else:
        assert errs[0] > TOL, errs


def _mma_running_c(a, b, splits, chunk):
    """``_mm_tf32(exact=True)`` without promotion: every MMA of a chunk
    takes the chunk's running sum as its C operand (and rounds it toward
    zero with its products)."""
    ah, bh = tfu._tf32(a), tfu._tf32(b)
    al, bl = tfu._tf32(a - ah), tfu._tf32(b - bh)
    total = None
    for z in range(splits):
        acc = a.new_zeros((a.shape[0], b.shape[1]))
        for k0 in range(z * chunk, min(a.shape[1], (z + 1) * chunk), 8):
            ks = slice(k0, k0 + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                acc = tfu._mma_step(acc, x[:, ks], y[ks])
        total = acc if total is None else total + acc
    return total


def test_promotion_bounds_the_drift_of_a_long_sum():
    """A (16, 16384) @ (16384, 8) product of positive values, shaped as a
    weight gradient and split by its own plan (``mma_wgrad_plan``), as the
    card's MMAs round (``exact``): with each k tile summed from zero and
    promoted in f32, the error against f64 is at most 4x f32
    ``torch.matmul``'s; with every MMA taking the running sum as C it is
    not (the toward-zero rounding accumulates along the axis)."""
    rng = _rng()
    a = torch.from_numpy(rng.random((16, 16384), dtype=np.float32))
    b = torch.from_numpy(rng.random((16384, 8), dtype=np.float32))
    _, _, splits, chunk = _cuda.mma_wgrad_plan(16, 8, 16384)
    want = torch.matmul(a.double(), b.double())
    matmul = _rel(torch.matmul(a, b), want)
    promoted = _rel(tfu._mm_tf32(a, b, splits, chunk, exact=True), want)
    running = _rel(_mma_running_c(a, b, splits, chunk), want)
    assert promoted <= 4 * matmul, (promoted, matmul)
    assert running > 4 * matmul, (running, matmul)


def _main_path_shapes():
    """(kernel, rows, ci, co, side) of every K1-K8 launch on the main path:
    the fused units of ResNet-50 at its four stages; K1 (rows, C, C/4), K2
    (rows, C/4, C), K3 and K4 (rows, C/4, C/4) served at batch 8 and
    trained at batch 32, K5 trained (and driven imperatively) at batch
    32 at conv3 (rows, C/4, C) and conv1 (rows, C, C/4), K6 and K7 trained
    at batch 32 at conv2 (rows, C/4, C/4) on side x side images; K8 at its
    three transition sites."""
    for (hw, c, _), side in zip(SMOKE.STAGES, SMOKE.STAGE_HW):
        for batch in (SMOKE.BATCH, SMOKE.TRAIN_BATCH):
            yield "K1", batch * hw, c, c // 4, side
            yield "K2", batch * hw, c // 4, c, side
            yield "K3", batch * hw, c // 4, c // 4, side
            yield "K4", batch * hw, c // 4, c // 4, side
        rows = SMOKE.TRAIN_BATCH * hw
        yield "K5", rows, c // 4, c, side
        yield "K5", rows, c, c // 4, side
        yield "K6", rows, c // 4, c // 4, side
        yield "K7", rows, c // 4, c // 4, side
    for _, hw, ci, co in SMOKE.K8_SITES:
        yield "K8", SMOKE.TRAIN_BATCH * hw, ci, co, None


def _plans(kernel, rows, ci, co, side, f32):
    """The (m, n, k) and plan of each product the kernel launches (K4's
    and K7's dgrad: k = ci or co channels, each over nine taps; K7's
    wgrad: a plan of its own, see ``test_k7_wgrad_plans_fill_the_card``)."""
    if kernel in ("K1", "K2"):
        return [((rows, co, ci), _cuda.mma_plan(rows, co, ci, f32))]
    if kernel == "K4":
        return [((rows, co, ci), _cuda.halo_fwd_plan(rows, ci, co, side,
                                                     f32))]
    if kernel == "K3":
        return [((rows, co, 9 * ci), _cuda.mma_plan(rows, co, 9 * ci, f32))]
    if kernel == "K7":
        return [((rows, ci, co), _cuda.halo_dgrad_plan(rows, ci, co, side,
                                                         f32))]
    taps = 9 if kernel == "K6" else 1
    return [((rows, ci, taps * co), _cuda.mma_plan(rows, ci, taps * co,
                                                    f32)),
            ((co, taps * ci, rows), _cuda.mma_wgrad_plan(co, taps * ci,
                                                         rows))]


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_plans_are_pure_functions_of_the_shapes(monkeypatch, f32):
    """Every main-path plan is legal, gives blocks to at least 3/4 of the
    SMs, and does not look at the device: the same with no card; K4's
    halo leaves two blocks an SM, as K7's dgrad's does."""
    plans = {shape: _plans(*shape, f32) for shape in _main_path_shapes()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for shape, got in plans.items():
        assert got == _plans(*shape, f32)
        for (m, n, k), (bm, bn, splits, chunk) in got:
            assert (bm, bn) in _cuda.MMA_TILES
            assert not (f32 and (bm, bn) == (128, 128))
            assert bn == 64 if n <= 64 else bn == 128
            assert chunk % _cuda.MMA_K_ALIGN == 0
            assert (splits - 1) * chunk < k <= splits * chunk
            blocks = -(-m // bm) * -(-n // bn) * splits
            assert blocks >= 0.75 * _cuda.MMA_BLOCKS, \
                (m, n, k, bm, bn, splits, chunk)
        if shape[0] == "K4":
            assert _cuda.halo_fwd_smem(bm, bn, shape[4], f32) \
                <= _cuda.SMEM_TWO_BLOCKS


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_k7_wgrad_plans_fill_the_card(monkeypatch, f32):
    """K7's wgrad plans at the main-path shapes: whole bands a chunk, the
    chunks cover the pixels, at least 3/4 of the SMs get blocks, and no
    plan looks at the device; its dgrad's halo leaves two blocks an SM."""
    shapes = [s for s in _main_path_shapes() if s[0] == "K7"]
    plans = {s: (_cuda.halo_wgrad_plan(s[1], s[2], s[3], f32),
                 _cuda.halo_dgrad_plan(s[1], s[2], s[3], s[4], f32))
             for s in shapes}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    band = _cuda.halo_wgrad_band(f32)
    tile = _cuda.HALO_WGRAD_TILE
    for (_, rows, ci, co, side), ((splits, chunk), dplan) in plans.items():
        assert (splits, chunk) == _cuda.halo_wgrad_plan(rows, ci, co, f32)
        assert chunk % band == 0
        assert (splits - 1) * chunk < rows <= splits * chunk
        blocks = -(-ci // tile) * -(-co // tile) * splits
        assert blocks >= 0.75 * _cuda.MMA_BLOCKS, (rows, ci, co, splits)
        assert _cuda.halo_dgrad_smem(dplan[0], dplan[1], side, f32) \
            <= _cuda.SMEM_TWO_BLOCKS


@contextlib.contextmanager
def _launch_captured(monkeypatch):
    """The wrappers' CUDA path on meta tensors, each launch captured
    instead of made."""
    calls = []
    for mod in (tfu, tnn):
        monkeypatch.setattr(mod, "on_host", lambda t: False)
        monkeypatch.setattr(mod, "check", lambda *a, **k: None)
        monkeypatch.setattr(mod, "stream", lambda dev: None)
        monkeypatch.setattr(mod, "launch", lambda name, *a: calls.append(
            (name, a)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    yield calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_wrappers_allocate_the_plans_scratch(monkeypatch, dtype):
    """At every main-path shape, the scratch and plan the wrappers of
    K1-K8 pass to the kernel are those mm_fwd_buffers (K1, and K2 without
    statistics), c3_fwd2d_buffers, c3_fwd4d_buffers, mm_bwd_buffers,
    c3_bwd2d_buffers, c3_bwd4d_buffers and conv1x1_bwd_buffers give for
    the shapes."""
    f32 = dtype == torch.float32

    def m(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    def same(got, want):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.shape == w.shape
                assert g.dtype == torch.float32

    with _launch_captured(monkeypatch) as calls:
        for kernel, rows, ci, co, side in _main_path_shapes():
            v = m(ci, dt=torch.float32)
            if kernel == "K2":
                y = tfu.mm_skip_fwd(m(rows, ci), m(co, 1, 1, ci), v, v,
                                    m(rows, co))
                name, a = calls.pop()
                plan, ws = tfu.mm_fwd_buffers(rows, ci, co, False, "meta",
                                              f32)[:2]
                assert name == "fu_mm_skip_fwd" and a[11:15] == plan
                assert a[7:10] == (rows, ci, co) and y.shape == (rows, co)
                same((a[6],), (ws,))
                continue
            if kernel == "K4":
                n = rows // (side * side)
                for stats in (True, False):
                    y, _, _ = tfu.c3_fwd4d(m(n, side, side, ci),
                                           m(co, 3, 3, ci), v, v, stats)
                    name, a = calls.pop()
                    plan, ws, part, s, ss = tfu.c3_fwd4d_buffers(
                        n, side, side, ci, co, stats, "meta", f32)
                    assert name == "fu_c3_fwd4d" and a[16:20] == plan
                    assert a[9:14] == (n, side, side, ci, co)
                    assert y.shape == (n, side, side, co)
                    same((a[5], a[6], a[7], a[8]), (part, s, ss, ws))
                continue
            if kernel == "K3":
                n = rows // (side * side)
                for stats in (True, False):
                    tfu.c3_fwd2d(m(rows, ci), m(co, 3, 3, ci), v, v, n,
                                 side, side, stats)
                    name, a = calls.pop()
                    plan, ws, part, s, ss = tfu.c3_fwd2d_buffers(
                        rows, ci, co, stats, "meta", f32)
                    assert name == "fu_c3_fwd2d" and a[16:20] == plan
                    assert a[9:14] == (rows, ci, co, side, side)
                    same((a[5], a[6], a[7], a[8]), (part, s, ss, ws))
                continue
            if kernel == "K7":
                fin = (m(co, dt=torch.float32),) * 3
                nhwc = (rows // (side * side), side, side)
                n = nhwc[0]
                dp, dw, _, _ = tfu.c3_bwd4d(
                    m(*nhwc, co), m(*nhwc, co), fin, m(*nhwc, ci),
                    m(co, 3, 3, ci), v, v, v, v)
                name, a = calls.pop()
                dplan, wplan, part, db, dg, dws, dwb, wpart = \
                    tfu.c3_bwd4d_buffers(n, side, side, ci, co, "meta", f32)
                assert name == "fu_c3_bwd4d"
                assert a[24:28] == dplan and a[28:30] == wplan
                assert a[18:23] == (n, side, side, ci, co)
                same(a[12:18], (part, db, dg, dwb, wpart, dws))
                assert dp.shape == (*nhwc, ci) and dw.shape == (co, 3, 3, ci)
                continue
            if kernel == "K6":
                fin = (m(co, dt=torch.float32),) * 3
                dp, dw, _, _ = tfu.c3_bwd2d(
                    m(rows, co), m(rows, co), fin, m(rows, ci),
                    m(co, 3, 3, ci), v, v, v, v, SMOKE.TRAIN_BATCH, side,
                    side)
                name, a = calls.pop()
                dplan, wplan, part, db, dg, dws, dwb, wpart = \
                    tfu.c3_bwd2d_buffers(rows, ci, co, "meta", f32)
                assert name == "fu_c3_bwd2d"
                assert a[24:28] == dplan and a[28:32] == wplan
                assert a[18:23] == (rows, ci, co, side, side)
                same(a[12:18], (part, db, dg, dwb, wpart, dws))
                assert dw.shape == (co, 3, 3, ci)
                continue
            if kernel == "K8":
                tnn.conv1x1_bwd(m(rows, ci), m(rows, co), m(co, 1, 1, ci))
                name, a = calls.pop()
                dplan, wplan, dws, dwb, wpart = tnn.conv1x1_bwd_buffers(
                    rows, ci, co, "meta", f32)
                assert name == "nn_conv1x1_bwd"
                assert a[11:15] == dplan and a[15:19] == wplan
                same(a[4:7], (dwb, wpart, dws))
                continue
            for stats in (True, False):
                tfu.mm_fwd(m(rows, ci), m(co, 1, 1, ci), v, v, stats)
                name, a = calls.pop()
                plan, ws, part, s, ss = tfu.mm_fwd_buffers(
                    rows, ci, co, stats, "meta", f32)
                assert name == "fu_mm_fwd" and a[14:18] == plan
                same((a[5], a[6], a[7], a[8]), (part, s, ss, ws))
            fin = (m(co, dt=torch.float32),) * 3
            for f, yraw in ((None, None), (fin, m(rows, co))):
                tfu.mm_bwd(m(rows, co), yraw, f, m(rows, ci),
                           m(co, 1, 1, ci), v, v, v, v)
                name, a = calls.pop()
                dplan, wplan, part, db, dg, dws, dw, wpart = \
                    tfu.mm_bwd_buffers(rows, ci, co, "meta", f32)
                assert name == "fu_mm_bwd"
                assert a[23:27] == dplan and a[27:31] == wplan
                same(a[12:18], (part, db, dg, dw, wpart, dws))
        assert not calls
