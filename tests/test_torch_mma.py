"""K1's and K5's tensor-core arithmetic and tiling, emulated on the CPU.

The CUDA kernels (csrc/fu_mma.cuh) compute float32 products as 3xTF32 on
the tensor cores, over output tiles and splits of the summed axis chosen
in Python from the shapes alone.  Here:

- ``_tf32`` rounds as ``cvt.rna.tf32.f32`` on crafted bit patterns;
- ``mm_fwd_tf32x3`` / ``mm_bwd_tf32x3``, which walk the kernels' splits
  in their order, against the JAX package's ``_mm_fwd`` / ``_mm_bwd`` (in
  interpret mode, as its own tests run them) at ResNet-50's stage-4 depth,
  within chip_smoke.py's float32 tolerance; a single TF32 pass fails it;
- the tile and split plans: pure functions of the shapes at every
  main-path shape, and the scratch the wrappers allocate from them.

tests/test_torch_kernels.py holds the kernels themselves against the
plain versions on the card.
"""
import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mxnet_tpu.ops import fused_unit as jfu
from mxnet_tpu_torch.ops import _cuda
from mxnet_tpu_torch.ops import fused_unit as tfu

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


def _main_path_shapes():
    """(kernel, rows, ci, co) of every K1 and K5 launch on the main path:
    the fused units of ResNet-50 at its four stages; K1 (rows, C, C/4)
    served at batch 8 and trained at batch 32, K5 trained (and driven
    imperatively) at batch 32 at conv3 (rows, C/4, C) and conv1 (rows, C,
    C/4)."""
    for hw, c, _ in SMOKE.STAGES:
        for batch in (SMOKE.BATCH, SMOKE.TRAIN_BATCH):
            yield "K1", batch * hw, c, c // 4
        rows = SMOKE.TRAIN_BATCH * hw
        yield "K5", rows, c // 4, c
        yield "K5", rows, c, c // 4


def _plans(kernel, rows, ci, co, f32):
    """The (m, n, k) and plan of each product the kernel launches."""
    if kernel == "K1":
        return [((rows, co, ci), _cuda.mma_plan(rows, co, ci, f32))]
    return [((rows, ci, co), _cuda.mma_plan(rows, ci, co, f32)),
            ((co, ci, rows), _cuda.mma_wgrad_plan(co, ci, rows))]


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_plans_are_pure_functions_of_the_shapes(monkeypatch, f32):
    """Every main-path plan is legal, gives blocks to at least 3/4 of the
    SMs, and does not look at the device: the same with no card."""
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


@contextlib.contextmanager
def _launch_captured(monkeypatch):
    """The wrappers' CUDA path on meta tensors, each launch captured
    instead of made."""
    calls = []
    monkeypatch.setattr(tfu, "on_host", lambda t: False)
    monkeypatch.setattr(tfu, "check", lambda *a, **k: None)
    monkeypatch.setattr(tfu, "stream", lambda dev: None)
    monkeypatch.setattr(tfu, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    yield calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_wrappers_allocate_the_plans_scratch(monkeypatch, dtype):
    """At every main-path shape, the scratch and plan K1's and K5's
    wrappers pass to the kernel are those mm_fwd_buffers and
    mm_bwd_buffers give for the shapes."""
    f32 = dtype == torch.float32

    def m(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    with _launch_captured(monkeypatch) as calls:
        for _, rows, ci, co in _main_path_shapes():
            v = m(ci, dt=torch.float32)
            for stats in (True, False):
                tfu.mm_fwd(m(rows, ci), m(co, 1, 1, ci), v, v, stats)
                name, a = calls.pop()
                plan, ws, part, s, ss = tfu.mm_fwd_buffers(
                    rows, ci, co, stats, "meta", f32)
                assert name == "fu_mm_fwd" and a[14:18] == plan
                for got, want in zip((a[5], a[6], a[7], a[8]),
                                     (part, s, ss, ws)):
                    assert (got is None) == (want is None)
                    if want is not None:
                        assert got.shape == want.shape
                        assert got.dtype == torch.float32
            fin = (m(co, dt=torch.float32),) * 3
            for f, yraw in ((None, None), (fin, m(rows, co))):
                tfu.mm_bwd(m(rows, co), yraw, f, m(rows, ci),
                           m(co, 1, 1, ci), v, v, v, v)
                name, a = calls.pop()
                dplan, wplan, part, db, dg, dws, dw, wpart = \
                    tfu.mm_bwd_buffers(rows, ci, co, "meta", f32)
                assert name == "fu_mm_bwd"
                assert a[23:27] == dplan and a[27:31] == wplan
                for got, want in zip(a[12:18], (part, db, dg, dw, wpart,
                                                dws)):
                    assert (got is None) == (want is None)
                    if want is not None:
                        assert got.shape == want.shape
                        assert got.dtype == torch.float32
        assert not calls
