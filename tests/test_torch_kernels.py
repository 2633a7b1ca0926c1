"""The CUDA kernels of the fused bottleneck unit (K1-K7), the
1x1-convolution backward (K8), the KV-cache writes (K9, K10) and kernels
written at run time through ``rtc.CudaModule`` (K11) against their plain
PyTorch versions.

The tests marked ``cuda`` need a card and skip where there is none. This
file imports neither JAX nor the JAX package, so on a machine that has no
JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cache as kv
from mxnet_tpu_torch.ops import fused_unit as fu
from mxnet_tpu_torch.ops import nn

# (n, h, w, c): the JAX package's fused-unit cases, a ResNet-50 stage-4
# unit at batch 2, and a width that is a multiple of 4 but not of the tile
CASES = [(2, 8, 8, 32), (3, 7, 5, 16), (2, 14, 14, 64), (2, 7, 7, 2048),
         (1, 5, 6, 48)]
# f32: the kernel and the plain version sum the same f32 products in
# another order.  bf16: the output is rounded once to bf16 (2^-8 relative)
# from sums that differ in the last f32 bits, so one bf16 step apart.
CARD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}


def _inputs(case, device, dtype):
    n, h, w, c = case
    cq = c // 4
    g = torch.Generator().manual_seed(n * 1000 + h * 100 + w * 10 + c)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g)  # noqa: E731
                               * scale).to(device)
    rows = n * h * w
    x, y1 = r(rows, c).to(dtype), r(rows, cq).to(dtype)
    w1 = r(cq, 1, 1, c, scale=c ** -0.5).to(dtype)
    w2 = r(cq, 3, 3, cq, scale=(9 * cq) ** -0.5).to(dtype)
    w3 = r(c, 1, 1, cq, scale=cq ** -0.5).to(dtype)
    sc, sh = r(c).abs() + 0.5, r(c, scale=0.3)
    sc2, sh2 = r(cq).abs() + 0.5, r(cq, scale=0.3)
    return x, y1, w1, w2, w3, sc, sh, sc2, sh2


def test_wrappers_on_meta_tensors_take_plain_version():
    """Shape inference runs the op on meta tensors: no launch, right
    shapes."""
    before = [k.launches for k in fu.KERNEL_WRAPPERS]
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    y, s, ss = fu.mm_fwd(m(98, 256), m(64, 1, 1, 256), m(256), m(256), True)
    assert y.shape == (98, 64) and y.device.type == "meta"
    assert s.shape == ss.shape == (64,)
    y2 = fu.c3_fwd2d(m(98, 64), m(64, 3, 3, 64), m(64), m(64), 2, 7, 7)[0]
    assert y2.shape == (98, 64)
    y3 = fu.mm_skip_fwd(m(98, 64), m(256, 1, 1, 64), m(64), m(64),
                        m(98, 256))
    assert y3.shape == (98, 256)
    dp, dw, db, dg = fu.mm_bwd(m(98, 64), m(98, 64), (m(64),) * 3,
                               m(98, 256), m(64, 1, 1, 256), *(m(256),) * 4)
    assert dp.shape == (98, 256) and dw.shape == (64, 256)
    assert db.shape == dg.shape == (256,)
    dp, dw, _, _ = fu.c3_bwd2d(m(98, 64), m(98, 64), (m(64),) * 3,
                               m(98, 64), m(64, 3, 3, 64), *(m(64),) * 4,
                               2, 7, 7)
    assert dp.shape == (98, 64) and dw.shape == (64, 3, 3, 64)
    dx, dw = nn.conv1x1_bwd(m(98, 256), m(98, 64), m(64, 1, 1, 256))
    assert dx.shape == (98, 256) and dw.shape == (64, 1, 1, 256)
    assert [k.launches for k in fu.KERNEL_WRAPPERS] == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain_on_card(cuda_device, case, dtype):
    dt = getattr(torch, dtype)
    n, h, w, _ = case
    x, y1, w1, w2, w3, sc, sh, sc2, sh2 = _inputs(case, cuda_device, dt)
    calls = [(fu.mm_fwd, fu.mm_fwd_plain, (x, w1, sc, sh, True)),
             (fu.mm_fwd, fu.mm_fwd_plain, (x, w1, sc, sh, False)),
             (fu.c3_fwd2d, fu.c3_fwd2d_plain,
              (y1, w2, sc2, sh2, n, h, w, True)),
             (fu.c3_fwd2d, fu.c3_fwd2d_plain,
              (y1, w2, sc2, sh2, n, h, w, False)),
             (fu.mm_skip_fwd, fu.mm_skip_fwd_plain, (y1, w3, sc2, sh2, x))]
    for kernel, plain, args in calls:
        before = kernel.launches
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, r in zip(got, want):
            if r is None:
                assert g is None
                continue
            assert g.dtype == r.dtype and g.shape == r.shape
            assert g.device == cuda_device
            scale = float(r.float().abs().max())
            err = float((g.float() - r.float()).abs().max()) / scale
            assert err <= CARD_TOL[dt], (kernel.__name__, err)


@pytest.mark.cuda
def test_kernel_results_repeat_bitwise_on_card(cuda_device):
    """No atomics: the same inputs give the same bits, statistics too."""
    case = (2, 14, 14, 256)
    n, h, w, _ = case
    x, y1, w1, w2, _, sc, sh, sc2, sh2 = _inputs(case, cuda_device,
                                                 torch.float32)
    for kernel, args in ((fu.mm_fwd, (x, w1, sc, sh, True)),
                         (fu.c3_fwd2d, (y1, w2, sc2, sh2, n, h, w, True))):
        first, second = kernel(*args), kernel(*args)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs_on_card(cuda_device):
    x = torch.zeros(64, 32, device=cuda_device)
    w = torch.zeros(8, 1, 1, 32, device=cuda_device)
    v = torch.ones(32, device=cuda_device)
    with pytest.raises(MXNetError, match="dtype"):
        fu.mm_fwd(x, w.double(), v, v)
    with pytest.raises(MXNetError, match="contiguous"):
        fu.mm_fwd(torch.zeros(32, 64, device=cuda_device).t(), w, v, v)
    with pytest.raises(MXNetError, match="disagree"):
        fu.mm_fwd(x, w, v[:16], v)
    with pytest.raises(MXNetError, match="multiples of 4"):
        fu.mm_fwd(torch.zeros(64, 30, device=cuda_device),
                  torch.zeros(8, 1, 1, 30, device=cuda_device),
                  v[:30], v[:30])


def _bwd_inputs(case, device, dtype):
    """Backward inputs of the unit's three convs: conv3 (final cotangent
    g3), conv2 (deferred from bn3) and conv1 (deferred from bn2)."""
    n, h, w, c = case
    cq = c // 4
    g = torch.Generator().manual_seed(n * 1000 + h * 100 + w * 10 + c + 1)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g)  # noqa: E731
                               * scale).to(device)
    rows = n * h * w
    t = dict(x=r(rows, c), y1=r(rows, cq), y2=r(rows, cq), g3=r(rows, c),
             dpn=r(rows, cq), w1=r(cq, 1, 1, c, scale=c ** -0.5),
             w2=r(cq, 3, 3, cq, scale=(9 * cq) ** -0.5),
             w3=r(c, 1, 1, cq, scale=cq ** -0.5))
    t = {k: v.to(dtype) for k, v in t.items()}
    for name, width in (("c", c), ("q", cq)):
        t["sc" + name], t["sh" + name] = r(width).abs() + 0.5, r(width) * 0.3
        t["xs" + name], t["xh" + name] = r(width).abs() + 0.5, r(width) * 0.3
        t["fin" + name] = (r(width).abs() + 0.5, r(width) * 0.1,
                           r(width) * 0.1)
    return t


def _bwd_calls(case, t):
    n, h, w, _ = case
    vq = (t["scq"], t["shq"], t["xsq"], t["xhq"])
    vc = (t["scc"], t["shc"], t["xsc"], t["xhc"])
    return [
        (fu.mm_bwd, fu.mm_bwd_plain,
         (t["g3"], None, None, t["y2"], t["w3"]) + vq),
        (fu.c3_bwd2d, fu.c3_bwd2d_plain,
         (t["dpn"], t["y2"], t["finq"], t["y1"], t["w2"]) + vq + (n, h, w)),
        (fu.mm_bwd, fu.mm_bwd_plain,
         (t["dpn"], t["y1"], t["finq"], t["x"], t["w1"]) + vc),
        (nn.conv1x1_bwd, nn.conv1x1_bwd_plain, (t["x"], t["dpn"], t["w1"])),
    ]


# dP / dx: as the forward outputs.  dW, db, dg: f32 sums over every row in
# another order (bf16 products are exact in f32), so an f32 bound in both
# dtypes, except K8's dW, which the wrapper rounds to the weight's dtype.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_backward_kernels_match_plain_on_card(cuda_device, case, dtype):
    dt = getattr(torch, dtype)
    t = _bwd_inputs(case, cuda_device, dt)
    for kernel, plain, args in _bwd_calls(case, t):
        before = kernel.launches
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for i, (g, r) in enumerate(zip(got, want)):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert g.device == cuda_device
            tol = CARD_TOL[dt] if i == 0 or kernel is nn.conv1x1_bwd \
                else BWD_TOL[dt]
            scale = float(r.float().abs().max())
            err = float((g.float() - r.float()).abs().max()) / scale
            assert err <= tol, (kernel.__name__, i, err)


@pytest.mark.cuda
def test_backward_kernels_repeat_bitwise_on_card(cuda_device):
    """No atomics, fixed split of the wgrad's rows: the same bits twice,
    at a shape whose wgrad is split (stage 1 of ResNet-50 at batch 2)."""
    case = (2, 56, 56, 256)
    t = _bwd_inputs(case, cuda_device, torch.float32)
    for kernel, _plain, args in _bwd_calls(case, t):
        for a, b in zip(kernel(*args), kernel(*args)):
            assert torch.equal(a, b), kernel.__name__


# K1, K5 and K8 on the tensor-core tiles (csrc/fu_mma.cuh), as (rows, ci,
# co): rows that are no multiple of any tile, channels of 4 mod 8 and 4 mod
# 16 (36, 100) where a k step is 8 (tf32) or 16 (bf16), a split of the
# wgrad's rows (3000) and of the dgrad's channels (ResNet-50 stage 4 at
# batch 8: 392 rows, 2048 and 512 channels)
MMA_CASES = [(50, 36, 100), (3000, 100, 36), (392, 2048, 512)]


def _mma_calls(case, device, dtype):
    rows, ci, co = case
    g = torch.Generator().manual_seed(rows + 7 * ci + 31 * co)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g)  # noqa: E731
                               * scale).to(device)
    x, gc, yraw = r(rows, ci).to(dtype), r(rows, co).to(dtype), \
        r(rows, co).to(dtype)
    w = r(co, 1, 1, ci, scale=ci ** -0.5).to(dtype)
    wt = r(ci, 1, 1, co, scale=co ** -0.5).to(dtype)
    sc, sh, xs, xh = r(ci).abs() + 0.5, r(ci) * 0.3, r(ci).abs() + 0.5, \
        r(ci) * 0.3
    fin = (r(co).abs() + 0.5, r(co) * 0.1, r(co) * 0.1)
    return [(fu.mm_fwd, fu.mm_fwd_plain, (x, w, sc, sh, True)),
            (fu.mm_fwd, fu.mm_fwd_plain, (gc, wt, r(co).abs() + 0.5,
                                          r(co) * 0.3, False)),
            (fu.mm_bwd, fu.mm_bwd_plain, (gc, None, None, x, w, sc, sh, xs,
                                          xh)),
            (fu.mm_bwd, fu.mm_bwd_plain, (gc, yraw, fin, x, w, sc, sh, xs,
                                          xh))]


def test_mma_cases_cover_ragged_and_split_plans():
    from mxnet_tpu_torch.ops import _cuda
    plans = [(_cuda.mma_plan(rows, co, ci), _cuda.mma_plan(rows, ci, co),
              _cuda.mma_wgrad_plan(co, ci, rows))
             for rows, ci, co in MMA_CASES]
    assert any(p[0][2] > 1 for p in plans)       # K1 split
    assert any(p[1][2] > 1 for p in plans)       # K5 dgrad split
    assert any(p[2][2] > 1 for p in plans)       # K5 wgrad split
    assert any(ci % 16 == 4 and co % 8 == 4 for _, ci, co in MMA_CASES)
    assert any(rows % 64 for rows, _, _ in MMA_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MMA_CASES)
def test_mma_kernels_match_plain_and_repeat_on_card(cuda_device, case,
                                                    dtype):
    """K1 (with and without statistics) and K5 (final and deferred) on
    ragged and split shapes: within the tolerances above of their plain
    versions, and the same bits from a second launch."""
    dt = getattr(torch, dtype)
    for kernel, plain, args in _mma_calls(case, cuda_device, dt):
        before = kernel.launches
        got, want, again = kernel(*args), plain(*args), kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        for i, (g, r, a) in enumerate(zip(got, want, again)):
            if r is None:
                assert g is None and a is None
                continue
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.equal(g, a), (kernel.__name__, i)
            tol = CARD_TOL[dt] if i == 0 or kernel is fu.mm_fwd \
                else BWD_TOL[dt]
            scale = float(r.float().abs().max())
            err = float((g.float() - r.float()).abs().max()) / scale
            assert err <= tol, (kernel.__name__, i, err)


# K6 on the tensor-core tiles, as (n, h, w, ci, co): channels of 36 and 100,
# rows off every tile, a split of its dgrad's k = (tap, o) (stage 3's
# width at batch 1) and of its wgrad's rows (1568 rows)
C3_MMA_CASES = [(2, 5, 7, 36, 100), (3, 6, 7, 100, 36), (1, 14, 14, 256, 256),
                (2, 28, 28, 36, 100)]


def _k6_k8_calls(device, dtype):
    """K6 at C3_MMA_CASES and K8 at MMA_CASES, on inputs from a seed."""
    calls = []
    for n, h, w, ci, co in C3_MMA_CASES:
        rows = n * h * w
        g = torch.Generator().manual_seed(rows + 7 * ci + 31 * co)
        r = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
            *s, generator=g) * scale).to(device)
        args = (r(rows, co).to(dtype), r(rows, co).to(dtype),
                (r(co).abs() + 0.5, r(co) * 0.1, r(co) * 0.1),
                r(rows, ci).to(dtype),
                r(co, 3, 3, ci, scale=(9 * ci) ** -0.5).to(dtype),
                r(ci).abs() + 0.5, r(ci) * 0.3, r(ci).abs() + 0.5,
                r(ci) * 0.3, n, h, w)
        calls.append((fu.c3_bwd2d, fu.c3_bwd2d_plain, args))
    for rows, ci, co in MMA_CASES:
        g = torch.Generator().manual_seed(rows + 7 * ci + 31 * co + 1)
        r = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
            *s, generator=g) * scale).to(device).to(dtype)
        calls.append((nn.conv1x1_bwd, nn.conv1x1_bwd_plain,
                      (r(rows, ci), r(rows, co),
                       r(co, 1, 1, ci, scale=ci ** -0.5))))
    return calls


def test_k6_k8_cases_cover_ragged_and_split_plans():
    from mxnet_tpu_torch.ops import _cuda
    k6 = [(_cuda.mma_plan(n * h * w, ci, 9 * co),
           _cuda.mma_wgrad_plan(co, 9 * ci, n * h * w))
          for n, h, w, ci, co in C3_MMA_CASES]
    k8 = [(_cuda.mma_plan(rows, ci, co), _cuda.mma_wgrad_plan(co, ci, rows))
          for rows, ci, co in MMA_CASES]
    for plans in (k6, k8):
        assert any(d[2] > 1 for d, _ in plans)    # dgrad split
        assert any(w[2] > 1 for _, w in plans)    # wgrad split
    assert any(ci % 16 == 4 and co % 8 == 4 for _, _, _, ci, co in
               C3_MMA_CASES)
    assert all(n * h * w % 64 for n, h, w, _, _ in C3_MMA_CASES[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_k8_on_mma_match_plain_and_repeat_on_card(cuda_device, dtype):
    """K6 and K8 on the tensor-core loop at ragged and split shapes:
    within the tolerances above of their plain versions, and the same bits
    from a second launch."""
    dt = getattr(torch, dtype)
    for kernel, plain, args in _k6_k8_calls(cuda_device, dt):
        before = kernel.launches
        got, want, again = kernel(*args), plain(*args), kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        for i, (g, r, a) in enumerate(zip(got, want, again)):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.equal(g, a), (kernel.__name__, i)
            tol = CARD_TOL[dt] if i == 0 or kernel is nn.conv1x1_bwd \
                else BWD_TOL[dt]
            scale = float(r.float().abs().max())
            err = float((g.float() - r.float()).abs().max()) / scale
            assert err <= tol, (kernel.__name__, args[-3:], i, err)


# K3 and K7 on the tensor cores, as (n, h, w, ci, co): channels of 36 and
# 100, ragged images (13 x 11, 7 x 7: rows and widths off every tile and
# band), a split of K3's k = 9 Ci and of K7's dgrad Co (stage 3's width
# at batch 1), of K7's wgrad pixels (1568 pixels), and images wider than
# K7's bands (140: the three-window halo in both products)
C3_TC_CASES = [(2, 13, 11, 36, 100), (3, 7, 7, 100, 36),
               (1, 14, 14, 256, 256), (2, 28, 28, 36, 100),
               (1, 3, 140, 36, 36)]


def _k3_k7_calls(device, dtype):
    """K3 (with and without statistics) and K7 at C3_TC_CASES, on inputs
    from a seed."""
    calls = []
    for n, h, w, ci, co in C3_TC_CASES:
        rows = n * h * w
        g = torch.Generator().manual_seed(rows + 3 * ci + 17 * co)
        r = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
            *s, generator=g) * scale).to(device)
        x, wt = r(rows, ci).to(dtype), \
            r(co, 3, 3, ci, scale=(9 * ci) ** -0.5).to(dtype)
        vec = (r(ci).abs() + 0.5, r(ci) * 0.3)
        for stats in (True, False):
            calls.append((fu.c3_fwd2d, fu.c3_fwd2d_plain,
                          (x, wt, *vec, n, h, w, stats)))
        nhwc = (n, h, w)
        calls.append((fu.c3_bwd4d, fu.c3_bwd4d_plain,
                      (r(*nhwc, co).to(dtype), r(*nhwc, co).to(dtype),
                       (r(co).abs() + 0.5, r(co) * 0.1, r(co) * 0.1),
                       x.reshape(*nhwc, ci), wt) + vec
                      + (r(ci).abs() + 0.5, r(ci) * 0.3)))
    return calls


def test_k3_k7_cases_cover_ragged_split_and_wide_plans():
    from mxnet_tpu_torch.ops import _cuda
    k3 = [_cuda.mma_plan(n * h * w, co, 9 * ci)
          for n, h, w, ci, co in C3_TC_CASES]
    dg = [_cuda.halo_dgrad_plan(n * h * w, ci, co, w)
          for n, h, w, ci, co in C3_TC_CASES]
    wg = [_cuda.halo_wgrad_plan(n * h * w, ci, co)
          for n, h, w, ci, co in C3_TC_CASES]
    assert any(p[2] > 1 for p in k3)              # K3 split
    assert any(p[2] > 1 for p in dg)              # K7 dgrad split
    assert any(p[0] > 1 for p in wg)              # K7 wgrad split
    assert any(w > p[0] + 2 for p, (_, _, w, _, _) in zip(dg, C3_TC_CASES))
    assert any(w > _cuda.halo_wgrad_band() + 2
               for _, _, w, _, _ in C3_TC_CASES)  # three-window halos
    assert {36, 100} <= {c for case in C3_TC_CASES for c in case[3:]}
    assert any(n * h * w % 64 and w % 8 for n, h, w, _, _ in C3_TC_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_k7_on_mma_match_plain_and_repeat_on_card(cuda_device, dtype):
    """K3 and K7 on the tensor cores at ragged, split and wide shapes:
    within the tolerances above of their plain versions (K3's statistics
    at K7's f32-sum bound), and the same bits from a second launch."""
    dt = getattr(torch, dtype)
    for kernel, plain, args in _k3_k7_calls(cuda_device, dt):
        before = kernel.launches
        got, want, again = kernel(*args), plain(*args), kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        for i, (g, r, a) in enumerate(zip(got, want, again)):
            if r is None:
                assert g is None and a is None
                continue
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.equal(g, a), (kernel.__name__, i)
            tol = CARD_TOL[dt] if i == 0 else BWD_TOL[dt]
            if kernel is fu.c3_fwd2d and i:
                tol = 1e-4                  # f32 sums over every pixel
            scale = float(r.float().abs().max())
            err = float((g.float() - r.float()).abs().max()) / scale
            assert err <= tol, (kernel.__name__, tuple(args[3].shape), i,
                                err)


# K2 on the tensor cores, as (rows, ci, co): K4's cases' rows (286 and 147
# off every tile) and K2's stage-4 widths on 100 rows, whose k = 512 splits
K2_TC_CASES = [(n * h * w, ci, co) for n, h, w, ci, co in C3_TC_CASES] \
    + [(100, 512, 2048)]


def _k2_k4_calls(device, dtype):
    """K4 (with and without statistics) at C3_TC_CASES and K2 at
    K2_TC_CASES, on inputs from a seed."""
    calls = []
    for n, h, w, ci, co in C3_TC_CASES:
        g = torch.Generator().manual_seed(n * h * w + 5 * ci + 13 * co)
        r = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
            *s, generator=g) * scale).to(device)
        x = r(n, h, w, ci).to(dtype)
        wt = r(co, 3, 3, ci, scale=(9 * ci) ** -0.5).to(dtype)
        for stats in (True, False):
            calls.append((fu.c3_fwd4d, fu.c3_fwd4d_plain,
                          (x, wt, r(ci).abs() + 0.5, r(ci) * 0.3, stats)))
    for rows, ci, co in K2_TC_CASES:
        g = torch.Generator().manual_seed(rows + 11 * ci + 3 * co)
        r = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
            *s, generator=g) * scale).to(device)
        calls.append((fu.mm_skip_fwd, fu.mm_skip_fwd_plain,
                      (r(rows, ci).to(dtype),
                       r(co, 1, 1, ci, scale=ci ** -0.5).to(dtype),
                       r(ci).abs() + 0.5, r(ci) * 0.3,
                       r(rows, co).to(dtype))))
    return calls


def test_k2_k4_cases_cover_ragged_split_and_wide_plans():
    from mxnet_tpu_torch.ops import _cuda
    k4 = [_cuda.halo_fwd_plan(n * h * w, ci, co, w)
          for n, h, w, ci, co in C3_TC_CASES]
    k2 = [_cuda.mma_plan(rows, co, ci) for rows, ci, co in K2_TC_CASES]
    assert any(p[2] > 1 for p in k4)              # K4 split over Ci
    assert any(p[2] > 1 for p in k2)              # K2 split over Ci
    assert any(w > p[0] + 2 for p, (_, _, w, _, _) in zip(k4, C3_TC_CASES))
    assert any(rows % 64 for rows, _, _ in K2_TC_CASES)
    assert any(n * h * w % 64 and w % 8 for n, h, w, _, _ in C3_TC_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_k4_on_tensor_cores_match_plain_and_repeat_on_card(cuda_device,
                                                              dtype):
    """K2 and K4 on the tensor cores at ragged, split and wide shapes:
    within the tolerances above of their plain versions (K4's statistics
    at 1e-4, f32 sums over every pixel), and the same bits from a second
    launch."""
    dt = getattr(torch, dtype)
    for kernel, plain, args in _k2_k4_calls(cuda_device, dt):
        before = kernel.launches
        got, want, again = kernel(*args), plain(*args), kernel(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        if kernel is fu.mm_skip_fwd:
            got, want, again = (got,), (want,), (again,)
        for i, (g, r, a) in enumerate(zip(got, want, again)):
            if r is None:
                assert g is None and a is None
                continue
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.equal(g, a), (kernel.__name__, i)
            tol = CARD_TOL[dt] if i == 0 else 1e-4
            scale = float(r.float().abs().max())
            err = float((g.float() - r.float()).abs().max()) / scale
            assert err <= tol, (kernel.__name__, tuple(args[0].shape), i,
                                err)


@pytest.mark.cuda
def test_k3_k7_float32_equal_the_cpu_emulation_bitwise(cuda_device):
    """K3's y and K7's dP and dW in float32 (and K1's y, on the same loop,
    K2's y and K4's y) equal c3_fwd2d_tf32x3, c3_bwd4d_tf32x3,
    mm_fwd_tf32x3, mm_skip_fwd_tf32x3 and c3_fwd4d_tf32x3 with ``exact`` on
    the same inputs on the CPU, bit for bit: the 3xTF32 split, the k order,
    the split plan and each MMA's own rounding (fused_unit._mma_step) of
    the kernels."""
    calls = [c for c in _k3_k7_calls(cuda_device, torch.float32)
             if c[0] is fu.c3_bwd4d or c[2][-1]]
    calls += [c for c in _k2_k4_calls(cuda_device, torch.float32)
              if c[0] is fu.mm_skip_fwd or c[2][-1]]
    g = torch.Generator().manual_seed(1)
    r = lambda *s, scale=1.0: (torch.randn(  # noqa: E731
        *s, generator=g) * scale).to(cuda_device)
    calls.append((fu.mm_fwd, None, (r(286, 36), r(100, 1, 1, 36, scale=1 / 6),
                                    r(36).abs() + 0.5, r(36) * 0.3)))
    emulations = {fu.c3_fwd2d: fu.c3_fwd2d_tf32x3,
                  fu.c3_bwd4d: fu.c3_bwd4d_tf32x3,
                  fu.mm_fwd: fu.mm_fwd_tf32x3,
                  fu.mm_skip_fwd: fu.mm_skip_fwd_tf32x3,
                  fu.c3_fwd4d: fu.c3_fwd4d_tf32x3}
    for kernel, _plain, args in calls:
        got = kernel(*args)
        cpu = tuple(tuple(t.cpu() for t in a) if isinstance(a, tuple)
                    else a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args)
        emu = emulations[kernel](*cpu, exact=True)
        if kernel is fu.mm_skip_fwd:
            got, emu = (got,), (emu,)
        for i in (0, 1) if kernel is fu.c3_bwd4d else (0,):
            diff = (got[i].cpu() - emu[i]).abs()
            assert torch.equal(got[i].cpu(), emu[i]), \
                (kernel.__name__, tuple(cpu[0].shape), i,
                 float((diff > 0).float().mean()), float(diff.max()))


@pytest.mark.cuda
def test_tf32_emulation_matches_the_card_bitwise(cuda_device):
    """fused_unit._tf32 (the CPU tests' model of K1's and K5's split)
    against cvt.rna.tf32.f32 on the card, bit for bit, over a million
    values across the exponent range, ties and signed zeros; the
    instruction leaves the low 13 bits zero, as fu_mma.cuh assumes."""
    import mxnet_tpu_torch as mt
    mod = mt.rtc.CudaModule(r"""
extern "C" __global__ void cvt_tf32(const float* x, int* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x[i]));
    y[i] = (int)r;
  }
}""")
    kern = mod.get_kernel("cvt_tf32", "const float *x, int *y, int n")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1 << 20, generator=g) * torch.pow(
        10.0, torch.randint(-30, 30, (1 << 20,), generator=g).float())
    ties = torch.tensor([0x3F801000, 0xBF801000, 0x3FFFF000, 0, 1 << 31],
                        dtype=torch.int64).to(torch.int32).view(torch.float32)
    x = torch.cat([x, ties])
    n = x.numel()
    y = torch.empty(n, dtype=torch.int32, device=cuda_device)
    xd = x.to(cuda_device)
    kern.launch([xd, y, n], mt.gpu(0), ((n + 255) // 256,), (256,))
    torch.cuda.synchronize()
    got = y.cpu()
    assert bool(((got & 0x1FFF) == 0).all())
    assert torch.equal(got, fu._tf32(x).view(torch.int32))


# K9/K10: (slots, T, tail): the decoder's width d = 200 (16-byte rows in
# every dtype), the CPU tests' width, and an odd float16 row (scalar path)
KV_CASES = [(8, 128, (200,)), (4, 32, (16,)), (3, 9, (7,)), (2, 5, (3, 4))]


def _kv_inputs(case, device, dtype, k=3):
    n, T, tail = case
    g = torch.Generator().manual_seed(n * 100 + T)
    cache = torch.randn((n, T) + tail, generator=g).to(dtype).to(device)
    row = torch.randn((n,) + tail, generator=g).to(device)
    rows = torch.randn((n, k) + tail, generator=g).to(device)
    # edges: position 0, T-1, a window straddling the end, out of range
    pos = torch.tensor([[0, T - 1, T - 2, T + 3, -2, 1, T // 2, 3][i % 8]
                        for i in range(n)], dtype=torch.float32)
    count = torch.tensor([i % (k + 1) for i in range(n)],
                         dtype=torch.float32)
    return cache, row, rows, pos.to(device), count.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("case", KV_CASES)
def test_cache_writes_match_plain_bitwise_on_card(cuda_device, case, dtype):
    """The whole cache after K9 and after K10 equals the plain version's,
    bit for bit, with float32 and int32 positions; each launch counts."""
    dt = getattr(torch, dtype)
    cache, row, rows, pos, count = _kv_inputs(case, cuda_device, dt)
    for p in (pos, pos.to(torch.int32)):
        before = kv.cache_write_row.launches
        got = kv.cache_write_row(cache.clone(), row, p)
        want = kv.cache_write_row_plain(cache.clone(), row, p)
        torch.cuda.synchronize()
        assert kv.cache_write_row.launches == before + 1
        assert torch.equal(got, want)
        before = kv.cache_write_rows.launches
        got = kv.cache_write_rows(cache.clone(), rows, p, count)
        want = kv.cache_write_rows_plain(cache.clone(), rows, p, count)
        torch.cuda.synchronize()
        assert kv.cache_write_rows.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cache_writes_in_place_and_repeat_on_card(cuda_device):
    cache, row, rows, pos, count = _kv_inputs((8, 128, (200,)), cuda_device,
                                              torch.float32)
    a, b = cache.clone(), cache.clone()
    assert kv.cache_write_row(a, row, pos) is a
    assert kv.cache_write_rows(a, rows, pos, count) is a
    kv.cache_write_row(b, row, pos)
    kv.cache_write_rows(b, rows, pos, count)
    assert torch.equal(a, b)
    with pytest.raises(MXNetError, match="rows have shape"):
        kv.cache_write_row(a, row[:, :10], pos)
    with pytest.raises(MXNetError, match="index vector"):
        kv.cache_write_rows(a, rows, pos[:3], count)
    with pytest.raises(MXNetError, match="not supported"):
        kv.cache_write_row(a.double(), row, pos)


def test_4d_wrappers_on_meta_tensors_take_plain_version():
    """K4 and K7 on meta tensors (shape inference): NHWC shapes, OHWI
    weight gradient, no launch."""
    before = (fu.c3_fwd4d.launches, fu.c3_bwd4d.launches)
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    y, s, ss = fu.c3_fwd4d(m(2, 7, 5, 64), m(32, 3, 3, 64), m(64), m(64),
                           True)
    assert y.shape == (2, 7, 5, 32) and s.shape == ss.shape == (32,)
    assert fu.c3_fwd4d(m(2, 7, 5, 64), m(32, 3, 3, 64), m(64), m(64))[1] \
        is None
    dp, dw, db, dg = fu.c3_bwd4d(m(2, 7, 5, 32), m(2, 7, 5, 32),
                                 (m(32),) * 3, m(2, 7, 5, 64),
                                 m(32, 3, 3, 64), *(m(64),) * 4)
    assert dp.shape == (2, 7, 5, 64) and dw.shape == (32, 3, 3, 64)
    assert db.shape == dg.shape == (64,)
    assert (fu.c3_fwd4d.launches, fu.c3_bwd4d.launches) == before


def _4d_calls(case, device, dt):
    """K4 (with and without statistics) and K7 on one case's 3x3 shapes."""
    n, h, w, c = case
    cq = c // 4
    _, y1, _, w2, _, _, _, sc2, sh2 = _inputs(case, device, dt)
    t = _bwd_inputs(case, device, dt)
    nhwc = (n, h, w, cq)
    vq = (t["scq"], t["shq"], t["xsq"], t["xhq"])
    return [
        (fu.c3_fwd4d, fu.c3_fwd4d_plain,
         (y1.reshape(nhwc), w2, sc2, sh2, True)),
        (fu.c3_fwd4d, fu.c3_fwd4d_plain,
         (y1.reshape(nhwc), w2, sc2, sh2, False)),
        (fu.c3_bwd4d, fu.c3_bwd4d_plain,
         (t["dpn"].reshape(nhwc), t["y2"].reshape(nhwc), t["finq"],
          t["y1"].reshape(nhwc), t["w2"]) + vq),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_4d_kernels_match_plain_on_card(cuda_device, case, dtype):
    """K4 and K7 against their plain versions: outputs at the forward
    tolerances, K7's dW, db and dg at the backward ones."""
    dt = getattr(torch, dtype)
    for kernel, plain, args in _4d_calls(case, cuda_device, dt):
        before = kernel.launches
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for i, (g, r) in enumerate(zip(got, want)):
            if r is None:
                assert g is None
                continue
            assert g.dtype == r.dtype and g.shape == r.shape
            assert g.device == cuda_device
            tol = CARD_TOL[dt] if i == 0 or kernel is fu.c3_fwd4d \
                else BWD_TOL[dt]
            if kernel is fu.c3_fwd4d and i:
                tol = 1e-4                  # f32 sums over every pixel
            scale = float(r.float().abs().max())
            err = float((g.float() - r.float()).abs().max()) / scale
            assert err <= tol, (kernel.__name__, i, err)


@pytest.mark.cuda
def test_4d_kernels_repeat_bitwise_on_card(cuda_device):
    """No atomics, a wgrad split fixed by the shapes: the same bits twice
    at ResNet-50's stage-1 shape at batch 2."""
    for kernel, _plain, args in _4d_calls((2, 56, 56, 256), cuda_device,
                                          torch.float32):
        for a, b in zip(kernel(*args), kernel(*args)):
            if a is not None:
                assert torch.equal(a, b), kernel.__name__


RTC_SOURCE = r"""
extern "C" __global__ void add_one(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}
extern "C" __global__ void swish_fwd(const float* x, float* y, float* s,
                                     float beta, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float v = 1.0f / (1.0f + expf(-beta * x[i]));
    s[i] = v;
    y[i] = x[i] * v;
  }
}
extern "C" __global__ void swish_bwd(const float* x, const float* s,
                                     const float* g, float* dx, float beta,
                                     int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dx[i] = g[i] * (s[i] + beta * x[i] * s[i] * (1.0f - s[i]));
}
"""


@pytest.mark.cuda
def test_cuda_module_add_one_and_swish_on_card(cuda_device):
    """K11: add_one bit-equal to x + 1 from this thread and another, and a
    swish pair registered with vjp= whose gradient matches torch autograd
    on the formula."""
    import threading
    import mxnet_tpu_torch as mt
    mod = mt.rtc.CudaModule(RTC_SOURCE, exports=["add_one"])
    add_one = mod.get_kernel("add_one", "const float *x, float *y, int n")
    n = 1000003
    x = torch.randn(n, device=cuda_device)
    outs = [torch.empty_like(x) for _ in range(2)]

    def run(y):
        add_one.launch([x, y, n], mt.gpu(0), ((n + 255) // 256,), (256,))
        torch.cuda.synchronize()
    run(outs[0])
    th = threading.Thread(target=run, args=(outs[1],))
    th.start()
    th.join(timeout=120)
    assert not th.is_alive()
    for y in outs:
        assert torch.equal(y, x + 1)
    fwd = mod.get_kernel("swish_fwd", "const float *x, float *y, float *s, "
                                      "float beta, int n")
    bwd = mod.get_kernel("swish_bwd", "const float *x, const float *s, "
                                      "const float *g, float *dx, "
                                      "float beta, int n")

    def swish_fwd(a, beta=1.0):
        y, s = torch.empty_like(a), torch.empty_like(a)
        if a.device.type != "cuda":
            return y, (a, s)                # shape inference (meta)
        fwd.launch([a, y, s, beta, a.numel()], mt.gpu(0),
                   ((a.numel() + 255) // 256,), (256,))
        return y, (a, s)

    def swish_bwd(res, g, beta=1.0):
        a, s = res
        dx = torch.empty_like(a)
        bwd.launch([a, s, g.contiguous(), dx, beta, a.numel()], mt.gpu(0),
                   ((a.numel() + 255) // 256,), (256,))
        return (dx,)
    mt.rtc.register_kernel_op("card_swish",
                              lambda a, beta=1.0: swish_fwd(a, beta)[0],
                              vjp=(swish_fwd, swish_bwd),
                              params={"beta": mt.ops.P(float, 1.0)})
    xs = torch.randn(37, 50, device=cuda_device)
    g = torch.randn(37, 50, device=cuda_device)
    ex = mt.sym.card_swish(mt.sym.Variable("data"), beta=1.5).bind(
        mt.gpu(0), {"data": mt.nd.NDArray(xs.clone())})
    ex.forward(is_train=True)
    ex.backward(out_grads=[mt.nd.NDArray(g)])
    xt = xs.clone().requires_grad_(True)
    (xt * torch.sigmoid(1.5 * xt)).backward(g)
    got = ex.grad_dict["data"]._data
    assert float((got - xt.grad).abs().max()) \
        <= 1e-6 * float(xt.grad.abs().max())

