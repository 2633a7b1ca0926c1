"""Fused pre-activation bottleneck unit: hand-written CUDA forward kernels.

Counterpart of ``mxnet_tpu/ops/fused_unit.py``.  A stride-1 dim-match
bottleneck unit
    out = conv3(relu(bn3(conv2(relu(bn2(conv1(relu(bn1(data)))))))) + data
runs as three kernels that each normalize and ReLU their input in a
prologue, so the normalized activations never reach device memory:

- K1 ``mm_fwd``       y1 = relu(x*sc1+sh1) @ w1      (conv1, 1x1)
- K3 ``c3_fwd2d``     y2 = conv3x3(relu(y1*sc2+sh2)) (conv2)
- K2 ``mm_skip_fwd``  out = relu(y2*sc3+sh3) @ w3 + x (conv3 + residual)

Activations flow as (rows, C) with rows = n*h*w, the reference's 2D row
layout.  Weights stay in their OHWI checkpoint layout: the kernels read
(Co, Ci) and (Co, 3, 3, Ci) directly.  MXNET_FUSED_UNIT_C3=4d runs the
middle conv through the reference's other pair of 3x3 kernels instead, K4
``c3_fwd4d`` and K7 ``c3_bwd4d``, on the NHWC view of the same tensors
(one halo loop for both, with the shared operand resident in shared
memory).  The reference gates those by TPU scoped-VMEM budgets and sends
some stages to XLA; the port runs them at every width, as it does K3 and
K6.

In training mode K1 and K3 also return the batch statistics of their
output, and the unit is a ``torch.autograd.Function`` whose backward runs
the chain in reverse through two more kernels:

- K5 ``mm_bwd``       dgrad + wgrad of a 1x1 conv (conv3, then conv1)
- K6 ``c3_bwd2d``     dgrad + wgrad of the 3x3 conv (conv2; K7 in 4d mode)

each of which finalizes the next BatchNorm's backward in its prologue,
masks by the recomputed ReLU and takes its own BatchNorm's reductions in
its epilogue, so neither normalized activations nor their gradients reach
device memory.

Each kernel has, beside it here, its plain PyTorch version (the same
arithmetic: prologue in f32, rounded to the data type before the product,
f32 accumulation, one rounding of the output), a launch counter
(``<wrapper>.launches``) and a note on what it replaces.  A wrapper uses
the plain version only for tensors on the CPU or the meta device; for a
CUDA tensor it launches the kernel or raises.  The CUDA sources are
``mxnet_tpu_torch/csrc/fu_*.cu``, all on the tensor cores (tiling and
bound: ``fu_mma.cuh`` for K1, K2, K3, K5 and K6, K3's and K6's tap shifts
gathered as they stage their operands; ``fu_halo.cuh`` for K4 and K7,
each product's shared operand staged once into a halo that the nine taps
read at shifted rows).  ``mm_fwd_tf32x3``, ``mm_skip_fwd_tf32x3``,
``c3_fwd2d_tf32x3``, ``c3_fwd4d_tf32x3``, ``mm_bwd_tf32x3``,
``c3_bwd2d_tf32x3``, ``c3_bwd4d_tf32x3`` and ``conv1x1_bwd_tf32x3``
emulate the float32 arithmetic of K1-K8 (K8: ``ops/nn.py``) (3xTF32 over
the same split of the summed axis, in the kernel's k order) for the CPU
tests; with ``exact`` each MMA rounds as the tensor core does
(``_mma_step``), which gives the card's bits; nothing on the path calls
them.
"""
import torch
import torch.nn.functional as F

from .registry import register, P
from ._cuda import (check, check_dims, halo_dgrad_plan, halo_fwd_plan,
                    halo_wgrad_band, halo_wgrad_plan, launch, mma_plan,
                    mma_wgrad_plan, on_host, stream)
from ..base import MXNetError
from .. import config

EPS_DEFAULT = 2e-5


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _prologue(x, sc, sh):
    """relu(x*sc + sh) in f32, rounded to x's dtype, returned as f32."""
    return torch.relu(x.float() * sc + sh).to(x.dtype).float()


def _stats(acc, with_stats):
    if not with_stats:
        return None, None
    return acc.sum(0), (acc * acc).sum(0)


def mm_fwd_plain(x2d, w, sc, sh, with_stats=False):
    """Plain version of K1: (y, sum y, sum y^2) from the f32 accumulator."""
    acc = torch.matmul(_prologue(x2d, sc, sh),
                       w.reshape(w.shape[0], -1).float().t())
    return (acc.to(x2d.dtype),) + _stats(acc, with_stats)


def mm_skip_fwd_plain(x2d, w, sc, sh, skip2d):
    """Plain version of K2."""
    acc = torch.matmul(_prologue(x2d, sc, sh),
                       w.reshape(w.shape[0], -1).float().t())
    return (acc + skip2d.float()).to(x2d.dtype)


def c3_fwd4d_plain(x4d, w, sc, sh, with_stats=False):
    """Plain version of K4: nine shifted products over the zero-padded
    activation of NHWC x (padding after the prologue, as in the
    reference); y in x's NHWC shape."""
    n, h, w_, ci = x4d.shape
    ap = F.pad(_prologue(x4d, sc, sh), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dh in range(3):
        for dw in range(3):
            patch = ap[:, dh:dh + h, dw:dw + w_, :].reshape(-1, ci)
            part = torch.matmul(patch, wf[:, dh, dw, :].t())
            acc = part if acc is None else acc + part
    return ((acc.to(x4d.dtype).reshape(n, h, w_, -1),)
            + _stats(acc, with_stats))


def c3_fwd2d_plain(x2d, w, sc, sh, n, h, w_, with_stats=False):
    """Plain version of K3: K4's function on the (rows, C) view."""
    y, s, ss = c3_fwd4d_plain(x2d.reshape(n, h, w_, x2d.shape[1]), w, sc,
                              sh, with_stats)
    return y.reshape(x2d.shape[0], -1), s, ss


def _finalize_g(g2d, yraw2d, fin):
    """The cotangent at the conv output, as f32 values of g's dtype: g
    itself when final (fin None), else the deferred BatchNorm backward
    c1*g + u0 + u1*y_raw in f32, rounded to g's dtype."""
    if fin is None:
        return g2d.float()
    c1, u0, u1 = fin
    return (c1 * g2d.float() + u0 + u1 * yraw2d.float()).to(
        g2d.dtype).float()


def _bwd_epilogue(da, x2d, sc, sh, xs, xh):
    """ReLU mask of the recomputed prologue, then the BatchNorm sums from
    the f32 dP: (dP in x's dtype, sum dP, sum dP * xhat)."""
    xf = x2d.float()
    dp = da * (torch.relu(xf * sc + sh) > 0).float()
    return (dp.to(x2d.dtype), dp.sum(0), (dp * (xf * xs + xh)).sum(0))


def mm_bwd_plain(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh):
    """Plain version of K5: (dP (R, Ci), dW (Co, Ci) f32, sum dP,
    sum dP * xhat)."""
    g = _finalize_g(g2d, yraw2d, fin)
    w2 = w.reshape(w.shape[0], -1).float()
    dp, db, dg = _bwd_epilogue(torch.matmul(g, w2), x2d, sc, sh, xs, xh)
    return dp, torch.matmul(g.t(), _prologue(x2d, sc, sh)), db, dg


def _tf32(t):
    """The f32 values of ``t`` rounded to TF32 as ``cvt.rna.tf32.f32``
    rounds them: to nearest on the 13 dropped mantissa bits, ties away
    from zero, on the int32 view (a carry runs into the exponent)."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


# An m16n8k8 tf32 MMA on an NVIDIA H100 adds its eight products and the
# accumulator c in one step: each term is placed in a format with two
# integer bits (a product's exponent is the sum of its factors', c's its
# own plus one), truncated toward zero 27 bits below the largest of those
# exponents, the terms are added exactly, and the sum is rounded toward
# zero to f32 (chip_mma_probe.py fits this against the card's results).
_MMA_BITS = 27


def _significands(t, bits):
    """t's integer significands (``bits`` wide, signed) and exponents: t =
    m * 2^(e - bits) with 2^(bits - 1) <= |m| < 2^bits, m = 0 for 0."""
    f, e = torch.frexp(t)
    return torch.ldexp(f, torch.full_like(e, bits)).to(torch.int32), e


def _mma_step(acc, a, b):
    """acc (m, n) f32 plus a (m, 8) @ b (8, n) of tf32 values, as one
    m16n8k8 MMA computes it (see _MMA_BITS), in integers: a product's
    11 x 11-bit significand and the accumulator's 24 bits shifted to units
    of 2^(emax - _MMA_BITS), toward zero."""
    ma, ea = _significands(a, 11)
    mb, eb = _significands(b, 11)
    mc, ec = _significands(acc, 24)
    prod = ma[:, :, None] * mb[None, :, :]
    ep = ea[:, :, None] + eb[None, :, :]
    low = torch.iinfo(torch.int32).min // 2
    emax = torch.maximum(torch.where(prod != 0, ep, low).amax(1),
                         torch.where(mc != 0, ec + 1, low))
    # product k in units: |prod| * 2^(ep - 22 - (emax - _MMA_BITS))
    d = emax[:, None, :] - ep - (_MMA_BITS - 22)
    mag = prod.abs()
    q = torch.where(d > 0, mag >> d.clamp(0, 31), mag << (-d).clamp(0, 31))
    dc = emax - ec - (_MMA_BITS - 24)
    magc = mc.abs()
    qc = torch.where(dc > 0, magc >> dc.clamp(0, 31),
                     magc << (-dc).clamp(0, 31))
    units = (torch.where(prod < 0, -q, q).sum(1, dtype=torch.int64)
             + torch.where(mc < 0, -qc, qc))
    s = torch.ldexp(units.double(),
                    (emax - _MMA_BITS).clamp(min=-1000).double())
    y = s.float()
    return torch.where(y.double().abs() > s.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


# k of a tile loop's f32 k tile (128 bytes), which it sums from zero before
# promoting it into the accumulator: fu_mma.cuh's ring stage, a halo loop's
# tap of a 32-channel chunk
MMA_TILE_K = 32


def _mm_tf32(a, b, splits, chunk, passes=3, exact=False, tile=MMA_TILE_K):
    """a (m, k) @ b (k, n) as the tensor-core tile loop computes it in
    float32 (csrc/fu_mma.cuh, fu_halo.cuh): each value split into hi =
    tf32(v) and lo = tf32(v - hi); each of the ``splits`` chunks of
    ``chunk`` k cut into k tiles of ``tile``, each tile summed from zero in
    k steps of 8, one MMA each for a_lo b_hi, a_hi b_lo and a_hi b_hi in
    that order, and added into the chunk's f32 accumulator (promotion);
    the chunks' partials added in chunk order.  ``passes=1`` keeps a_hi
    b_hi alone (one TF32 pass).  An MMA adds its eight products in f32
    (matmul order), or with ``exact`` as the card does (``_mma_step``, bit
    for bit, about 30 times slower)."""
    a, b = a.float(), b.float()
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    k = a.shape[1]
    total = None
    for z in range(splits):
        end = min(k, (z + 1) * chunk)
        acc = a.new_zeros((a.shape[0], b.shape[1]))
        for t0 in range(z * chunk, end, tile):
            part = torch.zeros_like(acc)
            for k0 in range(t0, min(end, t0 + tile), 8):
                ks = slice(k0, k0 + 8)
                if exact:
                    if passes == 3:
                        part = _mma_step(part, al[:, ks], bh[ks])
                        part = _mma_step(part, ah[:, ks], bl[ks])
                    part = _mma_step(part, ah[:, ks], bh[ks])
                    continue
                if passes == 3:
                    part = part + torch.matmul(al[:, ks], bh[ks])
                    part = part + torch.matmul(ah[:, ks], bl[ks])
                part = part + torch.matmul(ah[:, ks], bh[ks])
            acc = acc + part
        total = acc if total is None else total + acc
    return total


def _mm_fwd_acc(x2d, w, sc, sh, passes, exact):
    """The f32 sum of K1's and K2's product: ``_mm_tf32`` over their split
    (``mma_plan``)."""
    w2 = w.reshape(w.shape[0], -1)
    _, _, splits, chunk = mma_plan(x2d.shape[0], w2.shape[0], w2.shape[1])
    return _mm_tf32(_prologue(x2d, sc, sh), w2.t(), splits, chunk, passes,
                    exact)


def mm_fwd_tf32x3(x2d, w, sc, sh, with_stats=False, passes=3,
                  exact=False):
    """K1's float32 arithmetic on the CPU: ``mm_fwd_plain`` with the
    product taken as ``_mm_tf32`` over K1's split (``mma_plan``)."""
    acc = _mm_fwd_acc(x2d, w, sc, sh, passes, exact)
    return (acc.to(x2d.dtype),) + _stats(acc, with_stats)


def mm_skip_fwd_tf32x3(x2d, w, sc, sh, skip2d, passes=3, exact=False):
    """K2's float32 arithmetic on the CPU: ``mm_skip_fwd_plain`` with the
    product taken as K1's (``_mm_tf32`` over ``mma_plan``'s split), then
    the residual added to the complete f32 sum and the result rounded
    once."""
    acc = _mm_fwd_acc(x2d, w, sc, sh, passes, exact)
    return (acc + skip2d.float()).to(x2d.dtype)


def c3_fwd2d_tf32x3(x2d, w, sc, sh, n, h, w_, with_stats=False, passes=3,
                    exact=False):
    """K3's float32 arithmetic on the CPU: ``c3_fwd2d_plain`` as K3 takes
    it, a' (R, 9 Ci) @ w' (9 Ci, Co) with a'[r, (t, c)] = act(x)[r + off_t,
    c] (zero off the image) and w' the OHWI weight, k tap-major, as
    ``_mm_tf32`` over K3's split (``mma_plan(R, Co, 9 Ci)``)."""
    rows, ci = x2d.shape
    co = w.shape[0]
    _, _, splits, chunk = mma_plan(rows, co, 9 * ci)
    a9 = _taps(_prologue(x2d, sc, sh).reshape(n, h, w_, ci), 1)
    acc = _mm_tf32(a9, w.reshape(co, 9 * ci).t(), splits, chunk, passes,
                   exact)
    return (acc.to(x2d.dtype),) + _stats(acc, with_stats)


def mm_bwd_tf32x3(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh, passes=3,
                  exact=False):
    """K5's float32 arithmetic on the CPU: ``mm_bwd_plain`` with the dgrad
    and the wgrad taken as ``_mm_tf32`` over K5's splits (``mma_plan``,
    ``mma_wgrad_plan``)."""
    rows, ci = x2d.shape
    w2 = w.reshape(w.shape[0], -1)
    co = w2.shape[0]
    g = _finalize_g(g2d, yraw2d, fin)
    _, _, dsplits, dchunk = mma_plan(rows, ci, co)
    _, _, wsplits, wchunk = mma_wgrad_plan(co, ci, rows)
    da = _mm_tf32(g, w2, dsplits, dchunk, passes, exact)
    dp, db, dg = _bwd_epilogue(da, x2d, sc, sh, xs, xh)
    dw = _mm_tf32(g.t(), _prologue(x2d, sc, sh), wsplits, wchunk, passes,
                  exact)
    return dp, dw, db, dg


def _taps(t4, sign):
    """(rows, 9 * C) from NHWC t4 in K6's k order: column block t = 3 * (dh
    + 1) + (dw + 1) holds t4 at pixel (h + sign * dh, w + sign * dw), zero
    where that leaves the image."""
    n, h, w_, c = t4.shape
    tp = F.pad(t4, (0, 0, 1, 1, 1, 1))
    cols = [tp[:, 1 + sign * dh:1 + sign * dh + h,
               1 + sign * dw:1 + sign * dw + w_, :]
            for dh in (-1, 0, 1) for dw in (-1, 0, 1)]
    return torch.cat(cols, dim=-1).reshape(n * h * w_, 9 * c)


def _halo_operands(t4, w9, sign):
    """A product of the halo loops (csrc/fu_halo.cuh) in their k order, k =
    (chunk of MMA_TILE_K channels, tap, channel), the channels padded with
    zeros to whole chunks as the kernels' tiles are: (A (rows, 9 * C') with
    A[r, (b, t, c)] = t4 at pixel (h + sign * dh, w + sign * dw), channel b
    * MMA_TILE_K + c (``_taps``), B (9 * C', N) from w9 (9, C, N), the weight
    of tap t over the summed channels)."""
    c = t4.shape[-1]
    nb = -(-c // MMA_TILE_K)
    pad = nb * MMA_TILE_K - c
    a = _taps(F.pad(t4, (0, pad)), sign)
    a = a.reshape(-1, 9, nb, MMA_TILE_K).transpose(1, 2).reshape(
        a.shape[0], -1)
    b = F.pad(w9.float(), (0, 0, 0, pad)).reshape(9, nb, MMA_TILE_K, -1) \
        .transpose(0, 1).reshape(9 * nb * MMA_TILE_K, -1)
    return a, b


def c3_fwd4d_tf32x3(x4d, w, sc, sh, with_stats=False, passes=3,
                    exact=False):
    """K4's float32 arithmetic on the CPU: ``c3_fwd4d_plain`` as K4 takes
    it (csrc/fu_halo.cuh), y = act(x)' @ w' with act(x)'[r, (b, t, c)] =
    act(x)[r + off_t, b * 32 + c] (zero off the image) and w'[(b, t, c), o]
    = w[o, t, b * 32 + c], k = (chunk of 32 channels of Ci, tap, channel) as
    ``_halo_operands`` orders it, a chunk's nine taps read from one staged
    halo: ``_mm_tf32`` over K4's split of Ci (``halo_fwd_plan``), then
    K1's epilogue."""
    n, h, w_, ci = x4d.shape
    co = w.shape[0]
    _, _, splits, chunk = halo_fwd_plan(n * h * w_, ci, co, w_)
    a, b = _halo_operands(_prologue(x4d, sc, sh),
                          w.permute(1, 2, 3, 0).reshape(9, ci, co), 1)
    acc = _mm_tf32(a, b, splits, 9 * chunk, passes, exact)
    return ((acc.to(x4d.dtype).reshape(n, h, w_, co),)
            + _stats(acc, with_stats))


def c3_bwd2d_tf32x3(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh, n, h, w_,
                    passes=3, exact=False):
    """K6's float32 arithmetic on the CPU: ``c3_bwd2d_plain`` as K6 takes
    it, the dgrad fin(g)' (R, 9 Co) @ w' (9 Co, Ci) with fin(g)'[r, (t, o)]
    = fin(g)[r - off_t, o] and w'[(t, o), i] = w[o, t, i], the wgrad
    fin(g)^T @ a' (R, 9 Ci) with a'[r, (t, i)] = act(x)[r + off_t, i], each
    taken as ``_mm_tf32`` over K6's splits (``c3_bwd2d_buffers``)."""
    rows, ci = x2d.shape
    co = w.shape[0]
    g = _finalize_g(g2d, yraw2d, fin)
    _, _, dsplits, dchunk = mma_plan(rows, ci, 9 * co)
    _, _, wsplits, wchunk = mma_wgrad_plan(co, 9 * ci, rows)
    w9 = w.permute(1, 2, 0, 3).reshape(9 * co, ci)
    da = _mm_tf32(_taps(g.reshape(n, h, w_, co), -1), w9, dsplits, dchunk,
                  passes, exact)
    dp, db, dg = _bwd_epilogue(da, x2d, sc, sh, xs, xh)
    a9 = _taps(_prologue(x2d, sc, sh).reshape(n, h, w_, ci), 1)
    dw = _mm_tf32(g.t(), a9, wsplits, wchunk, passes, exact)
    return dp, dw.reshape(co, 3, 3, ci), db, dg


def c3_bwd4d_tf32x3(g4d, yraw4d, fin, x4d, w, sc, sh, xs, xh, passes=3,
                    exact=False):
    """K7's float32 arithmetic on the CPU: ``c3_bwd4d_plain`` as K7 takes
    it (csrc/fu_halo.cuh), each product as ``_mm_tf32`` over K7's splits
    (``halo_dgrad_plan``, ``halo_wgrad_plan``).  The dgrad sums k = (chunk
    of 32 channels of Co, tap, channel), a chunk's nine taps read from one
    staged halo: fin(g)' (R, 9 Co) @ w' with fin(g)'[r, (t, o)] =
    fin(g)[r - off_t, o], ordered as ``_halo_operands`` orders them; the
    wgrad sums the pixels in order, band by band, each tap
    apart, as the kernel takes it, transposed: a'^T (9 Ci, R) @ fin(g),
    with a'[r, (t, i)] = act(x)[r + off_t, i] (the activation is the MMA's
    A operand, so its lo part meets g's hi part in the first pass)."""
    n, h, w_, co = g4d.shape
    ci = x4d.shape[-1]
    rows = n * h * w_
    x2d = x4d.reshape(rows, ci)
    g = _finalize_g(g4d.reshape(rows, co), yraw4d.reshape(rows, co), fin)
    _, _, dsplits, dchunk = halo_dgrad_plan(rows, ci, co, w_)
    wsplits, wchunk = halo_wgrad_plan(rows, ci, co)
    gk, wk = _halo_operands(g.reshape(n, h, w_, co),
                            w.permute(1, 2, 0, 3).reshape(9, co, ci), -1)
    da = _mm_tf32(gk, wk, dsplits, 9 * dchunk, passes, exact)
    dp, db, dg = _bwd_epilogue(da, x2d, sc, sh, xs, xh)
    a9 = _taps(_prologue(x2d, sc, sh).reshape(n, h, w_, ci), 1)
    dw = _mm_tf32(a9.t(), g, wsplits, wchunk, passes, exact,
                  halo_wgrad_band()).t()
    return dp.reshape(x4d.shape), dw.reshape(co, 3, 3, ci), db, dg


def conv1x1_bwd_tf32x3(x2d, dy2d, w, passes=3, exact=False):
    """K8's float32 arithmetic on the CPU: ``nn.conv1x1_bwd_plain`` with
    dx = dy @ w and dW = dy^T x taken as ``_mm_tf32`` over K8's splits
    (``nn.conv1x1_bwd_buffers``)."""
    rows, ci = x2d.shape
    w2 = w.reshape(w.shape[0], -1)
    co = w2.shape[0]
    _, _, dsplits, dchunk = mma_plan(rows, ci, co)
    _, _, wsplits, wchunk = mma_wgrad_plan(co, ci, rows)
    dx = _mm_tf32(dy2d, w2, dsplits, dchunk, passes, exact).to(x2d.dtype)
    dw = _mm_tf32(dy2d.t(), x2d, wsplits, wchunk, passes, exact)
    return dx, dw.reshape(w.shape).to(w.dtype)


def c3_bwd4d_plain(g4d, yraw4d, fin, x4d, w, sc, sh, xs, xh):
    """Plain version of K7: (dP in x's NHWC shape, dW (Co, 3, 3, Ci) f32,
    sum dP, sum dP * xhat).  Tap (dh, dw) pairs output pixel p with input
    pixel p + (dh - 1, dw - 1): its wgrad sums g[p]^T a[p + tap] and its
    dgrad adds g[q - tap] @ w_tap to input pixel q, with g and a zero
    outside the image."""
    n, h, w_, co = g4d.shape
    ci = x4d.shape[-1]
    g = _finalize_g(g4d, yraw4d, fin)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    ap = F.pad(_prologue(x4d, sc, sh), (0, 0, 1, 1, 1, 1))
    g = g.reshape(-1, co)
    wf = w.float()
    dw = torch.empty((co, 3, 3, ci), dtype=torch.float32, device=g.device)
    da = None
    for th in range(3):
        for tw in range(3):
            patch = ap[:, th:th + h, tw:tw + w_, :].reshape(-1, ci)
            dw[:, th, tw, :] = torch.matmul(g.t(), patch)
            gpatch = gp[:, 2 - th:2 - th + h, 2 - tw:2 - tw + w_, :]
            part = torch.matmul(gpatch.reshape(-1, co), wf[:, th, tw, :])
            da = part if da is None else da + part
    dp, db, dg = _bwd_epilogue(da, x4d.reshape(-1, ci), sc, sh, xs, xh)
    return dp.reshape(x4d.shape), dw, db, dg


def c3_bwd2d_plain(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh, n, h, w_):
    """Plain version of K6: K7's function on the (rows, C) views, dP
    (R, Ci)."""
    def view(t):
        return None if t is None else t.reshape(n, h, w_, t.shape[1])
    dp, dw, db, dg = c3_bwd4d_plain(view(g2d), view(yraw2d), fin,
                                    view(x2d), w, sc, sh, xs, xh)
    return dp.reshape(x2d.shape), dw, db, dg


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def mm_fwd_buffers(rows, ci, co, with_stats, device, f32=True):
    """K1's launch plan (bm, bn, splits, chunk) for x (rows, ci) in f32 or
    bf16 and co output channels, and the scratch it implies: (plan, split
    partials (splits, rows, co) or None, statistics partials (2, row
    tiles, co), sum, sum of squares; the last three None without
    statistics)."""
    plan = mma_plan(rows, co, ci, f32)
    fp = dict(dtype=torch.float32, device=device)
    ws = torch.empty((plan[2], rows, co), **fp) if plan[2] > 1 else None
    if not with_stats:
        return plan, ws, None, None, None
    return (plan, ws, torch.empty((2, -(-rows // plan[0]), co), **fp),
            torch.empty(co, **fp), torch.empty(co, **fp))


def mm_fwd(x2d, w, sc, sh, with_stats=False):
    """K1: y = relu(x*sc + sh) @ w^T for x (R, Ci), w (Co, Ci) or
    (Co, 1, 1, Ci); with_stats also returns the per-channel sum and sum of
    squares of the f32 accumulator, else (y, None, None).

    Replaces mxnet_tpu/ops/fused_unit.py ``_k_matmul_fwd`` (``_mm_fwd``,
    pallas_call "fu_mm_fwd").  Bound on the H100: arithmetic at ResNet-50
    widths (2*R*Ci*Co operations against R*(Ci+Co) elements moved), which
    the tensor cores serve: bf16 MMA directly, float32 through 3xTF32
    (three TF32 products per f32 product: 165 TFLOP/s of f32-accurate
    products against FFMA's 67, H100 SXM data sheet).  The design
    (csrc/fu_mma.cuh) stages the normalized tile once into shared memory,
    takes its output tile and the split of Ci from ``mma_plan`` (shapes
    only, so the bits are fixed) and adds split partials and statistics in
    a fixed order."""
    if on_host(x2d):
        return mm_fwd_plain(x2d, w, sc, sh, with_stats)
    rows, ci = x2d.shape
    w2 = w.reshape(w.shape[0], -1)
    co = w2.shape[0]
    if w2.shape[1] != ci or sc.shape != (ci,) or sh.shape != (ci,):
        raise MXNetError("mm_fwd: shapes x %s w %s sc %s sh %s disagree"
                         % (tuple(x2d.shape), tuple(w.shape),
                            tuple(sc.shape), tuple(sh.shape)))
    check("mm_fwd", x2d.dtype, x2d.device, x=x2d, w=w2, sc=sc, sh=sh)
    check_dims("mm_fwd", ci, co)
    y = torch.empty((rows, co), dtype=x2d.dtype, device=x2d.device)
    plan, ws, part, s, ss = mm_fwd_buffers(rows, ci, co, with_stats,
                                           x2d.device,
                                           x2d.dtype == torch.float32)
    with torch.cuda.device(x2d.device):
        launch("fu_mm_fwd", x2d, w2, sc, sh, y, part, s, ss, ws, rows, ci,
               co, int(x2d.dtype == torch.bfloat16), int(with_stats), *plan,
               stream(x2d.device))
    mm_fwd.launches += 1
    return y, s, ss


mm_fwd.launches = 0


def mm_skip_fwd(x2d, w, sc, sh, skip2d):
    """K2: y = relu(x*sc + sh) @ w^T + skip for x (R, Ci), w (Co, Ci) or
    (Co, 1, 1, Ci), skip (R, Co).

    Replaces mxnet_tpu/ops/fused_unit.py ``_k_matmul_skip_fwd``
    (``_mm_skip_fwd``, pallas_call "fu_mm_skip_fwd").  Bound on the H100:
    bytes at ResNet-50 widths, in both dtypes (R*(Ci + 2*Co) elements moved
    against 2*R*Ci*Co operations: its Ci is a quarter of its Co, and float32
    products run through 3xTF32).  It runs on K1's tensor-core loop
    (csrc/fu_mma.cuh), on the same plan (``mma_plan``, through
    ``mm_fwd_buffers`` without statistics), with the residual read in the
    epilogue and added to the complete f32 sum, which is rounded once and
    written once."""
    if on_host(x2d):
        return mm_skip_fwd_plain(x2d, w, sc, sh, skip2d)
    rows, ci = x2d.shape
    w2 = w.reshape(w.shape[0], -1)
    co = w2.shape[0]
    if w2.shape[1] != ci or skip2d.shape != (rows, co) \
            or sc.shape != (ci,) or sh.shape != (ci,):
        raise MXNetError("mm_skip_fwd: shapes x %s w %s skip %s disagree"
                         % (tuple(x2d.shape), tuple(w.shape),
                            tuple(skip2d.shape)))
    check("mm_skip_fwd", x2d.dtype, x2d.device, x=x2d, w=w2, sc=sc, sh=sh,
          skip=skip2d)
    check_dims("mm_skip_fwd", ci, co)
    y = torch.empty((rows, co), dtype=x2d.dtype, device=x2d.device)
    plan, ws = mm_fwd_buffers(rows, ci, co, False, x2d.device,
                              x2d.dtype == torch.float32)[:2]
    with torch.cuda.device(x2d.device):
        launch("fu_mm_skip_fwd", x2d, w2, sc, sh, skip2d, y, ws, rows, ci,
               co, int(x2d.dtype == torch.bfloat16), *plan,
               stream(x2d.device))
    mm_skip_fwd.launches += 1
    return y


mm_skip_fwd.launches = 0


def c3_fwd2d_buffers(rows, ci, co, with_stats, device, f32=True):
    """K3's launch plan and scratch: ``mm_fwd_buffers`` over its k = 9 *
    ci, the plan ``mma_plan(rows, co, 9 * ci)``."""
    return mm_fwd_buffers(rows, 9 * ci, co, with_stats, device, f32)


def _check_index_division(name, rows, h, w_, c):
    """The tap gathers divide row and channel indices by multiply-high,
    exact while index * divisor < 2^32."""
    if (rows + 128) * max(h, w_) >= 2 ** 32 or (9 * c + 128) * c >= 2 ** 32:
        raise MXNetError("%s: %d rows of %dx%d images at %d channels "
                         "overflow the kernel's 32-bit index division"
                         % (name, rows, h, w_, c))


def c3_fwd2d(x2d, w, sc, sh, n, h, w_, with_stats=False):
    """K3: 3x3 / stride 1 / pad 1 convolution of relu(x*sc + sh) over n
    whole h x w_ images held as x (n*h*w_, Ci), weight (Co, 3, 3, Ci) OHWI;
    with_stats as for ``mm_fwd``.

    Replaces mxnet_tpu/ops/fused_unit.py ``_k_conv3_fwd_2d``
    (``_c3_fwd2d``, pallas_call "fu_c3_fwd2d").  Bound on the H100:
    arithmetic (9 taps of 2*R*Ci*Co), which the tensor cores serve (bf16
    MMA, float32 through 3xTF32) on K1's loop (csrc/fu_mma.cuh) with k =
    (tap, channel): each tap's neighbour row of the activation is gathered
    through the prologue as the tile is staged, with zeros outside the
    image (no rolled copy, no mask tensor), and the OHWI weight is read in
    place.  Plan and scratch come from ``c3_fwd2d_buffers`` (shapes only);
    split partials and statistics are added in a fixed order.  It runs at
    every width."""
    if on_host(x2d):
        return c3_fwd2d_plain(x2d, w, sc, sh, n, h, w_, with_stats)
    rows, ci = x2d.shape
    co = w.shape[0]
    if rows != n * h * w_ or tuple(w.shape[1:]) != (3, 3, ci) \
            or sc.shape != (ci,) or sh.shape != (ci,):
        raise MXNetError("c3_fwd2d: shapes x %s w %s disagree with "
                         "n,h,w = %d,%d,%d" % (tuple(x2d.shape),
                                               tuple(w.shape), n, h, w_))
    check("c3_fwd2d", x2d.dtype, x2d.device, x=x2d, w=w, sc=sc, sh=sh)
    check_dims("c3_fwd2d", ci, co)
    _check_index_division("c3_fwd2d", rows, h, w_, max(ci, co))
    y = torch.empty((rows, co), dtype=x2d.dtype, device=x2d.device)
    plan, ws, part, s, ss = c3_fwd2d_buffers(rows, ci, co, with_stats,
                                             x2d.device,
                                             x2d.dtype == torch.float32)
    with torch.cuda.device(x2d.device):
        launch("fu_c3_fwd2d", x2d, w, sc, sh, y, part, s, ss, ws, rows, ci,
               co, h, w_, int(x2d.dtype == torch.bfloat16), int(with_stats),
               *plan, stream(x2d.device))
    c3_fwd2d.launches += 1
    return y, s, ss


c3_fwd2d.launches = 0


def _check_fin(name, fin, yraw2d, rows, co):
    if fin is None:
        return
    if yraw2d is None or yraw2d.shape != (rows, co) \
            or any(v.shape != (co,) for v in fin):
        raise MXNetError("%s: deferred finalize needs y_raw (%d, %d) and "
                         "three (%d,) vectors" % (name, rows, co, co))


def mm_bwd_buffers(rows, ci, co, device, f32=True, taps=1):
    """K5's (taps = 1) or K6's (taps = 9) launch plans for x (rows, ci) and
    g (rows, co) in f32 or bf16, the dgrad's ``mma_plan(rows, ci, taps *
    co)`` and the wgrad's ``mma_wgrad_plan(co, taps * ci, rows)``, and the
    buffers they imply: (dgrad plan, wgrad plan, BN-sum partials (2, row
    tiles, ci), db, dg, dgrad split partials (splits, rows, ci) or None, dW
    (co, taps * ci), wgrad split partials (splits, co, taps * ci) or None),
    all f32."""
    dplan = mma_plan(rows, ci, taps * co, f32)
    wplan = mma_wgrad_plan(co, taps * ci, rows)
    fp = dict(dtype=torch.float32, device=device)
    dws = torch.empty((dplan[2], rows, ci), **fp) if dplan[2] > 1 else None
    wpart = torch.empty((wplan[2], co, taps * ci), **fp) \
        if wplan[2] > 1 else None
    return (dplan, wplan,
            torch.empty((2, -(-rows // dplan[0]), ci), **fp),
            torch.empty(ci, **fp), torch.empty(ci, **fp), dws,
            torch.empty((co, taps * ci), **fp), wpart)


def c3_bwd2d_buffers(rows, ci, co, device, f32=True):
    """K6's plans and buffers: ``mm_bwd_buffers`` over its nine taps."""
    return mm_bwd_buffers(rows, ci, co, device, f32, taps=9)


def mm_bwd(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh):
    """K5: the backward of y = relu(x*sc + sh) @ w^T for x (R, Ci), w
    (Co, Ci) or (Co, 1, 1, Ci), from the cotangent g (R, Co).  With ``fin
    = (c1, u0, u1)`` the cotangent is first finalized as c1*g + u0 +
    u1*y_raw (the consumer BatchNorm's deferred backward, rounded to the
    data type); with ``fin`` None it is final.  Returns dP = (g @ w) *
    relu'(x*sc + sh) (R, Ci) in x's dtype, dW = g^T relu(x*sc + sh) (Co, Ci)
    f32, and the f32 sums of dP and of dP*(x*xs + xh) over the rows.

    Replaces mxnet_tpu/ops/fused_unit.py ``_k_matmul_bwd`` (``_mm_bwd``,
    pallas_call "fu_mm_bwd"), which returns dW transposed.  Bound on the
    H100: arithmetic (4*R*Ci*Co operations: dgrad and wgrad), which the
    tensor cores serve (bf16 MMA, float32 through 3xTF32).  The design
    (csrc/fu_mma.cuh) recomputes the finalize and the prologue while
    staging tiles, so neither the finalized cotangent nor the activation is
    written; reads the OHWI weight and g^T in place from MN-major tiles;
    splits the dgrad's sum over Co where the SMs would idle and the
    wgrad's over R (``mm_bwd_buffers``: shapes only); and adds every
    partial (dP, dW and the sums) in a fixed order."""
    if on_host(x2d):
        return mm_bwd_plain(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh)
    rows, ci = x2d.shape
    w2 = w.reshape(w.shape[0], -1)
    co = w2.shape[0]
    if g2d.shape != (rows, co) or w2.shape[1] != ci \
            or any(v.shape != (ci,) for v in (sc, sh, xs, xh)):
        raise MXNetError("mm_bwd: shapes g %s x %s w %s disagree"
                         % (tuple(g2d.shape), tuple(x2d.shape),
                            tuple(w.shape)))
    _check_fin("mm_bwd", fin, yraw2d, rows, co)
    extra = {} if fin is None else dict(yraw=yraw2d, c1=fin[0], u0=fin[1],
                                        u1=fin[2])
    check("mm_bwd", x2d.dtype, x2d.device, g=g2d, x=x2d, w=w2, sc=sc,
          sh=sh, xs=xs, xh=xh, **extra)
    check_dims("mm_bwd", ci, co)
    dev = x2d.device
    dp = torch.empty((rows, ci), dtype=x2d.dtype, device=dev)
    dplan, wplan, part, db, dg, dws, dw, wpart = mm_bwd_buffers(
        rows, ci, co, dev, x2d.dtype == torch.float32)
    c1, u0, u1 = fin if fin is not None else (None, None, None)
    with torch.cuda.device(dev):
        launch("fu_mm_bwd", g2d, yraw2d if fin is not None else None, c1,
               u0, u1, x2d, w2, sc, sh, xs, xh, dp, part, db, dg, dw, wpart,
               dws, rows, ci, co, int(x2d.dtype == torch.bfloat16),
               int(fin is not None), *dplan, *wplan, stream(dev))
    mm_bwd.launches += 1
    return dp, dw, db, dg


mm_bwd.launches = 0


def c3_bwd2d(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh, n, h, w_):
    """K6: the backward of the 3x3 / stride 1 / pad 1 convolution y =
    conv3x3(relu(x*sc + sh)) over n whole h x w_ images held as x
    (n*h*w_, Ci), weight (Co, 3, 3, Ci) OHWI, from the deferred cotangent
    g (R, Co) with ``fin = (c1, u0, u1)`` (finalized as in ``mm_bwd``).
    Returns dP (R, Ci) in x's dtype, dW (Co, 3, 3, Ci) f32, and the f32
    sums of dP and of dP*(x*xs + xh).

    Replaces mxnet_tpu/ops/fused_unit.py ``_k_conv3_bwd_2d``
    (``_c3_bwd2d``, pallas_call "fu_c3_bwd2d"), which returns dW as
    (3, 3, Ci, Co).  Bound on the H100: arithmetic (9 taps of 4*R*Ci*Co),
    which the tensor cores serve (bf16 MMA, float32 through 3xTF32) on
    K5's loop (csrc/fu_mma.cuh).  Its two products sum over k = (tap,
    channel): the dgrad stages each tap's neighbour row of the finalized
    cotangent and the wgrad each tap's neighbour row of the activation,
    with zeros outside the image, as they stage their tiles (no rolled
    copy, no mask tensor); the dgrad reads the OHWI weight in place and
    the wgrad's output tile is the OHWI gradient.  Plans and scratch come
    from ``c3_bwd2d_buffers`` (shapes only); every partial is added in a
    fixed order.  It runs at every width."""
    if on_host(x2d):
        return c3_bwd2d_plain(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh, n,
                              h, w_)
    rows, ci = x2d.shape
    co = w.shape[0]
    if rows != n * h * w_ or tuple(w.shape[1:]) != (3, 3, ci) \
            or g2d.shape != (rows, co) \
            or any(v.shape != (ci,) for v in (sc, sh, xs, xh)):
        raise MXNetError("c3_bwd2d: shapes g %s x %s w %s disagree with "
                         "n,h,w = %d,%d,%d" % (tuple(g2d.shape),
                                               tuple(x2d.shape),
                                               tuple(w.shape), n, h, w_))
    if fin is None:
        raise MXNetError("c3_bwd2d: the 3x3's cotangent is always deferred")
    _check_fin("c3_bwd2d", fin, yraw2d, rows, co)
    check("c3_bwd2d", x2d.dtype, x2d.device, g=g2d, yraw=yraw2d, c1=fin[0],
          u0=fin[1], u1=fin[2], x=x2d, w=w, sc=sc, sh=sh, xs=xs, xh=xh)
    check_dims("c3_bwd2d", ci, co)
    _check_index_division("c3_bwd2d", rows, h, w_, max(ci, co))
    dev = x2d.device
    dp = torch.empty((rows, ci), dtype=x2d.dtype, device=dev)
    dplan, wplan, part, db, dg, dws, dw, wpart = c3_bwd2d_buffers(
        rows, ci, co, dev, x2d.dtype == torch.float32)
    with torch.cuda.device(dev):
        launch("fu_c3_bwd2d", g2d, yraw2d, fin[0], fin[1], fin[2], x2d, w,
               sc, sh, xs, xh, dp, part, db, dg, dw, wpart, dws, rows, ci,
               co, h, w_, int(x2d.dtype == torch.bfloat16), *dplan, *wplan,
               stream(dev))
    c3_bwd2d.launches += 1
    return dp, dw.reshape(co, 3, 3, ci), db, dg


c3_bwd2d.launches = 0


def c3_fwd4d_buffers(n, h, w_, ci, co, with_stats, device, f32=True):
    """K4's launch plan for NHWC x (n, h, w_, ci) in f32 or bf16 and co
    output channels, ``halo_fwd_plan(rows, ci, co, w_)``, and the scratch
    it implies, as ``mm_fwd_buffers`` gives K1's: (plan, split partials
    (splits, rows, co) or None, statistics partials (2, row tiles, co),
    sum, sum of squares; the last three None without statistics)."""
    rows = n * h * w_
    plan = halo_fwd_plan(rows, ci, co, w_, f32)
    fp = dict(dtype=torch.float32, device=device)
    ws = torch.empty((plan[2], rows, co), **fp) if plan[2] > 1 else None
    if not with_stats:
        return plan, ws, None, None, None
    return (plan, ws, torch.empty((2, -(-rows // plan[0]), co), **fp),
            torch.empty(co, **fp), torch.empty(co, **fp))


def c3_fwd4d(x4d, w, sc, sh, with_stats=False):
    """K4: 3x3 / stride 1 / pad 1 convolution of relu(x*sc + sh) for NHWC
    x (N, H, W, Ci), weight (Co, 3, 3, Ci) OHWI; y (N, H, W, Co), and with
    with_stats the per-channel sum and sum of squares of the f32
    accumulator, else (y, None, None).

    Replaces mxnet_tpu/ops/fused_unit.py ``_k_conv3_fwd`` (``_c3_fwd``,
    pallas_call "fu_c3_fwd"), the MXNET_FUSED_UNIT_C3=4d path.  Bound on
    the H100: arithmetic (9 taps of 2*N*H*W*Ci*Co), which the tensor cores
    serve (bf16 MMA, float32 through 3xTF32) on K7's dgrad loop
    (csrc/fu_halo.cuh) run forward: per chunk of Ci the activation of a
    band of pixels is staged once through the prologue into a halo that the
    nine taps read at shifted rows, a zero row where a neighbour leaves the
    image (the padding after the prologue), and the OHWI weight is read in
    place; the epilogue is K1's.  Plan and scratch come from
    ``c3_fwd4d_buffers`` (shapes only); split partials and statistics are
    added in a fixed order.  It runs at every width."""
    if on_host(x4d):
        return c3_fwd4d_plain(x4d, w, sc, sh, with_stats)
    if x4d.ndim != 4:
        raise MXNetError("c3_fwd4d: x must be NHWC, got shape %s"
                         % (tuple(x4d.shape),))
    n, h, w_, ci = x4d.shape
    co = w.shape[0]
    if tuple(w.shape[1:]) != (3, 3, ci) or sc.shape != (ci,) \
            or sh.shape != (ci,):
        raise MXNetError("c3_fwd4d: shapes x %s w %s disagree"
                         % (tuple(x4d.shape), tuple(w.shape)))
    check("c3_fwd4d", x4d.dtype, x4d.device, x=x4d, w=w, sc=sc, sh=sh)
    check_dims("c3_fwd4d", ci, co)
    _check_index_division("c3_fwd4d", n * h * w_, h, w_, max(ci, co))
    dev = x4d.device
    y = torch.empty((n, h, w_, co), dtype=x4d.dtype, device=dev)
    plan, ws, part, s, ss = c3_fwd4d_buffers(n, h, w_, ci, co, with_stats,
                                             dev, x4d.dtype == torch.float32)
    with torch.cuda.device(dev):
        launch("fu_c3_fwd4d", x4d, w, sc, sh, y, part, s, ss, ws, n, h, w_,
               ci, co, int(x4d.dtype == torch.bfloat16), int(with_stats),
               *plan, stream(dev))
    c3_fwd4d.launches += 1
    return y, s, ss


c3_fwd4d.launches = 0


def c3_bwd4d_buffers(n, h, w_, ci, co, device, f32=True):
    """K7's launch plans for NHWC x (n, h, w_, ci) and g (n, h, w_, co) in
    f32 or bf16, the dgrad's ``halo_dgrad_plan(rows, ci, co, w_)`` and the
    wgrad's ``halo_wgrad_plan(rows, ci, co)``, and the buffers they imply:
    (dgrad plan, wgrad plan, BN-sum partials (2, row tiles, ci), db, dg,
    dgrad split partials (splits, rows, ci) or None, dW (co, 3, 3, ci),
    wgrad split partials (splits, co, 9 * ci) or None), all f32."""
    rows = n * h * w_
    dplan = halo_dgrad_plan(rows, ci, co, w_, f32)
    wplan = halo_wgrad_plan(rows, ci, co, f32)
    fp = dict(dtype=torch.float32, device=device)
    dws = torch.empty((dplan[2], rows, ci), **fp) if dplan[2] > 1 else None
    wpart = torch.empty((wplan[0], co, 9 * ci), **fp) \
        if wplan[0] > 1 else None
    return (dplan, wplan,
            torch.empty((2, -(-rows // dplan[0]), ci), **fp),
            torch.empty(ci, **fp), torch.empty(ci, **fp), dws,
            torch.empty((co, 3, 3, ci), **fp), wpart)


def c3_bwd4d(g4d, yraw4d, fin, x4d, w, sc, sh, xs, xh):
    """K7: the backward of y = conv3x3(relu(x*sc + sh)) for NHWC x (N, H,
    W, Ci), weight (Co, 3, 3, Ci) OHWI, from the deferred cotangent g (N,
    H, W, Co) with ``fin = (c1, u0, u1)`` (finalized as in ``mm_bwd``, and
    zero outside the image).  Returns dP (N, H, W, Ci) in x's dtype, dW
    (Co, 3, 3, Ci) f32, and the f32 sums of dP and of dP*(x*xs + xh).

    Replaces mxnet_tpu/ops/fused_unit.py ``_k_conv3_bwd`` (``_c3_bwd``,
    pallas_call "fu_c3_bwd"), which returns dW as (3, 3, Ci, Co).  Bound on
    the H100: arithmetic (9 taps of 4*N*H*W*Ci*Co), which the tensor cores
    serve (bf16 MMA, float32 through 3xTF32) on K6's loop in its
    halo-resident form (csrc/fu_halo.cuh): the dgrad stages the finalized
    cotangent of a band of pixels once per channel chunk and the wgrad the
    activation once per band, and the nine taps read that halo at shifted
    rows, a zero row where a neighbour leaves the image; the OHWI weight is
    read in place and the wgrad writes the OHWI gradient.  Plans and
    scratch come from ``c3_bwd4d_buffers`` (shapes only); every partial is
    added in a fixed order.  It runs at every width."""
    if on_host(x4d):
        return c3_bwd4d_plain(g4d, yraw4d, fin, x4d, w, sc, sh, xs, xh)
    if x4d.ndim != 4:
        raise MXNetError("c3_bwd4d: x must be NHWC, got shape %s"
                         % (tuple(x4d.shape),))
    n, h, w_, ci = x4d.shape
    co = w.shape[0]
    if tuple(w.shape[1:]) != (3, 3, ci) or g4d.shape != (n, h, w_, co) \
            or any(v.shape != (ci,) for v in (sc, sh, xs, xh)):
        raise MXNetError("c3_bwd4d: shapes g %s x %s w %s disagree"
                         % (tuple(g4d.shape), tuple(x4d.shape),
                            tuple(w.shape)))
    if fin is None or yraw4d is None or yraw4d.shape != g4d.shape \
            or any(v.shape != (co,) for v in fin):
        raise MXNetError("c3_bwd4d: the 3x3's cotangent is always deferred: "
                         "it needs y_raw %s and three (%d,) vectors"
                         % (tuple(g4d.shape), co))
    check("c3_bwd4d", x4d.dtype, x4d.device, g=g4d, yraw=yraw4d, c1=fin[0],
          u0=fin[1], u1=fin[2], x=x4d, w=w, sc=sc, sh=sh, xs=xs, xh=xh)
    check_dims("c3_bwd4d", ci, co)
    _check_index_division("c3_bwd4d", n * h * w_, h, w_, max(ci, co))
    dev = x4d.device
    dp = torch.empty(x4d.shape, dtype=x4d.dtype, device=dev)
    dplan, wplan, part, db, dg, dws, dw, wpart = c3_bwd4d_buffers(
        n, h, w_, ci, co, dev, x4d.dtype == torch.float32)
    with torch.cuda.device(dev):
        launch("fu_c3_bwd4d", g4d, yraw4d, fin[0], fin[1], fin[2], x4d, w,
               sc, sh, xs, xh, dp, part, db, dg, dw, wpart, dws, n, h, w_,
               ci, co, int(x4d.dtype == torch.bfloat16), *dplan, *wplan,
               stream(dev))
    c3_bwd4d.launches += 1
    return dp, dw, db, dg


c3_bwd4d.launches = 0

KERNEL_WRAPPERS = (mm_fwd, c3_fwd2d, c3_fwd4d, mm_skip_fwd, mm_bwd, c3_bwd2d,
                   c3_bwd4d)


# ---------------------------------------------------------------------------
# The unit's chain, forward and backward
# ---------------------------------------------------------------------------

def _c3_mode():
    mode = config.get("MXNET_FUSED_UNIT_C3").lower()
    if mode not in ("auto", "2d", "4d", "xla"):
        raise MXNetError("MXNET_FUSED_UNIT_C3 must be one of "
                         "auto/2d/4d/xla, got %r" % mode)
    return mode


def _c3_fwd_segment(x4d, w, sc, sh):
    """The middle conv as a plain torch convolution (the counterpart of
    ``_c3_fwd_xla``), chosen only by MXNET_FUSED_UNIT_C3=xla."""
    a = torch.relu(x4d.float() * sc + sh).to(x4d.dtype)
    y = F.conv2d(a.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), padding=1)
    return y.permute(0, 2, 3, 1)


def _c3_bwd_segment(g2d, yraw2d, fin, x2d, w, sc, sh, xs, xh, n, h, w_):
    """K6's function through torch's convolution gradients (the
    counterpart of ``_c3_bwd_xla``), chosen only by
    MXNET_FUSED_UNIT_C3=xla; the products round to the data type as the
    reference's do."""
    co, ci = g2d.shape[1], x2d.shape[1]
    g = _finalize_g(g2d, yraw2d, fin).to(g2d.dtype)
    g = g.reshape(n, h, w_, co).permute(0, 3, 1, 2)
    a = _prologue(x2d, sc, sh).to(x2d.dtype)
    a = a.reshape(n, h, w_, ci).permute(0, 3, 1, 2)
    w_oihw = w.permute(0, 3, 1, 2)
    da = torch.nn.grad.conv2d_input(a.shape, w_oihw, g, padding=1)
    dw = torch.nn.grad.conv2d_weight(a, w_oihw.shape, g, padding=1)
    dp, db, dg = _bwd_epilogue(da.permute(0, 2, 3, 1).reshape(-1, ci).float(),
                               x2d, sc, sh, xs, xh)
    return dp, dw.permute(0, 2, 3, 1).float(), db, dg


def _bn_vectors(mu, var, gamma, beta, eps):
    """f32 per-channel vectors of a BatchNorm with statistics (mu, var):
    scale and shift of its output, and xs, xh with xhat = x*xs + xh, and
    inv = 1/sqrt(var + eps)."""
    inv = torch.rsqrt(var.float() + eps)
    sc = gamma.float() * inv
    return sc, beta.float() - mu.float() * sc, inv, -mu.float() * inv, inv


def _finalize_vectors(gamma, inv, mu, dbeta, dgamma, m):
    """(c1, u0, u1) with which c1*dP + u0 + u1*x is a BatchNorm's input
    gradient, from its reductions dbeta = sum dP, dgamma = sum dP*xhat."""
    c1 = gamma.float() * inv
    u0 = -c1 * (dbeta + dgamma * (-mu * inv)) / m
    u1 = -c1 * dgamma * inv / m
    return c1, u0, u1


def _stats_from_sums(s, ss, m):
    """Batch mean and biased variance from sum y and sum y^2 (the
    reference's one-pass formula and clamp)."""
    mu = s / m
    return mu, torch.clamp(ss / m - mu * mu, min=0.0)


def _fused_unit_chain(eps, n, h, w_, data, g1, b1, w1, g2, b2, w2, g3, b3,
                      w3, mu0, var0, fixed_stats=None):
    """conv1 -> conv2 -> conv3+skip.  (mu0, var0) normalize the data for
    conv1.  Training (fixed_stats None) normalizes conv1's and conv2's
    outputs by their batch statistics, taken from K1's and K3's epilogues;
    eval passes the moving statistics as fixed_stats = (mu1, var1, mu2,
    var2).  One chain serves both modes, as in the reference.  Returns
    (out in data's shape, y1, y2, (mu1, var1), (mu2, var2))."""
    training = fixed_stats is None
    c = data.shape[-1]
    rows = n * h * w_
    cq = w1.shape[0]
    x2d = data.reshape(rows, c)
    sc1, sh1 = _bn_vectors(mu0, var0, g1, b1, eps)[:2]
    y1, s1, ss1 = mm_fwd(x2d, w1, sc1, sh1, training)
    mu1, var1 = _stats_from_sums(s1, ss1, rows) if training \
        else fixed_stats[:2]
    sc2, sh2 = _bn_vectors(mu1, var1, g2, b2, eps)[:2]
    mode = _c3_mode()
    if mode == "xla":
        y2 = _c3_fwd_segment(y1.reshape(n, h, w_, cq), w2, sc2, sh2)
        y2 = y2.reshape(rows, cq)
        if training:
            yf = y2.float()
            s2, ss2 = yf.sum(0), (yf * yf).sum(0)
    elif mode == "4d":
        # the NHWC view of the contiguous (rows, C) tensors: no copy
        y2, s2, ss2 = c3_fwd4d(y1.reshape(n, h, w_, cq), w2, sc2, sh2,
                               training)
        y2 = y2.reshape(rows, cq)
    else:
        y2, s2, ss2 = c3_fwd2d(y1, w2, sc2, sh2, n, h, w_, training)
    mu2, var2 = _stats_from_sums(s2, ss2, rows) if training \
        else fixed_stats[2:]
    sc3, sh3 = _bn_vectors(mu2, var2, g3, b3, eps)[:2]
    out = mm_skip_fwd(y2, w3, sc3, sh3, x2d).reshape(data.shape)
    return out, y1, y2, (mu1, var1), (mu2, var2)


class _FusedUnitCore(torch.autograd.Function):
    """The training chain with its hand-written backward (the reference's
    ``_fused_unit_core`` custom VJP).  Outputs (out, mu1, var1, mu2, var2):
    the interior batch statistics feed the moving averages only and carry
    no gradient."""

    @staticmethod
    def forward(ctx, cfg, data, g1, b1, w1, g2, b2, w2, g3, b3, w3, mu0,
                var0):
        out, y1, y2, st1, st2 = _fused_unit_chain(
            *cfg, data, g1, b1, w1, g2, b2, w2, g3, b3, w3, mu0, var0)
        ctx.cfg = cfg
        ctx.save_for_backward(data, y1, y2, *st1, *st2, g1, b1, w1, g2, b2,
                              w2, g3, b3, w3, mu0, var0)
        ctx.mark_non_differentiable(*st1, *st2)
        return (out,) + st1 + st2

    @staticmethod
    def backward(ctx, g_out, *_stat_cots):
        (data, y1, y2, mu1, var1, mu2, var2, g1, b1, w1, g2, b2, w2, g3, b3,
         w3, mu0, var0) = ctx.saved_tensors
        eps, n, h, w_ = ctx.cfg
        c = data.shape[-1]
        rows = n * h * w_
        x2d = data.reshape(rows, c)
        g2d = g_out.contiguous().reshape(rows, c)
        sc1, sh1, xs0, xh0, inv0 = _bn_vectors(mu0, var0, g1, b1, eps)
        sc2, sh2, xs1, xh1, inv1 = _bn_vectors(mu1, var1, g2, b2, eps)
        sc3, sh3, xs2, xh2, inv2 = _bn_vectors(mu2, var2, g3, b3, eps)
        # conv3: the cotangent at `out` is final (the skip passes it to
        # the data's gradient unchanged, added at the end)
        dp3, dw3, db3, dg3 = mm_bwd(g2d, None, None, y2, w3, sc3, sh3, xs2,
                                    xh2)
        # conv2: bn3's backward finalized in the prologue
        fin3 = _finalize_vectors(g3, inv2, mu2, db3, dg3, rows)
        mode = _c3_mode()
        if mode == "4d":
            nhwc = (n, h, w_, -1)
            dp2, dw2, db2, dg2 = c3_bwd4d(
                dp3.reshape(nhwc), y2.reshape(nhwc), fin3, y1.reshape(nhwc),
                w2, sc2, sh2, xs1, xh1)
            dp2 = dp2.reshape(rows, -1)
        else:
            c3_bwd = _c3_bwd_segment if mode == "xla" else c3_bwd2d
            dp2, dw2, db2, dg2 = c3_bwd(dp3, y2, fin3, y1, w2, sc2, sh2,
                                        xs1, xh1, n, h, w_)
        # conv1: bn2's backward finalized in the prologue
        fin2 = _finalize_vectors(g2, inv1, mu1, db2, dg2, rows)
        dp1, dw1, db1, dg1 = mm_bwd(dp2, y1, fin2, x2d, w1, sc1, sh1, xs0,
                                    xh0)
        # close: bn1's backward and the skip path
        c1v, u0v, u1v = _finalize_vectors(g1, inv0, mu0, db1, dg1, rows)
        g_data = (c1v * dp1.float() + u0v + u1v * x2d.float()
                  + g2d.float()).to(data.dtype)
        return (None, g_data.reshape(data.shape),
                dg1.to(g1.dtype), db1.to(b1.dtype), dw1.reshape(w1.shape)
                .to(w1.dtype),
                dg2.to(g2.dtype), db2.to(b2.dtype), dw2.to(w2.dtype),
                dg3.to(g3.dtype), db3.to(b3.dtype), dw3.reshape(w3.shape)
                .to(w3.dtype),
                None, None)


# ---------------------------------------------------------------------------
# Registry op
# ---------------------------------------------------------------------------

def _fbu_fill(attrs, in_shapes):
    out = list(in_shapes)
    dshape = out[0]
    if dshape is None:
        return out
    c = dshape[-1]
    cq = attrs["num_filter"] // 4
    want = [None, (c,), (c,), (cq, 1, 1, c),
            (cq,), (cq,), (cq, 3, 3, cq),
            (cq,), (cq,), (c, 1, 1, cq),
            (c,), (c,), (cq,), (cq,), (cq,), (cq,)]
    for i in range(1, len(out)):
        if out[i] is None and i < len(want):
            out[i] = want[i]
    return out


@register("_contrib_FusedBottleneckUnit",
          nin=16,
          input_names=["data", "gamma1", "beta1", "weight1",
                       "gamma2", "beta2", "weight2",
                       "gamma3", "beta3", "weight3",
                       "moving_mean1", "moving_var1",
                       "moving_mean2", "moving_var2",
                       "moving_mean3", "moving_var3"],
          aux_inputs=(10, 11, 12, 13, 14, 15), nout=1,
          mutate_aux={10: 1, 11: 2, 12: 3, 13: 4, 14: 5, 15: 6},
          mode_dependent=True, fill_shapes=_fbu_fill,
          params={"num_filter": P(int), "eps": P(float, EPS_DEFAULT),
                  "momentum": P(float, 0.9),
                  "height": P(int, 0), "width": P(int, 0),
                  "layout": P("str_or_none", None)})
def fused_bottleneck_unit(attrs, data, g1, b1, w1, g2, b2, w2, g3, b3, w3,
                          mm1, mv1, mm2, mv2, mm3, mv3):
    """A stride-1 dim-match pre-activation bottleneck unit as the fused
    kernel chain.  Parameters match the unfused subgraph
    (models/resnet.py _residual_unit).  NHWC 4D data, or (rows, C) 2D data
    with the ``height``/``width`` attrs.  Training normalizes by batch
    statistics, records the kernels' backward and returns the six moving
    averages updated (each once); eval uses and returns them unchanged."""
    if data.ndim == 4:
        n, h, w_, _c = data.shape
    elif data.ndim == 2:
        h, w_ = attrs["height"], attrs["width"]
        if not (h and w_):
            raise MXNetError("_contrib_FusedBottleneckUnit with 2D data "
                             "needs height/width attrs")
        if data.shape[0] % (h * w_):
            raise MXNetError(
                "_contrib_FusedBottleneckUnit 2D data: %d rows is not a "
                "multiple of height*width = %d*%d" % (data.shape[0], h, w_))
        n = data.shape[0] // (h * w_)
    else:
        raise MXNetError("_contrib_FusedBottleneckUnit expects NHWC 4D "
                         "or (rows, C) 2D data")
    eps, mom = attrs["eps"], attrs["momentum"]
    if attrs.get("_training", False):
        with torch.no_grad():
            xf = data.float().reshape(-1, data.shape[-1])
            mu0, var0 = xf.mean(0), xf.var(0, unbiased=False)
        out, mu1, var1, mu2, var2 = _FusedUnitCore.apply(
            (eps, n, h, w_), data, g1, b1, w1, g2, b2, w2, g3, b3, w3, mu0,
            var0)

        def upd(old, new):
            return mom * old + (1 - mom) * new.detach()
        return (out, upd(mm1, mu0), upd(mv1, var0), upd(mm2, mu1),
                upd(mv2, var1), upd(mm3, mu2), upd(mv3, var2))
    out = _fused_unit_chain(eps, n, h, w_, data, g1, b1, w1, g2, b2, w2, g3,
                            b3, w3, mm1.float(), mv1.float(),
                            (mm2.float(), mv2.float(), mm3.float(),
                             mv3.float()))[0]
    return (out, mm1, mv1, mm2, mv2, mm3, mv3)
