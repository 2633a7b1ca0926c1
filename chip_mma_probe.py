#!/usr/bin/env python3
"""Where the time of the tensor-core tile loops of K1-K8 goes, on one
card.

    python3 chip_mma_probe.py [--json PATH] [--fixture PATH]

1. The kernels each launch of K1 (``fused_unit.mm_fwd``, with statistics,
   at ResNet-50's four stage shapes at batch 8), K2 (``mm_skip_fwd``), K3
   (``c3_fwd2d``) and K4 (``c3_fwd4d``), both with statistics, at batch 8
   and 32, K5 (``mm_bwd``, final and deferred, at batch 32), K6
   (``c3_bwd2d``) and K7 (``c3_bwd4d``) at batch 32 and K8
   (``nn.conv1x1_bwd``, at its three sites at batch 32) runs, with their
   device time from torch.profiler: the GEMMs, the split epilogue or
   reduction, the statistics' column sums.  Then K2 beside K1 on K2's
   operands (the same product and plan without the residual) and beside
   ``torch.add`` of two tensors of K2's output shape (the bytes its
   epilogue moves): what reading the residual costs.
2. A phase profile of the loops themselves: ``csrc/fu_mma.cuh`` and
   ``csrc/fu_halo.cuh`` copied into ``build/probe/`` with ``clock64`` and
   ``%globaltimer`` reads added around their phases (waiting for a tile's
   copies, the in-place transform, the barrier, the fragment loads and
   MMAs), built by ``nvcc`` and run on K1-shaped products with the
   operand raw and through the BN+ReLU prologue, and on K6's and K7's
   dgrad and wgrad at the four stage shapes at batch 32 and K3's and K4's
   forward, with statistics, at batch 8 (the gathered operand against the
   resident halo): cycles per k tile in each phase, the blocks an SM held
   at once, and the SM clock.  The instrumented copies only measure; the
   port never loads them.
3. One ``mma.sync.m16n8k8.tf32`` per warp on seeded inputs (values of
   one scale, exponents spread over 2^+-20 and 2^+-30, sums that cancel)
   against ``fused_unit._mma_step``, the CPU model of how the tensor core
   rounds (``--fixture PATH`` also writes 48 of them for
   ``tests/test_torch_mma.py``); then the float32 results of K1-K4 and K7
   against their CPU emulations (``fused_unit.mm_fwd_tf32x3``,
   ``mm_skip_fwd_tf32x3``, ``c3_fwd2d_tf32x3``, ``c3_fwd4d_tf32x3``,
   ``c3_bwd4d_tf32x3``) on small seeded cases, with
   the MMAs added in f32 and with ``exact``: the share of equal bits, the
   largest and median difference in ulps, and the relative difference
   beside the plain version's.

It needs a CUDA card and ``nvcc``, like ``chip_smoke.py``, and prints the
card's name and power limit first.  The numbers in PERF.md's findings on
the tile loop come from it.
"""
import argparse
import collections
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# the instrumentation: (text of fu_mma.cuh, text that replaces it)
PROBES = [
    ('#include "fu_gemm.cuh"',
     '#include "../../mxnet_tpu_torch/csrc/fu_gemm.cuh"'),
    ('  int M, N, K, chunk, splits, stats;\n};',
     '  int M, N, K, chunk, splits, stats;\n  unsigned long long* prof;\n};'),
    ('''  for (int t = 0; t < ntiles; ++t) {
    unsigned char* st = ring + (t % NS) * RG::STAGE;
    const unsigned char* sa = st;
    const unsigned char* sb = st + RG::A;
    // this thread's copies of tile t have landed: rewrite them in place
    cp_async_wait<NS - 2>();''',
     '''  unsigned long long ph[4] = {0, 0, 0, 0}, g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const unsigned long long tk0 = clock64();
  for (int t = 0; t < ntiles; ++t) {
    unsigned char* st = ring + (t % NS) * RG::STAGE;
    const unsigned char* sa = st;
    const unsigned char* sb = st + RG::A;
    const unsigned long long c0 = clock64();
    cp_async_wait<NS - 2>();
    const unsigned long long c1 = clock64();
    ph[0] += c1 - c0;'''),
    ('''    ldb.transform(p.b, n0, p.N, k0, kend, st + RG::A);
    // every thread's tile t is in place, and every thread is done with
    // tile t - 1, whose stage the next copies overwrite
    __syncthreads();''',
     '''    ldb.transform(p.b, n0, p.N, k0, kend, st + RG::A);
    const unsigned long long c2 = clock64();
    ph[1] += c2 - c1;
    __syncthreads();
    const unsigned long long c3 = clock64();
    ph[2] += c3 - c2;'''),
    ('''            mma_bf16(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
    if constexpr (F32) promote(acc, part);
  }''',
     '''            mma_bf16(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
    if constexpr (F32) promote(acc, part);
    ph[3] += clock64() - c3;
  }
  float done = 0.f;   // the last MMAs retired
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) done += acc[i][j][0];
  const unsigned long long tk1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  unsigned int smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  if (lane == 0 && p.prof) {
    unsigned long long* q = p.prof + (((size_t)blockIdx.z * gridDim.y
        + blockIdx.y) * gridDim.x + blockIdx.x) * 8 * 9 + warp * 9;
    for (int u = 0; u < 4; ++u) q[u] = ph[u];
    q[4] = done != 12345.f ? ntiles : ntiles + 1;
    q[5] = smid; q[6] = g0; q[7] = g1; q[8] = tk1 - tk0;
  }'''),
]

# the same instrumentation of fu_halo.cuh's dgrad and wgrad loops: nine
# record slots a block (the wgrad has a warp a tap) of HALO_REC values, two
# more than the tile loop's: the barrier that opens a channel chunk or band,
# and the staging of the halo (its copies issued and rewritten)
HALO_REC = 11
_HALO_INIT = """  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0}, g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const unsigned long long tk0 = clock64();
"""
_HALO_DUMP = """  float done = 0.f;   // the last MMAs retired
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) done += acc[i][jj][0];
  const unsigned long long tk1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  unsigned int smid;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
  if ((threadIdx.x & 31) == 0 && p.prof) {
    unsigned long long* q = p.prof + (((size_t)blockIdx.z * gridDim.y
        + blockIdx.y) * gridDim.x + blockIdx.x) * 9 * 11
        + (threadIdx.x >> 5) * 11;
    q[0] = ph[0]; q[1] = ph[1] - ph[0]; q[2] = ph[2]; q[3] = ph[3];
    q[4] = done != 12345.f ? NTILES : NTILES + 1;
    q[5] = smid; q[6] = g0; q[7] = g1; q[8] = tk1 - tk0;
    q[9] = ph[4]; q[10] = ph[5];
  }
"""
HALO_PROBES = [
    ('#include "fu_mma.cuh"', '#include "fu_mma_probe.cuh"'),
    ("""  for (int j = 0; j < ntiles; ++j) {
    int t, c0, c1;
    tile(j, t, c0, c1);""",
     _HALO_INIT + """  for (int j = 0; j < ntiles; ++j) {
    const unsigned long long q0 = clock64();
    int t, c0, c1;
    tile(j, t, c0, c1);"""),
    ("""    if (t == 0) {
      // a new channel chunk: every warp is done with the last one's halo
      if (j) __syncthreads();
      hs.issue(p.a, halo, plane, hg.rows, p.M, c0, c1, src);
      cp_async_commit();
      cp_async_wait<0>();
      hs.transform(p.a, halo, plane, hg.rows, p.M, c0, c1, src);
    } else {
      cp_async_wait<NS - 2>();
    }""", """    if (t == 0) {
      const unsigned long long h0 = clock64();
      if (j) __syncthreads();
      const unsigned long long h1 = clock64();
      hs.issue(p.a, halo, plane, hg.rows, p.M, c0, c1, src);
      cp_async_commit();
      const unsigned long long w0 = clock64();
      cp_async_wait<0>();
      const unsigned long long w1 = clock64();
      hs.transform(p.a, halo, plane, hg.rows, p.M, c0, c1, src);
      const unsigned long long h2 = clock64();
      ph[0] += w1 - w0;
      ph[4] += h1 - h0;
      ph[5] += (w0 - h1) + (h2 - w1);
    } else {
      const unsigned long long w0 = clock64();
      cp_async_wait<NS - 2>();
      ph[0] += clock64() - w0;
    }"""),
    ("""    ldb.transform(p.b, n0, p.N, t * p.K + c0, t * p.K + c1, sb);
    // the halo and tile j are in place, and every warp is done with tile
    // j - 1, whose stage the next copies overwrite
    __syncthreads();""",
     """    ldb.transform(p.b, n0, p.N, t * p.K + c0, t * p.K + c1, sb);
    const unsigned long long q1 = clock64();
    ph[1] += q1 - q0;
    __syncthreads();
    const unsigned long long q2 = clock64();
    ph[2] += q2 - q1;"""),
    ("""            mma_bf16(acc[i][jj], ah[i], bh[jj][0], bh[jj][1]);
      }
    }
    if constexpr (F32) promote(acc, part);
  }
  tile_epilogue""",
     """            mma_bf16(acc[i][jj], ah[i], bh[jj][0], bh[jj][1]);
      }
    }
    if constexpr (F32) promote(acc, part);
    ph[3] += clock64() - q2;
  }
""" + _HALO_DUMP.replace("NTILES", "ntiles") + """  tile_epilogue"""),
    ("""  for (int p0 = kbeg; p0 < kend; p0 += BAND) {
""", _HALO_INIT + """  for (int p0 = kbeg; p0 < kend; p0 += BAND) {
    const unsigned long long q0 = clock64();
"""),
    ("""    if (p0 != kbeg) __syncthreads();
    gst.issue(""", """    if (p0 != kbeg) __syncthreads();
    const unsigned long long h1 = clock64();
    ph[4] += h1 - q0;
    gst.issue("""),
    ("""    ast.issue(p.a, hs, hplane, hg.rows, p.K, i0, p.M, asrc);""",
     """    const unsigned long long a0 = clock64();
    ast.issue(p.a, hs, hplane, hg.rows, p.K, i0, p.M, asrc);
    ph[5] += clock64() - a0;"""),
    ("""    cp_async_wait<0>();
    gst.transform(p.b, gs, SM::GPLANE, BAND, kend, o0, p.N, gsrc);
    ast.transform(p.a, hs, hplane, hg.rows, p.K, i0, p.M, asrc);
    __syncthreads();""", """    const unsigned long long w0 = clock64();
    cp_async_wait<0>();
    ph[0] += clock64() - w0;
    gst.transform(p.b, gs, SM::GPLANE, BAND, kend, o0, p.N, gsrc);
    const unsigned long long a1 = clock64();
    ast.transform(p.a, hs, hplane, hg.rows, p.K, i0, p.M, asrc);
    const unsigned long long q1 = clock64();
    ph[5] += q1 - a1;
    ph[1] += q1 - q0;
    __syncthreads();
    const unsigned long long q2 = clock64();
    ph[2] += q2 - q1;"""),
    ("""            mma_bf16(acc[i][j], ah[i], bh[j][0], bh[j][1]);
        }
      }
    }
    if constexpr (F32) promote(acc, part);
  }
""", """            mma_bf16(acc[i][j], ah[i], bh[j][0], bh[j][1]);
        }
      }
    }
    if constexpr (F32) promote(acc, part);
    ph[3] += clock64() - q2;
  }
""" + _HALO_DUMP.replace("NTILES", "(kend - kbeg + BAND - 1) / BAND")
     .replace("jj", "j")),
]

ENTRY = r'''
#include "fu_halo_probe.cuh"
template <typename T, int AX>
static int run(const void* x, const void* w, const void* sc, const void* sh,
               void* y, void* ws, void* prof, int R, int K, int N, int bm,
               int bn, int splits, int chunk, cudaStream_t st) {
  fmma::Gemm p = {};
  p.a = {x, nullptr, static_cast<const float*>(sc),
         static_cast<const float*>(sh), nullptr, K};
  p.b = {w, nullptr, nullptr, nullptr, nullptr, K};
  p.out = y; p.ws = static_cast<float*>(ws);
  p.M = R; p.N = N; p.K = K; p.chunk = chunk; p.splits = splits;
  p.prof = static_cast<unsigned long long*>(prof);
  return fmma::gemm<T, fmma::K_MAJOR, AX, fmma::K_MAJOR, fmma::X_RAW,
                    fmma::EPI_Y>(p, bm, bn, st);
}
extern "C" int probe_k1(const void* x, const void* w, const void* sc,
                        const void* sh, void* y, void* ws, void* prof, int R,
                        int K, int N, int bf16, int raw, int bm, int bn,
                        int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return raw ? run<__nv_bfloat16, fmma::X_RAW>(x, w, sc, sh, y, ws, prof,
                     R, K, N, bm, bn, splits, chunk, st)
               : run<__nv_bfloat16, fmma::X_PROLOGUE>(x, w, sc, sh, y, ws,
                     prof, R, K, N, bm, bn, splits, chunk, st);
  return raw ? run<float, fmma::X_RAW>(x, w, sc, sh, y, ws, prof, R, K, N,
                                      bm, bn, splits, chunk, st)
             : run<float, fmma::X_PROLOGUE>(x, w, sc, sh, y, ws, prof, R, K,
                                           N, bm, bn, splits, chunk, st);
}
// K6's (k7 = 0, fu_c3_bwd2d.cu) or K7's (k7 = 1, fu_c3_bwd4d.cu) dgrad
// (which = 0) or wgrad (which = 1) alone, set up as those entry points do
template <typename T>
static int run_bwd(int k7, int which, const fmma::Gemm& d, int bm, int bn,
                   cudaStream_t st) {
  using namespace fmma;
  if (which == 0)
    return k7 ? fhalo::conv<T, fhalo::DGRAD>(d, bm, bn, st)
              : gemm<T, K_MAJOR, X_FINALIZE, MN_MAJOR, X_RAW, EPI_DP,
                     G_SHIFT_K, G_OHWI>(d, bm, bn, st);
  return k7 ? fhalo::wgrad<T>(d, st)
            : gemm<T, MN_MAJOR, X_FINALIZE, MN_MAJOR, X_PROLOGUE, EPI_F32,
                   G_NONE, G_SHIFT_N>(d, bm, bn, st);
}
extern "C" int probe_bwd(int k7, int which, const void* g, const void* yraw,
                         const void* c1, const void* u0, const void* u1,
                         const void* x, const void* w, const void* sc,
                         const void* sh, const void* xs, const void* xh,
                         void* dp, void* part, void* dw, void* ws,
                         void* prof, int R, int Ci, int Co, int H, int W,
                         int bf16, int bm, int bn, int splits, int chunk,
                         void* stream) {
  const float* v[7] = {static_cast<const float*>(c1),
                       static_cast<const float*>(u0),
                       static_cast<const float*>(u1),
                       static_cast<const float*>(sc),
                       static_cast<const float*>(sh),
                       static_cast<const float*>(xs),
                       static_cast<const float*>(xh)};
  fmma::Gemm d = {};
  if (which == 0) {
    d.a = {g, yraw, v[0], v[1], v[2], Co, Co, H, W};
    d.b = {w, nullptr, nullptr, nullptr, nullptr, Ci, Co, H, W};
    d.out = dp; d.spart = static_cast<float*>(part); d.x = x;
    d.sc = v[3]; d.sh = v[4]; d.xs = v[5]; d.xh = v[6];
    d.M = R; d.N = Ci; d.K = k7 ? Co : 9 * Co; d.stats = 1;
  } else if (k7) {
    d.a = {x, nullptr, v[3], v[4], nullptr, Ci, Ci, H, W};
    d.b = {g, yraw, v[0], v[1], v[2], Co, Co, H, W};
    d.out = dw; d.M = Ci; d.N = Co; d.K = R;
  } else {
    d.a = {g, yraw, v[0], v[1], v[2], Co};
    d.b = {x, nullptr, v[3], v[4], nullptr, Ci, Ci, H, W};
    d.out = dw; d.M = Co; d.N = 9 * Ci; d.K = R;
  }
  d.ws = static_cast<float*>(ws);
  d.chunk = chunk; d.splits = splits;
  d.prof = static_cast<unsigned long long*>(prof);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return run_bwd<__nv_bfloat16>(k7, which, d, bm, bn, st);
  return run_bwd<float>(k7, which, d, bm, bn, st);
}
// K3's forward (k4 = 0, fu_c3_fwd2d.cu: the tap gather) or K4's (k4 = 1,
// fu_c3_fwd4d.cu: the halo) with statistics, set up as those entry points
// do
template <typename T>
static int run_fwd(int k4, const fmma::Gemm& p, int bm, int bn,
                   cudaStream_t st) {
  using namespace fmma;
  return k4 ? fhalo::conv<T, fhalo::FWD>(p, bm, bn, st)
            : gemm<T, K_MAJOR, X_PROLOGUE, K_MAJOR, X_RAW, EPI_Y,
                   G_SHIFT_KP, G_NONE>(p, bm, bn, st);
}
extern "C" int probe_fwd(int k4, const void* x, const void* w,
                         const void* sc, const void* sh, void* y, void* part,
                         void* ws, void* prof, int N, int H, int W, int C,
                         int Co, int bf16, int bm, int bn, int splits,
                         int chunk, void* stream) {
  fmma::Gemm p = {};
  p.a = {x, nullptr, static_cast<const float*>(sc),
         static_cast<const float*>(sh), nullptr, C, C, H, W};
  p.b = {w, nullptr, nullptr, nullptr, nullptr, 9 * C};
  p.out = y; p.spart = static_cast<float*>(part);
  p.ws = static_cast<float*>(ws);
  p.M = N * H * W; p.N = Co; p.K = k4 ? C : 9 * C;
  p.chunk = chunk; p.splits = splits; p.stats = 1;
  p.prof = static_cast<unsigned long long*>(prof);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return run_fwd<__nv_bfloat16>(k4, p, bm, bn, st);
  return run_fwd<float>(k4, p, bm, bn, st);
}
'''


def kernel_split(torch, cs, fu, nn, dev, out):
    """Device time of every kernel a K1, K3 or K5-K8 launch runs."""
    gen = torch.Generator().manual_seed(0)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen) * scale).to(dev)

    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        stages = [(st, cs.BATCH, side) for st, side in zip(cs.STAGES,
                                                            cs.STAGE_HW)]
        stages += [(st, cs.TRAIN_BATCH, side)
                   for st, side in zip(cs.STAGES, cs.STAGE_HW)]
        for (hw, c, _), batch, side in stages:
            r, cq = batch * hw, c // 4
            calls = []          # (name, rows, call)
            y1 = rn(r, cq).to(dt)
            w2 = rn(cq, 3, 3, cq, scale=(9 * cq) ** -0.5).to(dt)
            v2 = (rn(cq).abs() + 0.5, rn(cq, scale=0.1))
            calls.append(("K3 stats", r, lambda a=(y1, w2) + v2
                          + (batch, side, side, True): fu.c3_fwd2d(*a)))
            calls.append(("K4 stats", r, lambda a=(
                y1.reshape(batch, side, side, cq), w2) + v2 + (True,):
                fu.c3_fwd4d(*a)))
            a2 = (y1, rn(c, 1, 1, cq, scale=cq ** -0.5).to(dt)) + v2 \
                + (rn(r, c).to(dt),)
            calls.append(("K2", r, lambda a=a2: fu.mm_skip_fwd(*a)))
            if batch == cs.BATCH:
                x = rn(r, c).to(dt)
                w = rn(cq, 1, 1, c, scale=c ** -0.5).to(dt)
                v = (rn(c).abs() + 0.5, rn(c, scale=0.1))
                calls.append(("K1 stats", r, lambda x=x, w=w, v=v:
                              fu.mm_fwd(x, w, *v, True)))
            else:
                for variant, ci, co in (("final", cq, c),
                                        ("deferred", c, cq), ("K6", cq, cq)):
                    x = rn(r, ci).to(dt)
                    g = rn(r, co).to(dt)
                    v = (rn(ci).abs() + 0.5, rn(ci, scale=0.1),
                         rn(ci).abs() + 0.5, rn(ci, scale=0.1))
                    fin = yraw = None
                    if variant != "final":
                        fin = (rn(co).abs() + 0.5, rn(co, scale=0.1),
                               rn(co, scale=0.1))
                        yraw = rn(r, co).to(dt)
                    if variant == "K6":
                        w = rn(co, 3, 3, ci, scale=(9 * ci) ** -0.5).to(dt)
                        calls.append(("K6", r, lambda a=(g, yraw, fin, x, w)
                                      + v + (batch, side, side):
                                      fu.c3_bwd2d(*a)))
                        nhwc = (batch, side, side, -1)
                        calls.append(("K7", r, lambda a=(
                            g.reshape(nhwc), yraw.reshape(nhwc), fin,
                            x.reshape(nhwc), w) + v: fu.c3_bwd4d(*a)))
                        continue
                    w = rn(co, 1, 1, ci, scale=ci ** -0.5).to(dt)
                    calls.append(("K5 " + variant, r,
                                  lambda a=(g, yraw, fin, x, w) + v:
                                  fu.mm_bwd(*a)))
            if batch == cs.TRAIN_BATCH and side == cs.STAGE_HW[-1]:
                for site, shw, ci, co in cs.K8_SITES:
                    rows = cs.TRAIN_BATCH * shw
                    a8 = (rn(rows, ci).to(dt), rn(rows, co).to(dt),
                          rn(co, 1, 1, ci, scale=ci ** -0.5).to(dt))
                    calls.append(("K8 " + site, rows,
                                  lambda a=a8: nn.conv1x1_bwd(*a)))
            for name, rows, fn in calls:
                prof = cs.profile_calls(torch, fn, 5)
                row = {"kernel": name, "dtype": dname, "rows": rows, "c": c,
                       "device_ms": prof["device_busy_ms"],
                       "parts_ms": prof["top_device_ms"]}
                out.append(row)
                cs.log("  %-11s %-8s rows %6d C %4d: %.4f ms = %s" % (
                    name, dname, rows, c, row["device_ms"], ", ".join(
                        "%s %.4f" % (k.split("(")[0].replace("void ", ""),
                                     ms)
                        for k, ms in row["parts_ms"])))


def _instrumented(name, probes, bdir):
    """csrc/<name> with the probe texts replaced, written to bdir as
    <stem>_probe.cuh."""
    src = open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc", name)).read()
    for old, new in probes:
        if src.count(old) != 1:
            raise SystemExit("chip_mma_probe: %s no longer has the text the "
                             "probe instruments: %r" % (name, old[:60]))
        src = src.replace(old, new)
    with open(os.path.join(bdir, name.replace(".cuh", "_probe.cuh")),
              "w") as f:
        f.write(src)


def build_probe():
    """The instrumented loops and their entry points, built by nvcc."""
    from mxnet_tpu_torch import cuda_build
    bdir = os.path.join(ROOT, "build", "probe")
    os.makedirs(bdir, exist_ok=True)
    _instrumented("fu_mma.cuh", PROBES, bdir)
    _instrumented("fu_halo.cuh", HALO_PROBES, bdir)
    with open(os.path.join(bdir, "probe.cu"), "w") as f:
        f.write(ENTRY)
    lib_path = os.path.join(bdir, "libprobe.so")
    build = subprocess.run([cuda_build._nvcc()] + cuda_build.FLAGS
                           + ["-o", lib_path, os.path.join(bdir, "probe.cu")],
                           capture_output=True, text=True)
    if build.returncode:
        raise SystemExit("chip_mma_probe: nvcc failed:\n" + build.stdout
                         + build.stderr)
    lib = ctypes.CDLL(lib_path)
    lib.probe_k1.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    lib.probe_bwd.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 16 \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.probe_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    for fn in (lib.probe_k1, lib.probe_bwd, lib.probe_fwd):
        fn.restype = ctypes.c_int
    return lib


def read_records(torch, rec, blocks, slots, width=9):
    """(k tiles a block, cycles per k tile in each phase (and in the
    halo loops' two sub-phases, `width` 11), the block loop's mean
    microseconds, the most blocks an SM held at once, the SM GHz) from the
    records of `blocks` blocks of `slots` warp slots each."""
    q = rec.view(blocks, slots, width).cpu()
    live = q[:, :, 4] > 0
    tiles = float(q[:, :, 4][live].double().mean())
    phases = [float(q[:, :, u][live].double().mean()) / tiles
              for u in list(range(4)) + list(range(9, width))]
    w0 = q[:, 0, :]
    per_sm = collections.defaultdict(list)
    for row in w0.tolist():
        per_sm[row[5]].append((row[6], row[7]))
    most = 0
    for spans in per_sm.values():
        live_n = 0
        for _, d in sorted([(a, 1) for a, _ in spans]
                           + [(b, -1) for _, b in spans]):
            live_n += d
            most = max(most, live_n)
    ns = (w0[:, 7] - w0[:, 6]).double()
    ghz = float((w0[:, 8].double() / ns).mean())
    return tiles, phases, float(ns.mean()) / 1e3, most, ghz


def _call(torch, fn, args):
    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("probe launch failed: %d" % rc)
    return call


def phase_profile(torch, cs, lib, dev, out):
    """The instrumented loop on K1-shaped products."""
    from mxnet_tpu_torch.ops import _cuda
    gen = torch.Generator().manual_seed(1)
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for r, k, n in ((25088, 256, 64), (392, 2048, 512),
                        (100352, 256, 64), (6272, 1024, 256)):
            x = torch.randn(r, k, generator=gen).to(dev).to(dt)
            w = (torch.randn(n, k, generator=gen) * k ** -0.5).to(dev).to(dt)
            sc = (torch.rand(k, generator=gen) + 0.5).to(dev)
            sh = (torch.randn(k, generator=gen) * 0.1).to(dev)
            bm, bn, splits, chunk = _cuda.mma_plan(r, n, k,
                                                   dt == torch.float32)
            ws = torch.empty((splits, r, n), device=dev) if splits > 1 \
                else None
            y = torch.empty((r, n), device=dev, dtype=dt)
            blocks = -(-r // bm) * -(-n // bn) * splits
            for raw in (1, 0):
                rec = torch.zeros(blocks * 8 * 9, dtype=torch.int64,
                                  device=dev)
                args = [x.data_ptr(), w.data_ptr(), sc.data_ptr(),
                        sh.data_ptr(), y.data_ptr(),
                        None if ws is None else ws.data_ptr(), None, r, k,
                        n, int(dt == torch.bfloat16), raw, bm, bn, splits,
                        chunk]
                call = _call(torch, lib.probe_k1, args)
                call()
                ms = cs.time_ms(torch, call)
                args[6] = rec.data_ptr()
                call()
                torch.cuda.synchronize()
                tiles, phases, us, most, ghz = read_records(torch, rec,
                                                            blocks, 8)
                row = {"dtype": dname, "rows": r, "k": k, "n": n,
                       "plan": [bm, bn, splits, chunk], "blocks": blocks,
                       "operand": "raw" if raw else "prologue", "ms": ms,
                       "tiles_per_block": tiles,
                       "cycles_per_tile": dict(zip(
                           ("wait", "transform", "barrier", "multiply"),
                           phases)),
                       "block_loop_us": us,
                       "most_blocks_on_an_sm": most, "sm_ghz": ghz}
                out.append(row)
                cs.log("  %-8s %6d x %4d -> %3d %-8s plan %s, %d blocks: "
                       "%.4f ms; per k tile: wait %.0f, transform %.0f, "
                       "barrier %.0f, multiply %.0f cycles; block loop "
                       "%.2f us; %d blocks on an SM at once; SM %.3f GHz" % (
                           dname, r, k, n, row["operand"], tuple(row["plan"]),
                           blocks, ms, *phases, us, most, ghz))


def halo_profile(torch, cs, lib, dev, out):
    """K6's dgrad and wgrad (operands gathered per tap) beside K7's (the
    shared operand resident in a halo) at the four stage shapes at batch
    32: cycles per k tile in each phase.  A k tile is 128 bytes of k in
    both dgrads (32 f32 or 64 bf16 channels of one tap) and in K6's wgrad
    (as many pixels); K7's wgrad tile is its band of 64 (f32) or 128
    (bf16) pixels, so `per_128B` divides its cycles by the band's 128-byte
    tiles."""
    from mxnet_tpu_torch.ops import _cuda
    gen = torch.Generator().manual_seed(2)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        f32 = dt == torch.float32
        bk = 32 if f32 else 64
        for (hw, c, _), side in zip(cs.STAGES, cs.STAGE_HW):
            n, r, cq = cs.TRAIN_BATCH, cs.TRAIN_BATCH * hw, c // 4

            def rn(*s, scale=1.0):
                return (torch.randn(*s, generator=gen) * scale).to(dev)
            g, yraw, x = (rn(r, cq).to(dt) for _ in range(3))
            w = rn(cq, 3, 3, cq, scale=(9 * cq) ** -0.5).to(dt)
            vecs = [rn(cq).abs() + 0.5, rn(cq, scale=0.1), rn(cq, scale=0.1),
                    rn(cq).abs() + 0.5, rn(cq, scale=0.1),
                    rn(cq).abs() + 0.5, rn(cq, scale=0.1)]
            dp = torch.empty((r, cq), device=dev, dtype=dt)
            part = torch.empty((2, -(-r // 64), cq), device=dev)
            dw = torch.empty((cq, 9 * cq), device=dev)
            plans = {
                ("K6", 0): _cuda.mma_plan(r, cq, 9 * cq, f32),
                ("K6", 1): _cuda.mma_wgrad_plan(cq, 9 * cq, r),
                ("K7", 0): _cuda.halo_dgrad_plan(r, cq, cq, side, f32),
                ("K7", 1): (0, 0) + _cuda.halo_wgrad_plan(r, cq, cq, f32)}
            for (kname, which), (bm, bn, splits, chunk) in plans.items():
                k7 = kname == "K7"
                if which == 0:
                    grid = -(-r // bm) * -(-cq // bn)
                    ws = (splits, r, cq)
                elif k7:
                    grid = (-(-cq // 32)) ** 2
                    ws = (splits, cq, 9 * cq)
                else:
                    grid = -(-cq // bm) * -(-9 * cq // bn)
                    ws = (splits, cq, 9 * cq)
                blocks = grid * splits
                slots, width = (9, HALO_REC) if k7 else (8, 9)
                wsb = torch.empty(ws, device=dev) if splits > 1 else None
                rec = torch.zeros(blocks * slots * width, dtype=torch.int64,
                                  device=dev)
                args = [int(k7), which] + [t.data_ptr() for t in (
                    g, yraw, *vecs[:3], x, w, *vecs[3:], dp, part, dw)] \
                    + [None if wsb is None else wsb.data_ptr(), None, r, cq,
                       cq, side, side, int(not f32), bm, bn, splits, chunk]
                call = _call(torch, lib.probe_bwd, args)
                call()
                ms = cs.time_ms(torch, call)
                args[17] = rec.data_ptr()
                call()
                torch.cuda.synchronize()
                tiles, phases, us, most, ghz = read_records(
                    torch, rec, blocks, slots, width)
                ktile = _cuda.halo_wgrad_band(f32) if k7 and which else bk
                per = bk / ktile
                row = {"kernel": kname, "product": ("dgrad", "wgrad")[which],
                       "dtype": dname, "stage_side": side, "rows": r,
                       "c": cq, "plan": [bm, bn, splits, chunk],
                       "blocks": blocks, "ms": ms, "k_per_tile": ktile,
                       "tiles_per_block": tiles,
                       "cycles_per_tile": dict(zip(
                           ("wait", "transform", "barrier", "multiply",
                            "of which chunk barrier", "of which halo"),
                           phases)),
                       "cycles_per_128B": dict(zip(
                           ("wait", "transform", "barrier", "multiply",
                            "of which chunk barrier", "of which halo"),
                           [v * per for v in phases])),
                       "block_loop_us": us, "most_blocks_on_an_sm": most,
                       "sm_ghz": ghz}
                out.append(row)
                sub = ""
                if k7:
                    sub = " (of which chunk barrier %.0f, halo %.0f)" % (
                        phases[4] * per, phases[5] * per)
                cs.log("  %s %s %-8s stage %2dx%-2d C %3d plan %s, %d "
                       "blocks: %.4f ms; per 128 B of k: wait %.0f, "
                       "transform %.0f%s, barrier %.0f, multiply %.0f "
                       "cycles; %d blocks on an SM at once; SM %.3f GHz" % (
                           kname, row["product"], dname, side, side, cq,
                           tuple(row["plan"]), blocks, ms, phases[0] * per,
                           phases[1] * per, sub, phases[2] * per,
                           phases[3] * per, most, ghz))


def fwd_profile(torch, cs, lib, dev, out):
    """K3's forward (the activation gathered per tap) beside K4's (the
    activation resident in a halo), with statistics, at the four stage
    shapes at batch 8: cycles per k tile (128 bytes of one tap's channels
    in both) in each phase."""
    from mxnet_tpu_torch.ops import _cuda
    gen = torch.Generator().manual_seed(4)
    names = ("wait", "transform", "barrier", "multiply",
             "of which chunk barrier", "of which halo")
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        f32 = dt == torch.float32
        for (hw, c, _), side in zip(cs.STAGES, cs.STAGE_HW):
            n, r, cq = cs.BATCH, cs.BATCH * hw, c // 4
            x = (torch.randn(r, cq, generator=gen)).to(dev).to(dt)
            w = (torch.randn(cq, 3, 3, cq, generator=gen)
                 * (9 * cq) ** -0.5).to(dev).to(dt)
            sc = (torch.rand(cq, generator=gen) + 0.5).to(dev)
            sh = (torch.randn(cq, generator=gen) * 0.1).to(dev)
            y = torch.empty((r, cq), device=dev, dtype=dt)
            part = torch.empty((2, -(-r // 64), cq), device=dev)
            plans = {"K3": _cuda.mma_plan(r, cq, 9 * cq, f32),
                     "K4": _cuda.halo_fwd_plan(r, cq, cq, side, f32)}
            for kname, (bm, bn, splits, chunk) in plans.items():
                k4 = kname == "K4"
                blocks = -(-r // bm) * -(-cq // bn) * splits
                slots, width = (9, HALO_REC) if k4 else (8, 9)
                ws = torch.empty((splits, r, cq), device=dev) \
                    if splits > 1 else None
                rec = torch.zeros(blocks * slots * width, dtype=torch.int64,
                                  device=dev)
                args = [int(k4)] + [t.data_ptr() for t in (
                    x, w, sc, sh, y, part)] \
                    + [None if ws is None else ws.data_ptr(), None, n, side,
                       side, cq, cq, int(not f32), bm, bn, splits, chunk]
                call = _call(torch, lib.probe_fwd, args)
                call()
                ms = cs.time_ms(torch, call)
                args[8] = rec.data_ptr()
                call()
                torch.cuda.synchronize()
                tiles, phases, us, most, ghz = read_records(
                    torch, rec, blocks, slots, width)
                row = {"kernel": kname, "product": "forward",
                       "dtype": dname, "stage_side": side, "rows": r,
                       "c": cq, "plan": [bm, bn, splits, chunk],
                       "blocks": blocks, "ms": ms,
                       "tiles_per_block": tiles,
                       "cycles_per_tile": dict(zip(names, phases)),
                       "block_loop_us": us, "most_blocks_on_an_sm": most,
                       "sm_ghz": ghz}
                out.append(row)
                sub = ""
                if k4:
                    sub = " (of which chunk barrier %.0f, halo %.0f)" % (
                        phases[4], phases[5])
                cs.log("  %s forward %-8s stage %2dx%-2d C %3d plan %s, %d "
                       "blocks: %.4f ms; per 128 B of k: wait %.0f, "
                       "transform %.0f%s, barrier %.0f, multiply %.0f "
                       "cycles; %d blocks on an SM at once; SM %.3f GHz" % (
                           kname, dname, side, side, cq, tuple(row["plan"]),
                           blocks, ms, phases[0], phases[1], sub, phases[2],
                           phases[3], most, ghz))


def skip_cost(torch, cs, fu, dev, out):
    """K2 beside K1 on K2's operands without the residual (the same
    product, plan and loop) and beside ``torch.add`` of two tensors of K2's
    output shape (a pass that moves the bytes K2's epilogue moves: the
    residual read, y written, plus one more read), at the four stage
    shapes at batch 8, with K2's bound (bytes at 3.35 TB/s)."""
    gen = torch.Generator().manual_seed(5)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        es = torch.tensor([], dtype=dt).element_size()
        for hw, c, _ in cs.STAGES:
            r, cq = cs.BATCH * hw, c // 4
            x = torch.randn(r, cq, generator=gen).to(dev).to(dt)
            w = (torch.randn(c, 1, 1, cq, generator=gen)
                 * cq ** -0.5).to(dev).to(dt)
            sc = (torch.rand(cq, generator=gen) + 0.5).to(dev)
            sh = (torch.randn(cq, generator=gen) * 0.1).to(dev)
            skip = torch.randn(r, c, generator=gen).to(dev).to(dt)
            other = torch.randn(r, c, generator=gen).to(dev).to(dt)
            row = {"dtype": dname, "rows": r, "ci": cq, "co": c,
                   "k2_ms": cs.time_ms(torch, lambda: fu.mm_skip_fwd(
                       x, w, sc, sh, skip)),
                   "k1_same_product_ms": cs.time_ms(torch, lambda: fu.mm_fwd(
                       x, w, sc, sh)),
                   "add_ms": cs.time_ms(torch, lambda: torch.add(skip,
                                                                 other)),
                   "bound_ms": 1e3 * (r * cq + cq * c + 2 * r * c) * es
                   / cs.HBM_BYTES_S}
            out.append(row)
            cs.log("  K2 %-8s %6d x %4d -> %4d: %.4f ms; K1 on the same "
                   "product %.4f ms (residual %.4f ms); torch.add of two %d "
                   "x %d %.4f ms; bound %.4f ms (bytes)" % (
                       dname, r, cq, c, row["k2_ms"],
                       row["k1_same_product_ms"],
                       row["k2_ms"] - row["k1_same_product_ms"], r, c,
                       row["add_ms"], row["bound_ms"]))


MMA_SOURCE = r"""
extern "C" __global__ void mma_tf32(const float* A, const float* B,
                                    const float* C, float* D, int n) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (warp >= n) return;
  const float* a = A + warp * 128;
  const float* b = B + warp * 64;
  const float* c = C + warp * 128;
  float* d = D + warp * 128;
  unsigned ra[4] = {__float_as_uint(a[g * 8 + t]),
                    __float_as_uint(a[(g + 8) * 8 + t]),
                    __float_as_uint(a[g * 8 + t + 4]),
                    __float_as_uint(a[(g + 8) * 8 + t + 4])};
  unsigned rb[2] = {__float_as_uint(b[t * 8 + g]),
                    __float_as_uint(b[(t + 4) * 8 + g])};
  float r[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1],
                c[(g + 8) * 8 + 2 * t], c[(g + 8) * 8 + 2 * t + 1]};
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3])
      : "r"(ra[0]), "r"(ra[1]), "r"(ra[2]), "r"(ra[3]), "r"(rb[0]),
        "r"(rb[1]));
  d[g * 8 + 2 * t] = r[0];
  d[g * 8 + 2 * t + 1] = r[1];
  d[(g + 8) * 8 + 2 * t] = r[2];
  d[(g + 8) * 8 + 2 * t + 1] = r[3];
}
"""


def mma_inputs(torch, fu, n, seed):
    """(A (n, 16, 8), B (n, 8, 8), C (n, 16, 8)) f32 of n MMAs, A and B
    tf32: a third of one scale, a third with exponents spread over 2^+-20
    (A, B) and 2^+-30 (C), a third whose C nearly cancels the product."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(n, 16, 8, generator=gen)
    b = torch.randn(n, 8, 8, generator=gen)
    c = torch.randn(n, 16, 8, generator=gen)
    w = n // 3

    def spread(shape, e):
        return torch.pow(2.0, torch.randint(-e, e, shape,
                                            generator=gen).float())
    a[w:2 * w] *= spread((w, 16, 8), 20)
    b[w:2 * w] *= spread((w, 8, 8), 20)
    c[w:2 * w] *= spread((w, 16, 8), 30)
    a, b = fu._tf32(a), fu._tf32(b)
    c[2 * w:] = -(a[2 * w:].double() @ b[2 * w:].double()).float() * (
        1 + 1e-3 * torch.randn(n - 2 * w, 16, 8, generator=gen))
    return a, b, c


def mma_model(torch, mt, cs, fu, dev, out, fixture):
    """The card's tf32 MMA against fused_unit._mma_step, bit for bit."""
    kern = mt.rtc.CudaModule(MMA_SOURCE).get_kernel(
        "mma_tf32", "const float *A, const float *B, const float *C, "
        "float *D, int n")
    n = 6000
    a, b, c = mma_inputs(torch, fu, n, 11)
    d = torch.empty((n, 16, 8), device=dev)
    kern.launch([a.to(dev), b.to(dev), c.to(dev), d, n], mt.gpu(0),
                ((n * 32 + 255) // 256,), (256,))
    torch.cuda.synchronize()
    d = d.cpu()
    equal = [bool(torch.equal(fu._mma_step(c[i], a[i], b[i]), d[i]))
             for i in range(n)]
    w = n // 3
    row = {"mmas": n, "equal_share": sum(equal) / n,
           "equal_share_by_inputs": [sum(equal[i * w:(i + 1) * w]) / w
                                     for i in range(3)]}
    out.append(row)
    cs.log("  %d MMAs (m16n8k8 tf32): the model's bits equal the card's in "
           "%.6f (one scale %.6f, spread exponents %.6f, cancelling %.6f)"
           % (n, row["equal_share"], *row["equal_share_by_inputs"]))
    if fixture:
        import numpy as np
        pick = [i * w + j for i in range(3) for j in range(16)]
        np.savez_compressed(fixture, a=a[pick].numpy(), b=b[pick].numpy(),
                            c=c[pick].numpy(), d=d[pick].numpy())
        cs.log("  wrote %d of them to %s" % (len(pick), fixture))


def emulation_gap(torch, cs, fu, dev, out):
    """The f32 kernels against their CPU emulations, bit by bit."""
    g = torch.Generator().manual_seed(3)

    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g) * scale

    def cu(a):
        if isinstance(a, tuple):
            return tuple(cu(t) for t in a)
        return a.to(dev) if isinstance(a, torch.Tensor) else a

    def gap(name, case, got, emu, plain):
        for exact, e in zip((False, True), emu):
            one(name + (" exact" if exact else ""), case, got, e, plain)

    def one(name, case, got, emu, plain):
        got, emu, plain = got.cpu().float(), emu.float(), plain.float()
        ulp = (got.view(torch.int32).long()
               - emu.view(torch.int32).long()).abs()
        scale = float(emu.abs().max())
        row = {"kernel": name, "case": case,
               "equal_share": float((got == emu).float().mean()),
               "max_ulp": int(ulp.max()),
               "median_ulp": float(ulp.float().median()),
               "rel_vs_emulation": float((got - emu).abs().max()) / scale,
               "rel_vs_plain": float((got - plain).abs().max())
               / float(plain.abs().max())}
        out.append(row)
        cs.log("  %-12s %-20s equal %.4f  ulps max %d median %.1f  rel %.2e "
               "(plain %.2e)" % (name, case, row["equal_share"],
                                 row["max_ulp"], row["median_ulp"],
                                 row["rel_vs_emulation"],
                                 row["rel_vs_plain"]))

    for n, h, w, ci, co in [(2, 13, 11, 36, 100), (1, 14, 14, 256, 256),
                            (2, 28, 28, 64, 64)]:
        case = "%dx%dx%d %d->%d" % (n, h, w, ci, co)
        rows = n * h * w
        x, wt = r(rows, ci), r(co, 3, 3, ci, scale=(9 * ci) ** -0.5)
        sc, sh = r(ci).abs() + 0.5, r(ci) * 0.3
        a3 = (x, wt, sc, sh, n, h, w)
        gap("K3 y", case, fu.c3_fwd2d(*cu(a3))[0],
            [fu.c3_fwd2d_tf32x3(*a3, exact=e)[0] for e in (False, True)],
            fu.c3_fwd2d_plain(*a3)[0])
        fin = (r(co).abs() + 0.5, r(co) * 0.1, r(co) * 0.1)
        a7 = (r(n, h, w, co), r(n, h, w, co), fin, x.reshape(n, h, w, ci),
              wt, sc, sh, r(ci).abs() + 0.5, r(ci) * 0.3)
        k, p = fu.c3_bwd4d(*cu(a7)), fu.c3_bwd4d_plain(*a7)
        e = [fu.c3_bwd4d_tf32x3(*a7, exact=x) for x in (False, True)]
        gap("K7 dP", case, k[0], [v[0] for v in e], p[0])
        gap("K7 dW", case, k[1], [v[1] for v in e], p[1])
        w1 = r(co, 1, 1, ci, scale=ci ** -0.5)
        a1 = (x, w1, sc, sh)
        gap("K1 y", case, fu.mm_fwd(*cu(a1))[0],
            [fu.mm_fwd_tf32x3(*a1, exact=e)[0] for e in (False, True)],
            fu.mm_fwd_plain(*a1)[0])
        a2 = a1 + (r(rows, co),)
        gap("K2 y", case, fu.mm_skip_fwd(*cu(a2)),
            [fu.mm_skip_fwd_tf32x3(*a2, exact=e) for e in (False, True)],
            fu.mm_skip_fwd_plain(*a2))
        a4 = (x.reshape(n, h, w, ci), wt, sc, sh)
        gap("K4 y", case, fu.c3_fwd4d(*cu(a4))[0],
            [fu.c3_fwd4d_tf32x3(*a4, exact=e)[0] for e in (False, True)],
            fu.c3_fwd4d_plain(*a4)[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write every measurement to this file")
    ap.add_argument("--fixture", metavar="PATH",
                    help="write 48 of the card's tf32 MMAs (inputs and "
                    "results) to this .npz")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_mma_probe: no CUDA card is visible")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import fused_unit as fu
    from mxnet_tpu_torch.ops import nn
    card = cs.card_line()
    cs.log(card)
    dev = torch.device("cuda", 0)
    split, skips, phases, halo, fwd, model, gaps = [], [], [], [], [], [], []
    cs.log("[1] kernels of each K1-K8 launch (torch.profiler); what K2's "
           "residual costs")
    kernel_split(torch, cs, fu, nn, dev, split)
    skip_cost(torch, cs, fu, dev, skips)
    lib = build_probe()
    cs.log("[2] phases of the tile loop (instrumented copy of fu_mma.cuh)")
    phase_profile(torch, cs, lib, dev, phases)
    cs.log("[3] K6 (gathered) beside K7 (halo) at the stage shapes, batch "
           "%d (instrumented copies of fu_mma.cuh and fu_halo.cuh)"
           % cs.TRAIN_BATCH)
    halo_profile(torch, cs, lib, dev, halo)
    cs.log("[3b] K3 (gathered) beside K4 (halo), forward with statistics, "
           "at the stage shapes, batch %d" % cs.BATCH)
    fwd_profile(torch, cs, lib, dev, fwd)
    cs.log("[4] the tensor core's tf32 MMA against its CPU model, and "
           "float32 kernels against their CPU emulations")
    import mxnet_tpu_torch as mt
    mma_model(torch, mt, cs, fu, dev, model, opts.fixture)
    emulation_gap(torch, cs, fu, dev, gaps)
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)),
                    exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump({"card": card, "kernels": split, "k2_residual": skips,
                       "phases": phases, "halo": halo, "forward": fwd,
                       "mma_model": model, "emulation": gaps}, f, indent=1)
    cs.log(card)


if __name__ == "__main__":
    main()
