#!/usr/bin/env python3
"""Where the time of the tensor-core tile loop of K1, K5, K6 and K8 goes,
on one card.

    python3 chip_mma_probe.py [--json PATH]

1. The kernels each launch of K1 (``fused_unit.mm_fwd``, with statistics,
   at ResNet-50's four stage shapes at batch 8), K5 (``mm_bwd``, final
   and deferred, at batch 32), K6 (``c3_bwd2d``, at batch 32) and K8
   (``nn.conv1x1_bwd``, at its three sites at batch 32) runs, with their
   device time from torch.profiler: the GEMMs, the split epilogue or
   reduction, the statistics' column sums.
2. A phase profile of the loop itself: ``csrc/fu_mma.cuh`` copied into
   ``build/probe/`` with ``clock64`` and ``%globaltimer`` reads added
   around its phases (waiting for a tile's copies, the in-place transform,
   the barrier, the fragment loads and MMAs), built by ``nvcc`` and run on
   K1-shaped products with the operand raw and through the BN+ReLU
   prologue: cycles per k tile in each phase, the blocks an SM held at
   once, and the SM clock.  The instrumented copy only measures; the port
   never loads it.

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
  }''',
     '''            mma_bf16(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
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

ENTRY = r'''
#include "fu_mma_probe.cuh"
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
'''


def kernel_split(torch, cs, fu, nn, dev, out):
    """Device time of every kernel a K1, K5, K6 or K8 launch runs."""
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


def phase_profile(torch, cs, dev, out):
    """The instrumented loop on K1-shaped products."""
    from mxnet_tpu_torch import cuda_build
    from mxnet_tpu_torch.ops import _cuda
    src = open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                            "fu_mma.cuh")).read()
    for old, new in PROBES:
        if src.count(old) != 1:
            raise SystemExit("chip_mma_probe: fu_mma.cuh no longer has the "
                             "text the probe instruments: %r" % old[:60])
        src = src.replace(old, new)
    bdir = os.path.join(ROOT, "build", "probe")
    os.makedirs(bdir, exist_ok=True)
    with open(os.path.join(bdir, "fu_mma_probe.cuh"), "w") as f:
        f.write(src)
    with open(os.path.join(bdir, "probe.cu"), "w") as f:
        f.write(ENTRY)
    lib_path = os.path.join(bdir, "libprobe.so")
    build = subprocess.run([cuda_build._nvcc()] + cuda_build.FLAGS
                           + ["-o", lib_path, os.path.join(bdir, "probe.cu")],
                           capture_output=True, text=True)
    if build.returncode:
        raise SystemExit("chip_mma_probe: nvcc failed:\n" + build.stdout
                         + build.stderr)
    fn = ctypes.CDLL(lib_path).probe_k1
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
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

                def call():
                    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError("probe launch failed: %d" % rc)
                call()
                ms = cs.time_ms(torch, call)
                args[6] = rec.data_ptr()
                call()
                torch.cuda.synchronize()
                q = rec.view(blocks, 8, 9).cpu()
                tiles = float(q[:, :, 4].double().mean())
                phases = [float(q[:, :, u].double().mean()) / tiles
                          for u in range(4)]
                w0 = q[:, 0, :]
                per_sm = collections.defaultdict(list)
                for row in w0.tolist():
                    per_sm[row[5]].append((row[6], row[7]))
                most = 0
                for spans in per_sm.values():
                    live = 0
                    for _, d in sorted([(a, 1) for a, _ in spans]
                                       + [(b, -1) for _, b in spans]):
                        live += d
                        most = max(most, live)
                ns = (w0[:, 7] - w0[:, 6]).double()
                ghz = float((w0[:, 8].double() / ns).mean())
                row = {"dtype": dname, "rows": r, "k": k, "n": n,
                       "plan": [bm, bn, splits, chunk], "blocks": blocks,
                       "operand": "raw" if raw else "prologue", "ms": ms,
                       "tiles_per_block": tiles,
                       "cycles_per_tile": dict(zip(
                           ("wait", "transform", "barrier", "multiply"),
                           phases)),
                       "block_loop_us": float(ns.mean()) / 1e3,
                       "most_blocks_on_an_sm": most, "sm_ghz": ghz}
                out.append(row)
                cs.log("  %-8s %6d x %4d -> %3d %-8s plan %s, %d blocks: "
                       "%.4f ms; per k tile: wait %.0f, transform %.0f, "
                       "barrier %.0f, multiply %.0f cycles; block loop "
                       "%.2f us; %d blocks on an SM at once; SM %.3f GHz" % (
                           dname, r, k, n, row["operand"], tuple(row["plan"]),
                           blocks, ms, *phases, row["block_loop_us"], most,
                           ghz))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write every measurement to this file")
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
    split, phases = [], []
    cs.log("[1] kernels of each K1 / K5 / K6 / K8 launch (torch.profiler)")
    kernel_split(torch, cs, fu, nn, dev, split)
    cs.log("[2] phases of the tile loop (instrumented copy of fu_mma.cuh)")
    phase_profile(torch, cs, dev, phases)
    if opts.json:
        os.makedirs(os.path.dirname(os.path.abspath(opts.json)),
                    exist_ok=True)
        with open(opts.json, "w") as f:
            json.dump({"card": card, "kernels": split, "phases": phases}, f,
                      indent=1)
    cs.log(card)


if __name__ == "__main__":
    main()
