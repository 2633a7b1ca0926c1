// K5 of the fused bottleneck unit: the backward of a 1x1 convolution whose
// input passes through the consumer's BatchNorm+ReLU prologue, in one call:
// optional finalize of the cotangent (the next BatchNorm's deferred
// backward), dgrad, wgrad from the recomputed activation, ReLU mask and the
// two BatchNorm reductions.  Replaces the TPU kernel
// mxnet_tpu/ops/fused_unit.py _k_matmul_bwd (pallas_call in _mm_bwd,
// "fu_mm_bwd").  Tiling, bound and determinism: see fu_bwd.cuh.
#include "fu_bwd.cuh"

// g (R, Co); yraw (R, Co) and c1/u0/u1 (Co,) f32 when deferred; x (R, Ci);
// w (Co, Ci); sc/sh/xs/xh (Ci,) f32.  Writes dp (R, Ci), db/dg (Ci,) f32 and
// dw (Co, Ci) f32; part (2, ceil(R/64), Ci) and wpart (splits, Co, Ci) f32
// are scratch.  The wgrad sums rows in `splits` chunks of `chunk` rows.
extern "C" int fu_mm_bwd(const void* g, const void* yraw, const void* c1,
                         const void* u0, const void* u1, const void* x,
                         const void* w, const void* sc, const void* sh,
                         const void* xs, const void* xh, void* dp, void* part,
                         void* db, void* dg, void* dw, void* wpart, int R,
                         int Ci, int Co, int splits, int chunk, int bf16,
                         int deferred, void* stream) {
  fub::Args p;
  p.g = g;
  p.yraw = yraw;
  p.c1 = static_cast<const float*>(c1);
  p.u0 = static_cast<const float*>(u0);
  p.u1 = static_cast<const float*>(u1);
  p.x = x;
  p.w = w;
  p.sc = static_cast<const float*>(sc);
  p.sh = static_cast<const float*>(sh);
  p.xs = static_cast<const float*>(xs);
  p.xh = static_cast<const float*>(xh);
  p.dx = dp;
  p.part = static_cast<float*>(part);
  p.db = static_cast<float*>(db);
  p.dg = static_cast<float*>(dg);
  p.dw = static_cast<float*>(dw);
  p.wpart = static_cast<float*>(wpart);
  p.R = R;
  p.Ci = Ci;
  p.Co = Co;
  p.H = 0;
  p.W = 0;
  p.splits = splits;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return deferred
               ? fub::launch<__nv_bfloat16, 1, fub::G_DEFERRED, true>(p, st)
               : fub::launch<__nv_bfloat16, 1, fub::G_RAW, true>(p, st);
  return deferred ? fub::launch<float, 1, fub::G_DEFERRED, true>(p, st)
                  : fub::launch<float, 1, fub::G_RAW, true>(p, st);
}
