// K6 of the fused bottleneck unit: the backward of the 3x3 / stride 1 /
// pad 1 convolution over whole NHWC images kept as (rows, C), in one call:
// finalize of the cotangent (bn3's deferred backward), dgrad over the nine
// taps read from neighbour rows with zeros outside the image, per-tap wgrad
// from the recomputed activation, ReLU mask and the two BatchNorm
// reductions.  Replaces the TPU kernel mxnet_tpu/ops/fused_unit.py
// _k_conv3_bwd_2d (pallas_call in _c3_bwd2d, "fu_c3_bwd2d"); its roll-and-
// mask tap shifts become explicit neighbour-row reads, and it runs at every
// width (the TPU's VMEM gates sent wide or large stages to XLA).  Tiling,
// bound and determinism: see fu_bwd.cuh.
#include "fu_bwd.cuh"

// g and yraw (R, Co), c1/u0/u1 (Co,) f32; x (R, Ci) with R = n * H * W;
// w (Co, 3, 3, Ci) OHWI; sc/sh/xs/xh (Ci,) f32.  Writes dp (R, Ci), db/dg
// (Ci,) f32 and dw (Co, 3, 3, Ci) f32; part (2, ceil(R/64), Ci) and wpart
// (splits, Co, 9 * Ci) f32 are scratch.
extern "C" int fu_c3_bwd2d(const void* g, const void* yraw, const void* c1,
                           const void* u0, const void* u1, const void* x,
                           const void* w, const void* sc, const void* sh,
                           const void* xs, const void* xh, void* dp,
                           void* part, void* db, void* dg, void* dw,
                           void* wpart, int R, int Ci, int Co, int H, int W,
                           int splits, int chunk, int bf16, void* stream) {
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
  p.H = H;
  p.W = W;
  p.splits = splits;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fub::launch<__nv_bfloat16, 9, fub::G_DEFERRED, true>(p, st);
  return fub::launch<float, 9, fub::G_DEFERRED, true>(p, st);
}
