// K7 of the fused bottleneck unit: the backward of the 3x3 / stride 1 /
// pad 1 convolution over NHWC images on 8 x 8 spatial tiles with their halo
// in shared memory: finalize of the cotangent (bn3's deferred backward, zero
// outside the image), dgrad by the 180-degree-rotated tap sum, ReLU mask and
// the two BatchNorm reductions in one pass, then the per-tap wgrad from the
// recomputed activation.  Replaces the TPU kernel mxnet_tpu/ops/
// fused_unit.py _k_conv3_bwd (pallas_call in _c3_bwd, "fu_c3_bwd"), the
// MXNET_FUSED_UNIT_C3=4d path; it runs at every width (the TPU's
// scoped-VMEM gates sent stages 1, 2 and 4 to XLA).  The reference returns
// dW as (3, 3, Ci, Co); this one writes it as (Co, 3, 3, Ci), the OHWI layout
// of the weight it is the gradient of.  Tiling, bound and determinism: see
// fu_conv4d.cuh.
#include "fu_conv4d.cuh"

// g and yraw (N, H, W, Co), c1/u0/u1 (Co,) f32; x (N, H, W, Ci); w (Co, 3,
// 3, Ci) OHWI; sc/sh/xs/xh (Ci,) f32.  Writes dp (N, H, W, Ci), db/dg (Ci,)
// f32 and dw (Co, 3, 3, Ci) f32; part (2, N * tiles_img, Ci) and wpart
// (splits, Co, 9 * Ci) f32 are scratch; the wgrad sums `chunk` tiles a
// split.
extern "C" int fu_c3_bwd4d(const void* g, const void* yraw, const void* c1,
                           const void* u0, const void* u1, const void* x,
                           const void* w, const void* sc, const void* sh,
                           const void* xs, const void* xh, void* dp,
                           void* part, void* db, void* dg, void* dw,
                           void* wpart, int N, int H, int W, int Ci, int Co,
                           int tiles_w, int tiles_img, int splits, int chunk,
                           int bf16, void* stream) {
  fu4::Args p = {};
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
  p.out = dp;
  p.part = static_cast<float*>(part);
  p.s = static_cast<float*>(db);
  p.ss = static_cast<float*>(dg);
  p.dw = static_cast<float*>(dw);
  p.wpart = static_cast<float*>(wpart);
  p.N = N;
  p.H = H;
  p.W = W;
  p.Ci = Ci;
  p.Co = Co;
  p.tiles_w = tiles_w;
  p.tiles_img = tiles_img;
  p.splits = splits;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return fu4::launch_bwd<__nv_bfloat16>(p, st);
  return fu4::launch_bwd<float>(p, st);
}
