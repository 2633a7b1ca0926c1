// K7 of the fused bottleneck unit: the backward of the 3x3 / stride 1 /
// pad 1 convolution over NHWC images in one call: finalize of the
// cotangent (bn3's deferred backward, zero outside the image), dgrad by
// the 180-degree-rotated tap sum, ReLU mask and the two BatchNorm
// reductions, then the per-tap wgrad from the recomputed activation.
// Replaces the TPU kernel mxnet_tpu/ops/fused_unit.py _k_conv3_bwd
// (pallas_call in _c3_bwd, "fu_c3_bwd"), the MXNET_FUSED_UNIT_C3=4d path;
// it runs at every width (the TPU's scoped-VMEM gates sent stages 1, 2 and
// 4 to XLA).  The reference returns dW as (3, 3, Ci, Co); this one writes
// it as (Co, 3, 3, Ci), the OHWI layout of the weight it is the gradient
// of.  On the tensor cores (bf16 MMA, f32 through 3xTF32), each product's
// shared operand staged once per band of pixels into a halo in shared
// memory that the nine taps read at shifted rows:
//   dgrad  dP (R, Ci) = mask(sum_t shift_t(fin(g)) @ w_t), BM x BN tiles,
//          k = (Co chunk, tap), Co split in `dsplits` chunks of `dchunk`
//          (ops/_cuda.py halo_dgrad_plan), BatchNorm sums of the f32 dP
//          per row tile added by col_sums;
//   wgrad  dW (Co, 9, Ci), 32 o x 32 i x 9 taps a block, the pixels split
//          in `wsplits` chunks of `wchunk` (halo_wgrad_plan), added in
//          chunk order.
// Halo, tiles, bound and determinism: see fu_halo.cuh and fu_mma.cuh.
#include "fu_halo.cuh"

template <typename T>
static int run(const fmma::Gemm& dgrad, const fmma::Gemm& wgrad, int dbm,
               int dbn, float* db, float* dg, cudaStream_t st) {
  int err = fhalo::conv<T, fhalo::DGRAD>(dgrad, dbm, dbn, st);
  if (err != cudaSuccess) return err;
  err = fmma::col_sums(dgrad, dbm, db, dg, st);
  if (err != cudaSuccess) return err;
  return fhalo::wgrad<T>(wgrad, st);
}

// g and yraw (N, H, W, Co), c1/u0/u1 (Co,) f32; x (N, H, W, Ci); w (Co, 3,
// 3, Ci) OHWI; sc/sh/xs/xh (Ci,) f32.  Writes dp (N, H, W, Ci), db/dg
// (Ci,) f32 and dw (Co, 3, 3, Ci) f32.  Scratch: part (2, ceil(R / dbm),
// Ci) f32; dws (dsplits, R, Ci) f32 when dsplits > 1; wpart (wsplits, Co,
// 9 * Ci) f32 when wsplits > 1; R = N * H * W.
extern "C" int fu_c3_bwd4d(const void* g, const void* yraw, const void* c1,
                           const void* u0, const void* u1, const void* x,
                           const void* w, const void* sc, const void* sh,
                           const void* xs, const void* xh, void* dp,
                           void* part, void* db, void* dg, void* dw,
                           void* wpart, void* dws, int N, int H, int W,
                           int Ci, int Co, int bf16, int dbm, int dbn,
                           int dsplits, int dchunk, int wsplits, int wchunk,
                           void* stream) {
  const float* v0 = static_cast<const float*>(c1);
  const float* v1 = static_cast<const float*>(u0);
  const float* v2 = static_cast<const float*>(u1);
  const int R = N * H * W;
  fmma::Gemm d = {};
  d.a = {g, yraw, v0, v1, v2, Co, Co, H, W};
  d.b = {w, nullptr, nullptr, nullptr, nullptr, Ci, Co, H, W};
  d.out = dp;
  d.ws = static_cast<float*>(dws);
  d.spart = static_cast<float*>(part);
  d.x = x;
  d.sc = static_cast<const float*>(sc);
  d.sh = static_cast<const float*>(sh);
  d.xs = static_cast<const float*>(xs);
  d.xh = static_cast<const float*>(xh);
  d.M = R;
  d.N = Ci;
  d.K = Co;
  d.chunk = dchunk;
  d.splits = dsplits;
  d.stats = 1;
  fmma::Gemm wg = {};
  wg.a = {x, nullptr, d.sc, d.sh, nullptr, Ci, Ci, H, W};
  wg.b = {g, yraw, v0, v1, v2, Co, Co, H, W};
  wg.out = dw;
  wg.ws = static_cast<float*>(wpart);
  wg.M = Ci;
  wg.N = Co;
  wg.K = R;
  wg.chunk = wchunk;
  wg.splits = wsplits;
  float* fdb = static_cast<float*>(db);
  float* fdg = static_cast<float*>(dg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16>(d, wg, dbm, dbn, fdb, fdg, st);
  return run<float>(d, wg, dbm, dbn, fdb, fdg, st);
}
