// K6 of the fused bottleneck unit: the backward of the 3x3 / stride 1 /
// pad 1 convolution over whole NHWC images kept as (rows, C), in one call:
// finalize of the cotangent (bn3's deferred backward), dgrad over the nine
// taps read from neighbour rows with zeros outside the image, per-tap wgrad
// from the recomputed activation, ReLU mask and the two BatchNorm
// reductions.  Replaces the TPU kernel mxnet_tpu/ops/fused_unit.py
// _k_conv3_bwd_2d (pallas_call in _c3_bwd2d, "fu_c3_bwd2d"); its roll-and-
// mask tap shifts become gathers in the staging of one operand of each
// product, and it runs at every width (the TPU's VMEM gates sent wide or
// large stages to XLA).  On the tensor cores (bf16 MMA, f32 through
// 3xTF32), with k = (tap, channel) tap-major:
//   dgrad  dP (R, Ci) = mask(g' (R, 9 Co) @ w' (9 Co, Ci)), where
//          g'[r, (t, o)] = fin(g)[r - off_t, o] (zero off the image) is
//          staged K-major through the finalize (G_SHIFT_K) and w'[(t, o),
//          i] = w[o, t, i] is the OHWI weight read in place (G_OHWI);
//          BatchNorm sums of the f32 dP per row tile;
//   wgrad  dW (Co, 9 Ci) = fin(g)^T @ a', the OHWI layout itself, where
//          a'[r, (t, i)] = act(x)[r + off_t, i] (zero off the image) is
//          staged MN-major through the prologue (G_SHIFT_N); K = R summed
//          in `wsplits` chunks, added in chunk order,
// with off_t = dh * W + dw.  Tiles, gathers, split K, bound and
// determinism: see fu_mma.cuh.
#include "fu_mma.cuh"

template <typename T>
static int run(const fmma::Gemm& dgrad, const fmma::Gemm& wgrad, int dbm,
               int dbn, int wbm, int wbn, float* db, float* dg,
               cudaStream_t st) {
  using namespace fmma;
  int err = gemm<T, K_MAJOR, X_FINALIZE, MN_MAJOR, X_RAW, EPI_DP, G_SHIFT_K,
                 G_OHWI>(dgrad, dbm, dbn, st);
  if (err != cudaSuccess) return err;
  err = col_sums(dgrad, dbm, db, dg, st);
  if (err != cudaSuccess) return err;
  return gemm<T, MN_MAJOR, X_FINALIZE, MN_MAJOR, X_PROLOGUE, EPI_F32, G_NONE,
              G_SHIFT_N>(wgrad, wbm, wbn, st);
}

// g and yraw (R, Co), c1/u0/u1 (Co,) f32; x (R, Ci) with R = n * H * W;
// w (Co, 3, 3, Ci) OHWI; sc/sh/xs/xh (Ci,) f32.  Writes dp (R, Ci), db/dg
// (Ci,) f32 and dw (Co, 3, 3, Ci) f32.  Scratch: part (2, ceil(R / dbm),
// Ci) f32; dws (dsplits, R, Ci) f32 when dsplits > 1; wpart (wsplits, Co,
// 9 * Ci) f32 when wsplits > 1.  The dgrad runs on (dbm, dbn) tiles with
// 9 * Co summed in `dsplits` chunks of `dchunk`, the wgrad on (wbm, wbn)
// tiles with R summed in `wsplits` chunks of `wchunk` (ops/_cuda.py
// mma_plan, mma_wgrad_plan).
extern "C" int fu_c3_bwd2d(const void* g, const void* yraw, const void* c1,
                           const void* u0, const void* u1, const void* x,
                           const void* w, const void* sc, const void* sh,
                           const void* xs, const void* xh, void* dp,
                           void* part, void* db, void* dg, void* dw,
                           void* wpart, void* dws, int R, int Ci, int Co,
                           int H, int W, int bf16, int dbm, int dbn,
                           int dsplits, int dchunk, int wbm, int wbn,
                           int wsplits, int wchunk, void* stream) {
  const float* v0 = static_cast<const float*>(c1);
  const float* v1 = static_cast<const float*>(u0);
  const float* v2 = static_cast<const float*>(u1);
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
  d.K = 9 * Co;
  d.chunk = dchunk;
  d.splits = dsplits;
  d.stats = 1;
  fmma::Gemm wg = {};
  wg.a = {g, yraw, v0, v1, v2, Co};
  wg.b = {x, nullptr, d.sc, d.sh, nullptr, Ci, Ci, H, W};
  wg.out = dw;
  wg.ws = static_cast<float*>(wpart);
  wg.M = Co;
  wg.N = 9 * Ci;
  wg.K = R;
  wg.chunk = wchunk;
  wg.splits = wsplits;
  float* fdb = static_cast<float*>(db);
  float* fdg = static_cast<float*>(dg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(d, wg, dbm, dbn, wbm, wbn, fdb, fdg, st);
  return run<float>(d, wg, dbm, dbn, wbm, wbn, fdb, fdg, st);
}
