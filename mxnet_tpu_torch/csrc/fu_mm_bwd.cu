// K5 of the fused bottleneck unit: the backward of a 1x1 convolution whose
// input passes through the consumer's BatchNorm+ReLU prologue, in one call:
// optional finalize of the cotangent (the next BatchNorm's deferred
// backward), dgrad, wgrad from the recomputed activation, ReLU mask and the
// two BatchNorm reductions.  Replaces the TPU kernel
// mxnet_tpu/ops/fused_unit.py _k_matmul_bwd (pallas_call in _mm_bwd,
// "fu_mm_bwd").  On the tensor cores (bf16 MMA, f32 through 3xTF32):
//   dgrad  dP (R, Ci) = mask(g_fin (R, Co) @ w (Co, Ci)), g K-major with
//          the finalize staged in, the OHWI weight read in place (MN-major),
//          BatchNorm sums of the f32 dP per row tile;
//   wgrad  dW (Co, Ci) = g_fin^T @ act(x), both operands MN-major with
//          K = R summed in `wsplits` chunks, added in chunk order.
// Tiles, split K, bound and determinism: see fu_mma.cuh.
#include "fu_mma.cuh"

template <typename T, int GX>
static int run(const fmma::Gemm& dgrad, const fmma::Gemm& wgrad, int dbm,
               int dbn, int wbm, int wbn, float* db, float* dg,
               cudaStream_t st) {
  using namespace fmma;
  int err = gemm<T, K_MAJOR, GX, MN_MAJOR, X_RAW, EPI_DP>(dgrad, dbm, dbn,
                                                          st);
  if (err != cudaSuccess) return err;
  err = col_sums(dgrad, dbm, db, dg, st);
  if (err != cudaSuccess) return err;
  return gemm<T, MN_MAJOR, GX, MN_MAJOR, X_PROLOGUE, EPI_F32>(wgrad, wbm,
                                                              wbn, st);
}

// g (R, Co); yraw (R, Co) and c1/u0/u1 (Co,) f32 when deferred; x (R, Ci);
// w (Co, Ci); sc/sh/xs/xh (Ci,) f32.  Writes dp (R, Ci), db/dg (Ci,) f32 and
// dw (Co, Ci) f32.  Scratch: part (2, ceil(R / dbm), Ci) f32; dws
// (dsplits, R, Ci) f32 when dsplits > 1; wpart (wsplits, Co, Ci) f32 when
// wsplits > 1.  The dgrad runs on (dbm, dbn) tiles with Co summed in
// `dsplits` chunks of `dchunk`, the wgrad on (wbm, wbn) tiles with R summed
// in `wsplits` chunks of `wchunk` (ops/_cuda.py mma_plan, mma_wgrad_plan).
extern "C" int fu_mm_bwd(const void* g, const void* yraw, const void* c1,
                         const void* u0, const void* u1, const void* x,
                         const void* w, const void* sc, const void* sh,
                         const void* xs, const void* xh, void* dp, void* part,
                         void* db, void* dg, void* dw, void* wpart, void* dws,
                         int R, int Ci, int Co, int bf16, int deferred,
                         int dbm, int dbn, int dsplits, int dchunk, int wbm,
                         int wbn, int wsplits, int wchunk, void* stream) {
  const float* v0 = static_cast<const float*>(c1);
  const float* v1 = static_cast<const float*>(u0);
  const float* v2 = static_cast<const float*>(u1);
  const fmma::Operand gop = {g, yraw, v0, v1, v2, Co};
  fmma::Gemm d = {};
  d.a = gop;
  d.b = {w, nullptr, nullptr, nullptr, nullptr, Ci};
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
  wg.a = gop;
  wg.b = {x, nullptr, d.sc, d.sh, nullptr, Ci};
  wg.out = dw;
  wg.ws = static_cast<float*>(wpart);
  wg.M = Co;
  wg.N = Ci;
  wg.K = R;
  wg.chunk = wchunk;
  wg.splits = wsplits;
  float* fdb = static_cast<float*>(db);
  float* fdg = static_cast<float*>(dg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return deferred
               ? run<__nv_bfloat16, fmma::X_FINALIZE>(d, wg, dbm, dbn, wbm,
                                                      wbn, fdb, fdg, st)
               : run<__nv_bfloat16, fmma::X_RAW>(d, wg, dbm, dbn, wbm, wbn,
                                                 fdb, fdg, st);
  return deferred ? run<float, fmma::X_FINALIZE>(d, wg, dbm, dbn, wbm, wbn,
                                                 fdb, fdg, st)
                  : run<float, fmma::X_RAW>(d, wg, dbm, dbn, wbm, wbn, fdb,
                                            fdg, st);
}
