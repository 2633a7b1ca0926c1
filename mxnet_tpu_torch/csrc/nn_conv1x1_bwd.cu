// K8: the backward of a channels-last stride-1 1x1 convolution, dx = dy @ w
// (rounded to the data type) and dw = dy^T x (f32), in one call.  Replaces
// the TPU kernel mxnet_tpu/ops/nn.py _fused1x1_bwd_pallas.  These are K5's
// two products without the finalize, the prologue, the mask or the sums,
// on the same tensor-core loop (bf16 MMA, f32 through 3xTF32):
//   dgrad  dx (R, Ci) = T(dy (R, Co) @ w (Co, Ci)), dy K-major, the weight
//          read in place (MN-major), no statistics;
//   wgrad  dW (Co, Ci) = dy^T @ x, both operands MN-major, with K = R
//          summed in `wsplits` chunks, added in chunk order.
// Tiles, split K, bound and determinism: see fu_mma.cuh.
#include "fu_mma.cuh"

template <typename T>
static int run(const fmma::Gemm& dgrad, const fmma::Gemm& wgrad, int dbm,
               int dbn, int wbm, int wbn, cudaStream_t st) {
  using namespace fmma;
  const int err = gemm<T, K_MAJOR, X_RAW, MN_MAJOR, X_RAW, EPI_Y>(
      dgrad, dbm, dbn, st);
  if (err != cudaSuccess) return err;
  return gemm<T, MN_MAJOR, X_RAW, MN_MAJOR, X_RAW, EPI_F32>(wgrad, wbm, wbn,
                                                            st);
}

// x (R, Ci), dy (R, Co), w (Co, Ci).  Writes dx (R, Ci) and dw (Co, Ci)
// f32.  Scratch: dws (dsplits, R, Ci) f32 when dsplits > 1; wpart
// (wsplits, Co, Ci) f32 when wsplits > 1.  The dgrad runs on (dbm, dbn)
// tiles with Co summed in `dsplits` chunks of `dchunk`, the wgrad on (wbm,
// wbn) tiles with R summed in `wsplits` chunks of `wchunk` (ops/_cuda.py
// mma_plan, mma_wgrad_plan).
extern "C" int nn_conv1x1_bwd(const void* x, const void* dy, const void* w,
                              void* dx, void* dw, void* wpart, void* dws,
                              int R, int Ci, int Co, int bf16, int dbm,
                              int dbn, int dsplits, int dchunk, int wbm,
                              int wbn, int wsplits, int wchunk,
                              void* stream) {
  fmma::Gemm d = {};
  d.a = {dy, nullptr, nullptr, nullptr, nullptr, Co};
  d.b = {w, nullptr, nullptr, nullptr, nullptr, Ci};
  d.out = dx;
  d.ws = static_cast<float*>(dws);
  d.M = R;
  d.N = Ci;
  d.K = Co;
  d.chunk = dchunk;
  d.splits = dsplits;
  fmma::Gemm wg = {};
  wg.a = {dy, nullptr, nullptr, nullptr, nullptr, Co};
  wg.b = {x, nullptr, nullptr, nullptr, nullptr, Ci};
  wg.out = dw;
  wg.ws = static_cast<float*>(wpart);
  wg.M = Co;
  wg.N = Ci;
  wg.K = R;
  wg.chunk = wchunk;
  wg.splits = wsplits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16>(d, wg, dbm, dbn, wbm, wbn, st);
  return run<float>(d, wg, dbm, dbn, wbm, wbn, st);
}
