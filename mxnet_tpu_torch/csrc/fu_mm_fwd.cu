// K1 of the fused bottleneck unit: y = T(relu(x * sc + sh)) @ w^T, with the
// optional per-channel sum / sum-of-squares epilogue.  Replaces the TPU
// kernel mxnet_tpu/ops/fused_unit.py _k_matmul_fwd (pallas_call in _mm_fwd,
// "fu_mm_fwd").  On the tensor cores (bf16 MMA, f32 through 3xTF32); tiles,
// split K, bound and determinism: see fu_mma.cuh.
#include "fu_mma.cuh"

// x (R, K), w (N, K), sc/sh (K,) f32, y (R, N).  with_stats: part
// (2, ceil(R / bm), N) f32 scratch, s/ss (N,) f32.  ws (splits, R, N) f32
// scratch when splits > 1.  (bm, bn) is the output tile and K is summed in
// `splits` chunks of `chunk` (ops/_cuda.py mma_plan).  bf16 selects
// bfloat16 x/w/y, else float32.
template <typename T>
static int run(const void* x, const void* w, const void* sc, const void* sh,
               void* y, void* part, void* s, void* ss, void* ws, int R,
               int K, int N, int with_stats, int bm, int bn, int splits,
               int chunk, cudaStream_t st) {
  fmma::Gemm p = {};
  p.a = {x, nullptr, static_cast<const float*>(sc),
         static_cast<const float*>(sh), nullptr, K};
  p.b = {w, nullptr, nullptr, nullptr, nullptr, K};
  p.out = y;
  p.ws = static_cast<float*>(ws);
  p.spart = static_cast<float*>(part);
  p.M = R;
  p.N = N;
  p.K = K;
  p.chunk = chunk;
  p.splits = splits;
  p.stats = with_stats;
  int err = fmma::gemm<T, fmma::K_MAJOR, fmma::X_PROLOGUE, fmma::K_MAJOR,
                       fmma::X_RAW, fmma::EPI_Y>(p, bm, bn, st);
  if (err != cudaSuccess || !with_stats) return err;
  return fmma::col_sums(p, bm, static_cast<float*>(s),
                        static_cast<float*>(ss), st);
}

extern "C" int fu_mm_fwd(const void* x, const void* w, const void* sc,
                         const void* sh, void* y, void* part, void* s,
                         void* ss, void* ws, int R, int K, int N, int bf16,
                         int with_stats, int bm, int bn, int splits,
                         int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run<__nv_bfloat16>(x, w, sc, sh, y, part, s, ss, ws, R, K, N,
                              with_stats, bm, bn, splits, chunk, st);
  return run<float>(x, w, sc, sh, y, part, s, ss, ws, R, K, N, with_stats,
                    bm, bn, splits, chunk, st);
}
