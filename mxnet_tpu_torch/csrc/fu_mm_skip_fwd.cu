// K2 of the fused bottleneck unit: y = T(relu(x * sc + sh) @ w^T + skip),
// the unit-closing 1x1 convolution and the residual add in one pass: the
// residual is added to the complete f32 sum and the result rounded once.
// Replaces the TPU kernel mxnet_tpu/ops/fused_unit.py _k_matmul_skip_fwd
// (pallas_call in _mm_skip_fwd, "fu_mm_skip_fwd").  On the tensor cores
// (bf16 MMA, f32 through 3xTF32) as K1 (fu_mm_fwd.cu), with the residual
// read in the epilogue (EPI_SKIP), or in the split epilogue when K is
// split.  Its K is short (C/4: one to sixteen 128-byte k tiles) and its
// output 4x its input, so the skip reads and y stores are most of its
// bytes.  Tiles, split K, bound and determinism: see fu_mma.cuh.
#include "fu_mma.cuh"

template <typename T>
static int run(const fmma::Gemm& p, int bm, int bn, cudaStream_t st) {
  using namespace fmma;
  return gemm<T, K_MAJOR, X_PROLOGUE, K_MAJOR, X_RAW, EPI_SKIP>(p, bm, bn,
                                                                st);
}

// x (R, K), w (N, K), sc/sh (K,) f32, skip and y (R, N).  ws (splits, R,
// N) f32 scratch when splits > 1.  (bm, bn) is the output tile and K is
// summed in `splits` chunks of `chunk` (ops/_cuda.py mma_plan).  bf16
// selects bfloat16 x/w/skip/y, else float32.
extern "C" int fu_mm_skip_fwd(const void* x, const void* w, const void* sc,
                              const void* sh, const void* skip, void* y,
                              void* ws, int R, int K, int N, int bf16,
                              int bm, int bn, int splits, int chunk,
                              void* stream) {
  fmma::Gemm p = {};
  p.a = {x, nullptr, static_cast<const float*>(sc),
         static_cast<const float*>(sh), nullptr, K};
  p.b = {w, nullptr, nullptr, nullptr, nullptr, K};
  p.out = y;
  p.skip = skip;
  p.ws = static_cast<float*>(ws);
  p.M = R;
  p.N = N;
  p.K = K;
  p.chunk = chunk;
  p.splits = splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16>(p, bm, bn, st);
  return run<float>(p, bm, bn, st);
}
