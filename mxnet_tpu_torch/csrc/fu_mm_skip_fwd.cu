// K2 of the fused bottleneck unit: y = T(relu(x * sc + sh)) @ w^T + skip,
// the unit-closing 1x1 convolution and the residual add in one pass.
// Replaces the TPU kernel mxnet_tpu/ops/fused_unit.py _k_matmul_skip_fwd
// (pallas_call in _mm_skip_fwd, "fu_mm_skip_fwd").  Tiling and bound: see
// fu_gemm.cuh.
#include "fu_gemm.cuh"

// x (R, K), w (N, K), sc/sh (K,) f32, skip and y (R, N).  bf16 selects
// bfloat16 x/w/skip/y, else float32.
extern "C" int fu_mm_skip_fwd(const void* x, const void* w, const void* sc,
                              const void* sh, const void* skip, void* y,
                              int R, int K, int N, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fu::launch<__nv_bfloat16>(x, w, sc, sh, skip, y, R, K, N, st);
  return fu::launch<float>(x, w, sc, sh, skip, y, R, K, N, st);
}
