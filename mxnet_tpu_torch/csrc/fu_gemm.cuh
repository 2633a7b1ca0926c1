// What every kernel of the fused bottleneck unit and the fused 1x1
// backward shares: the T <-> f32 conversions and the ordered reduction of
// split weight-gradient partials.  The products run on the tensor cores:
// K1, K2, K3, K5, K6 and K8 on fu_mma.cuh's tile loop, K4 and K7 on its
// halo-resident form, fu_halo.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fu {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// out[e] = sum_s part[s][e], in s order: the split-K weight gradients of
// fu_mma.cuh (K5, K6, K8) and fu_halo.cuh (K7)
static __global__ void split_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           int splits, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[(size_t)i * n + e];
  out[e] = s;
}

}  // namespace fu
