// The FFMA tile loop of K2 (fu_mm_skip_fwd.cu), the fused bottleneck
// unit's closing 1x1 convolution and residual add; K1, K3, K5, K6 and K8 run
// on the tensor-core loop of fu_mma.cuh, K7 on fu_halo.cuh.  Its namespace
// also holds what every kernel shares: the T <-> f32 conversions and the
// ordered reductions of per-block partials (statistics, split-K weight
// gradients).
//
// It computes  y[r, n] = sum_k act(x)[r, k] * w[n, k] + skip[r, n]
// where act(x) = T(relu(x * sc + sh)) is the BatchNorm+ReLU prologue of the
// consumer, evaluated in f32 and rounded to the data type T before the
// product, exactly as the reference kernel does (mxnet_tpu/ops/
// fused_unit.py _k_matmul_skip_fwd).  The weight is read in the
// convolution's native OHWI layout, which is (N, K) row-major for a 1x1, so
// no transposed copy is made.  Rows past R, channels past N and k past K
// stage zeros, so any R and any K, N that are multiples of 4 work.
//
// Design (what bounds it, and what the tiling does about it): at ResNet-50
// widths every call is well above the H100's FP32 ridge point (~20 FLOP per
// byte), so the kernel is bound by arithmetic.  This first version uses
// plain FFMA on CUDA cores (no tensor cores, so float32 stays exact float32):
// a block owns a 64 x 64 output tile, 256 threads each hold a 4 x 4
// accumulator in registers, and 16-deep K tiles are double-buffered in
// shared memory with the next tile's global loads in flight while the
// current one is multiplied.  The prologue is applied once per element as the
// tile is staged, never in the inner loop, and the residual add rides the
// epilogue.  bf16 is staged as f32 and runs at the same FFMA rate: the
// tensor-core loop is the next step (PERF.md, the redesign order).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fu {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 16;       // K depth per shared-memory tile
constexpr int THREADS = 256;
constexpr int PAD = 4;       // shared-memory row padding (floats)

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

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// x: (R, K), w: (N, K) row-major, K and N % 4 == 0;  sc, sh: (K,) f32;
// skip, y: (R, N)
template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ sc, const float* __restrict__ sh,
            const T* __restrict__ skip, T* __restrict__ y, int R, int K,
            int N) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // staging coordinates: one row of the A tile and one row of w (= one
  // output channel), four consecutive k each
  const int lr = tid >> 2;
  const int lk = (tid & 3) * 4;
  const int arow = row0 + lr;
  const bool arow_ok = arow < R;
  const bool wrow_ok = col0 + lr < N;
  const T* wrow = w + (size_t)(col0 + lr) * K;

  float areg[4], breg[4];
  auto load_tile = [&](int k0) {
    const int kk = k0 + lk;
    const bool k_ok = kk < K;
    if (arow_ok && k_ok) {
      float v[4];
      load4(x + (size_t)arow * K + kk, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // separate roundings for the product and the sum, as the plain
        // version computes them
        const float z = __fadd_rn(__fmul_rn(v[j], sc[kk + j]), sh[kk + j]);
        areg[j] = to_f(from_f<T>(fmaxf(z, 0.f)));
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) areg[j] = 0.f;
    }
    if (wrow_ok && k_ok) {
      load4(wrow + kk, breg);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) breg[j] = 0.f;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[buf][lk + j][lr] = areg[j];
      Bs[buf][lk + j][lr] = breg[j];
    }
  };

  // compute coordinates: rows ty*4 .. +4, channels tx*4 .. +4
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int ntiles = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) load_tile((t + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (t + 1 < ntiles) store_tile(buf ^ 1);
    __syncthreads();
  }

  const int c = col0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < R && c < N) {
      float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      float s4[4];
      load4(skip + (size_t)r * N + c, s4);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], s4[j]);
      store4(y + (size_t)r * N + c, v);
    }
  }
}

// s[c] = sum_b part[0][b][c], ss[c] = sum_b part[1][b][c], in b order
// (K4's statistics)
static __global__ void stats_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ s,
                                           float* __restrict__ ss, int nrb,
                                           int N) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < nrb; ++i) {
    a += part[(size_t)i * N + c];
    b += part[(size_t)(nrb + i) * N + c];
  }
  s[c] = a;
  ss[c] = b;
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

// Launch K2's forward; returns cudaGetLastError() so the caller sees a
// refused launch.
template <typename T>
int launch(const void* x, const void* w, const void* sc, const void* sh,
           const void* skip, void* y, int R, int K, int N,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(sc), static_cast<const float*>(sh),
      static_cast<const T*>(skip), static_cast<T*>(y), R, K, N);
  return (int)cudaGetLastError();
}

}  // namespace fu
