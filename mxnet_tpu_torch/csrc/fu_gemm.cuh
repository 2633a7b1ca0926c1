// Shared tile loop of the fused bottleneck-unit forward kernels K2
// (fu_mm_skip_fwd.cu) and K3 (fu_c3_fwd2d.cu); K1 (fu_mm_fwd.cu) runs on
// the tensor-core loop of fu_mma.cuh.  Its namespace also holds what every
// kernel shares: the T <-> f32 conversions and the ordered reductions of
// per-block partials (statistics, split-K weight gradients).
//
// Both compute  y[r, n] = sum_k act(x)[r, k] * w[n, k]  (+ skip[r, n])
// where act(x) = T(relu(x * sc + sh)) is the BatchNorm+ReLU prologue of the
// consumer, evaluated in f32 and rounded to the data type T before the
// product, exactly as the reference kernels do (mxnet_tpu/ops/fused_unit.py
// _k_matmul_skip_fwd / _k_conv3_fwd_2d).  The weight is read
// in the convolution's native OHWI layout, which is (N, K) row-major for a
// 1x1 (K = Ci) and for a 3x3 (K = 9 * Ci, tap-major) alike, so no transposed
// copy of a weight is ever made.
//
// For the 3x3 (MODE == C3) the K axis walks the nine taps: each thread stages
// four consecutive k, which lie in one tap (Ci is a multiple of 4), and each
// output row r = (n, h, w) reads input row r + dh * W + dw, or zero where
// (h + dh, w + dw) leaves the image — the zero padding is applied after the
// prologue, as in the reference.  Rows past R, channels past N and k past K
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
// tile is staged, never in the inner loop.  bf16 is staged as f32 and runs
// at the same FFMA rate, far from its tensor-core bound (where the smaller
// calls are bound by bytes instead): mma/wgmma tiles are the next step.
//
// Batch statistics (with_stats) are the per-channel sum and sum of squares
// of the f32 accumulator (not of the stored y), as in the reference.  Each
// block reduces its 64 rows in a fixed order into a (row_blocks, N) partial
// buffer, and a second kernel sums the partials in row-block order: no float
// atomics, so the result is the same on every run.
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

enum Mode { MM = 0, MM_SKIP = 1, C3 = 2 };

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

// x: (R, XC) with XC = K (MM, MM_SKIP) or C (C3; K = 9 * C); XC, N % 4 == 0
// w: (N, K) row-major;  sc, sh: (XC,) f32;  skip, y: (R, N)
// part: (2, gridDim.y, N) f32 per-block sums when STATS
template <typename T, int MODE, bool STATS>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ sc, const float* __restrict__ sh,
            const T* __restrict__ skip, T* __restrict__ y,
            float* __restrict__ part, int R, int K, int N, int C, int H,
            int W) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int xc = (MODE == C3) ? C : K;

  // staging coordinates: one row of the A tile and one row of w (= one
  // output channel), four consecutive k each
  const int lr = tid >> 2;
  const int lk = (tid & 3) * 4;
  const int arow = row0 + lr;
  const bool arow_ok = arow < R;
  int ah = 0, aw = 0;
  if (MODE == C3) {
    aw = arow % W;
    ah = (arow / W) % H;
  }
  const bool wrow_ok = col0 + lr < N;
  const T* wrow = w + (size_t)(col0 + lr) * K;

  float areg[4], breg[4];
  auto load_tile = [&](int k0) {
    const int kk = k0 + lk;
    const bool k_ok = kk < K;
    int src = arow;
    int kc = kk;
    bool ok = arow_ok && k_ok;
    if (MODE == C3) {
      const int tap = kk / C;
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
      const int hh = ah + dh, ww = aw + dw;
      ok = ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
      src = arow + dh * W + dw;
      kc = kk - tap * C;
    }
    if (ok) {
      float v[4];
      load4(x + (size_t)src * xc + kc, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // separate roundings for the product and the sum, as the plain
        // version computes them
        const float z = __fadd_rn(__fmul_rn(v[j], sc[kc + j]), sh[kc + j]);
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
      if (MODE == MM_SKIP) {
        float s4[4];
        load4(skip + (size_t)r * N + c, s4);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(v[j], s4[j]);
      }
      store4(y + (size_t)r * N + c, v);
    }
  }

  if (STATS) {
    // rows past R staged zeros, so their accumulators add nothing
    __shared__ float red[2][THREADS / 16][BN];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s += acc[i][j];
        ss += acc[i][j] * acc[i][j];
      }
      red[0][ty][tx * 4 + j] = s;
      red[1][ty][tx * 4 + j] = ss;
    }
    __syncthreads();
    const int which = tid / BN, col = tid % BN;
    if (tid < 2 * BN && col0 + col < N) {
      float s = 0.f;
      for (int q = 0; q < THREADS / 16; ++q) s += red[which][q][col];
      part[((size_t)which * gridDim.y + blockIdx.y) * N + col0 + col] = s;
    }
  }
}

// s[c] = sum_b part[0][b][c], ss[c] = sum_b part[1][b][c], in b order
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
// fu_mma.cuh (K5, K6, K8) and fu_conv4d.cuh (K7)
static __global__ void split_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           int splits, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[(size_t)i * n + e];
  out[e] = s;
}

// Launch one forward (plus the stats reduction when with_stats); returns
// cudaGetLastError() so the caller sees a refused launch.
template <typename T, int MODE>
int launch(const void* x, const void* w, const void* sc, const void* sh,
           const void* skip, void* y, void* part, void* s, void* ss, int R,
           int K, int N, int C, int H, int W, int with_stats,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (R + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* sct = static_cast<const float*>(sc);
  const float* sht = static_cast<const float*>(sh);
  const T* skt = static_cast<const T*>(skip);
  T* yt = static_cast<T*>(y);
  if constexpr (MODE != MM_SKIP) {
    if (with_stats) {
      float* pt = static_cast<float*>(part);
      gemm_kernel<T, MODE, true><<<grid, THREADS, 0, stream>>>(
          xt, wt, sct, sht, skt, yt, pt, R, K, N, C, H, W);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      stats_reduce_kernel<<<(N + 127) / 128, 128, 0, stream>>>(
          pt, static_cast<float*>(s), static_cast<float*>(ss), grid.y, N);
      return (int)cudaGetLastError();
    }
  }
  gemm_kernel<T, MODE, false><<<grid, THREADS, 0, stream>>>(
      xt, wt, sct, sht, skt, yt, nullptr, R, K, N, C, H, W);
  return (int)cudaGetLastError();
}

}  // namespace fu
