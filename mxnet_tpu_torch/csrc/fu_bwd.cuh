// Shared tile loops of the backward kernels K6 (fu_c3_bwd2d.cu) and K8
// (nn_conv1x1_bwd.cu); K5 (fu_mm_bwd.cu) runs on the tensor-core loop of
// fu_mma.cuh, which adds its split wgrad partials with split_reduce_kernel.
//
// A convolution y = conv(act(x), w) with x (R, Ci), y (R, Co) and the weight
// in OHWI, (Co, TAPS, Ci) with TAPS = 1 (1x1) or 9 (3x3 / stride 1 / pad 1),
// has two products in its backward, both computed here from the cotangent g
// (R, Co):
//
//   dgrad  dx[r, i]      = sum_{t, o} g[r - off_t, o] * w[o, t, i]
//   wgrad  dw[o, t, i]   = sum_r      g[r, o] * act(x)[r + off_t, i]
//
// where off_t = dh * W + dw is the tap's row shift and a term counts only
// where the shifted (h, w) lies inside the image (zero padding).  For a 1x1
// there is one tap with off = 0.  The fused kernel (K6) also
//   - finalize g while staging it: g = T(c1 * g_in + u0 + u1 * y_raw) in f32,
//     rounded to the data type T before any product (the consumer
//     BatchNorm's backward, deferred into this kernel as three per-channel
//     vectors), or take g_in as it is when the cotangent is final;
//   - recompute the prologue act(x) = T(relu(x * sc + sh)) for the wgrad;
//   - mask dgrad by the recomputed ReLU, dP = dx * (relu(x * sc + sh) > 0),
//     store T(dP), and take the BatchNorm reductions sum dP and
//     sum dP * (x * xs + xh) from the f32 dP before it is rounded.
// K8 is the same two products with none of that: dx = T(dy @ w), dw = dy^T x.
// The arithmetic and the rounding points are those of the reference kernels
// (mxnet_tpu/ops/fused_unit.py _k_conv3_bwd_2d, ops/nn.py
// _fused1x1_bwd_pallas).
//
// Design.  The TPU kernels keep the whole weight and its f32 gradient
// resident in VMEM and step a sequential grid that carries the dW and BN
// sums from one row block to the next.  Blocks on the H100 run in parallel
// and carry nothing, so the two products are two grid passes with their own
// tilings, both on the forward's tile loop (fu_gemm.cuh: 64 x 64 output
// tiles, 256 threads with 4 x 4 f32 accumulators, 16-deep double-buffered k
// tiles, FFMA on CUDA cores):
//   - dgrad tiles the output (R, Ci) with K = TAPS * Co, like K3; its
//     epilogue holds the ReLU mask and writes per-row-block partial BN sums,
//     which a second kernel adds in row-block order;
//   - wgrad tiles the output (Co, TAPS * Ci), which is the OHWI weight
//     layout, with K = R.  R reaches 100352 rows (stage 1 at batch 32), so R
//     is cut into `splits` chunks chosen from the shapes alone (the wrapper
//     aims at about 256 blocks); each block writes its chunk's partial dW and
//     a last kernel adds the partials in chunk order.  With one chunk the
//     partial is dW itself.  The workspace is splits * Co * TAPS * Ci f32,
//     under 8 MB at any R (4.3 MB at ResNet-50's largest, stage-1 K6).
// No float atomics anywhere, so two launches on the same inputs give the
// same bits.  Bound: at ResNet-50 widths both passes are well above the
// FP32 ridge point, so arithmetic bounds them; bf16 is staged as f32 and
// runs at the FFMA rate, far from its tensor-core bound (mma/wgmma later).
#pragma once

#include "fu_gemm.cuh"

namespace fub {

using fu::BK;
using fu::BM;
using fu::BN;
using fu::PAD;
using fu::THREADS;
using fu::from_f;
using fu::load4;
using fu::store4;
using fu::to_f;

// How the cotangent is staged: as given, or finalized from the deferred
// BatchNorm vectors and the raw conv output.
enum GMode { G_RAW = 0, G_DEFERRED = 1 };

struct Args {
  const void* g;     // (R, Co) cotangent, T
  const void* yraw;  // (R, Co) raw conv output, T (G_DEFERRED)
  const float* c1;   // (Co,) deferred finalize vectors (G_DEFERRED)
  const float* u0;
  const float* u1;
  const void* x;     // (R, Ci) raw conv input, T
  const void* w;     // (Co, TAPS, Ci) OHWI weight, T
  const float* sc;   // (Ci,) prologue scale / shift (FUSED)
  const float* sh;
  const float* xs;   // (Ci,) xhat = x * xs + xh (FUSED)
  const float* xh;
  void* dx;          // (R, Ci) dP (FUSED) or dx, T
  float* part;       // (2, ceil(R / BM), Ci) partial BN sums (FUSED)
  float* db;         // (Ci,) sum dP (FUSED)
  float* dg;         // (Ci,) sum dP * xhat (FUSED)
  float* dw;         // (Co, TAPS * Ci) f32
  float* wpart;      // (splits, Co, TAPS * Ci) f32 when splits > 1
  int R, Ci, Co, H, W, splits, chunk;
};

// Four consecutive channels o..o+3 of cotangent row `off / Co`.
template <typename T, int GM>
__device__ __forceinline__ void load_g(const Args& p, size_t off, int o,
                                       float v[4]) {
  load4(static_cast<const T*>(p.g) + off, v);
  if (GM == G_DEFERRED) {
    float y[4];
    load4(static_cast<const T*>(p.yraw) + off, y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // ((c1 * g) + u0) + (u1 * y), each step rounded as the plain version
      // computes it
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(p.c1[o + j], v[j]),
                                          p.u0[o + j]),
                                __fmul_rn(p.u1[o + j], y[j]));
      v[j] = to_f(from_f<T>(z));
    }
  }
}

// Four consecutive channels i..i+3 of input row `off / Ci`, through the
// prologue when FUSED.
template <typename T, bool FUSED>
__device__ __forceinline__ void load_x(const Args& p, size_t off, int i,
                                       float v[4]) {
  load4(static_cast<const T*>(p.x) + off, v);
  if (FUSED) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float z = __fadd_rn(__fmul_rn(v[j], p.sc[i + j]), p.sh[i + j]);
      v[j] = to_f(from_f<T>(fmaxf(z, 0.f)));
    }
  }
}

__device__ __forceinline__ void zero4(float v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = 0.f;
}

// acc += As[buf]^T Bs[buf] for this thread's 4 x 4 outputs
__device__ __forceinline__ void mac_tile(float (*As)[BM + PAD],
                                         float (*Bs)[BN + PAD], int ty,
                                         int tx, float acc[4][4]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// dgrad: dx (R, Ci) = g' (R, TAPS * Co) @ w' (TAPS * Co, Ci), with
// g'[r, (t, o)] = g[r - off_t, o] (zero off the image) and
// w'[(t, o), i] = w[o, t, i].
template <typename T, int TAPS, int GM, bool FUSED>
__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const __grid_constant__ Args p) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int K = TAPS * p.Co;
  const T* w = static_cast<const T*>(p.w);

  // A: one cotangent row, four consecutive k (one tap: Co % 4 == 0)
  const int lr = tid >> 2;
  const int lka = (tid & 3) * 4;
  const int arow = row0 + lr;
  const bool arow_ok = arow < p.R;
  int ah = 0, aw = 0;
  if (TAPS == 9) {
    aw = arow % p.W;
    ah = (arow / p.W) % p.H;
  }
  // B: one k, four consecutive input channels
  const int lkb = tid >> 4;
  const int lnb = (tid & 15) * 4;
  const int bcol = col0 + lnb;
  const bool bcol_ok = bcol < p.Ci;

  float areg[4], breg[4];
  auto load_tile = [&](int k0) {
    int kk = k0 + lka;
    bool ok = arow_ok && kk < K;
    int src = arow, o = kk;
    if (TAPS == 9) {
      const int tap = kk / p.Co;
      const int dh = tap / 3 - 1, dw = tap % 3 - 1;
      const int hh = ah - dh, ww = aw - dw;
      ok = ok && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
      src = arow - dh * p.W - dw;
      o = kk - tap * p.Co;
    }
    if (ok)
      load_g<T, GM>(p, (size_t)src * p.Co + o, o, areg);
    else
      zero4(areg);
    kk = k0 + lkb;
    if (bcol_ok && kk < K) {
      size_t off = (size_t)kk * p.Ci + bcol;
      if (TAPS == 9) {
        const int tap = kk / p.Co;
        off = ((size_t)(kk - tap * p.Co) * 9 + tap) * p.Ci + bcol;
      }
      load4(w + off, breg);
    } else {
      zero4(breg);
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][lka + j][lr] = areg[j];
    *reinterpret_cast<float4*>(&Bs[buf][lkb][lnb]) =
        make_float4(breg[0], breg[1], breg[2], breg[3]);
  };

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) zero4(acc[i]);

  const int ntiles = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) load_tile((t + 1) * BK);
    mac_tile(As[buf], Bs[buf], ty, tx, acc);
    if (t + 1 < ntiles) store_tile(buf ^ 1);
    __syncthreads();
  }

  const int c = col0 + tx * 4;
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, css[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < p.R && c < p.Ci) {
      float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      if (FUSED) {
        float xv[4];
        load4(static_cast<const T*>(p.x) + (size_t)r * p.Ci + c, xv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a32 =
              fmaxf(__fadd_rn(__fmul_rn(xv[j], p.sc[c + j]), p.sh[c + j]),
                    0.f);
          v[j] = a32 > 0.f ? v[j] : 0.f;
          const float xhat =
              __fadd_rn(__fmul_rn(xv[j], p.xs[c + j]), p.xh[c + j]);
          cs[j] += v[j];
          css[j] += __fmul_rn(v[j], xhat);
        }
      }
      store4(static_cast<T*>(p.dx) + (size_t)r * p.Ci + c, v);
    }
  }

  if (FUSED) {
    // per-column sums over the block's 64 rows, in a fixed order
    __shared__ float red[2][THREADS / 16][BN];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = cs[j];
      red[1][ty][tx * 4 + j] = css[j];
    }
    __syncthreads();
    const int which = tid / BN, col = tid % BN;
    if (tid < 2 * BN && col0 + col < p.Ci) {
      float s = 0.f;
      for (int q = 0; q < THREADS / 16; ++q) s += red[which][q][col];
      p.part[((size_t)which * gridDim.y + blockIdx.y) * p.Ci + col0 + col] =
          s;
    }
  }
}

// wgrad over rows [z * chunk, min(R, (z + 1) * chunk)):
// dw (Co, TAPS * Ci) = g^T (Co, rows) @ x' (rows, TAPS * Ci) with
// x'[r, (t, i)] = act(x)[r + off_t, i] (zero off the image).
template <typename T, int TAPS, int GM, bool FUSED>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const __grid_constant__ Args p) {
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  const int N = TAPS * p.Ci;
  const int row0 = blockIdx.y * BM;  // output channel o
  const int col0 = blockIdx.x * BN;  // (tap, input channel)
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.R, kbeg + p.chunk);

  // both operands: one row r = k, four consecutive m or n
  const int lk = tid >> 4;
  const int lm = (tid & 15) * 4;
  const int ao = row0 + lm;
  const bool ao_ok = ao < p.Co;
  const int bn = col0 + lm;
  const bool bn_ok = bn < N;
  int bi = bn, bdh = 0, bdw = 0;
  if (TAPS == 9) {
    const int tap = bn / p.Ci;
    bi = bn - tap * p.Ci;
    bdh = tap / 3 - 1;
    bdw = tap % 3 - 1;
  }

  float areg[4], breg[4];
  auto load_tile = [&](int k0) {
    const int r = k0 + lk;
    const bool r_ok = r < kend;
    if (r_ok && ao_ok)
      load_g<T, GM>(p, (size_t)r * p.Co + ao, ao, areg);
    else
      zero4(areg);
    bool ok = r_ok && bn_ok;
    int src = r;
    if (TAPS == 9 && ok) {
      const int ww = r % p.W + bdw;
      const int hh = (r / p.W) % p.H + bdh;
      ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
      src = r + bdh * p.W + bdw;
    }
    if (ok)
      load_x<T, FUSED>(p, (size_t)src * p.Ci + bi, bi, breg);
    else
      zero4(breg);
  };
  auto store_tile = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][lk][lm]) =
        make_float4(areg[0], areg[1], areg[2], areg[3]);
    *reinterpret_cast<float4*>(&Bs[buf][lk][lm]) =
        make_float4(breg[0], breg[1], breg[2], breg[3]);
  };

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) zero4(acc[i]);

  const int ntiles = (kend - kbeg + BK - 1) / BK;
  load_tile(kbeg);
  store_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) load_tile(kbeg + (t + 1) * BK);
    mac_tile(As[buf], Bs[buf], ty, tx, acc);
    if (t + 1 < ntiles) store_tile(buf ^ 1);
    __syncthreads();
  }

  float* out = p.splits == 1 ? p.dw
                             : p.wpart + (size_t)blockIdx.z * p.Co * N;
  const int n = col0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = row0 + ty * 4 + i;
    if (o < p.Co && n < N) store4(out + (size_t)o * N + n, acc[i]);
  }
}

// out[e] = sum_s part[s][e], in s order
static __global__ void split_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out,
                                           int splits, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[(size_t)i * n + e];
  out[e] = s;
}

// dgrad (+ the BN-sum reduction when FUSED), then wgrad (+ the split
// reduction when splits > 1).  Returns the first launch error.
template <typename T, int TAPS, int GM, bool FUSED>
int launch(const Args& p, cudaStream_t st) {
  const dim3 dgrid((p.Ci + BN - 1) / BN, (p.R + BM - 1) / BM);
  dgrad_kernel<T, TAPS, GM, FUSED><<<dgrid, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (FUSED) {
    fu::stats_reduce_kernel<<<(p.Ci + 127) / 128, 128, 0, st>>>(
        p.part, p.db, p.dg, dgrid.y, p.Ci);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int N = TAPS * p.Ci;
  const dim3 wgrid((N + BN - 1) / BN, (p.Co + BM - 1) / BM, p.splits);
  wgrad_kernel<T, TAPS, GM, FUSED><<<wgrid, THREADS, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const size_t n = (size_t)p.Co * N;
  split_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      p.wpart, p.dw, p.splits, n);
  return (int)cudaGetLastError();
}

}  // namespace fub
