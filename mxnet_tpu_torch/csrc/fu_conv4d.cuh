// Shared tile loops of K4 (fu_c3_fwd4d.cu) and K7 (fu_c3_bwd4d.cu): the
// 3x3 / stride 1 / pad 1 convolution of the fused bottleneck unit over whole
// NHWC images, forward and backward, on spatial tiles whose halo is staged
// in shared memory.
//
// With a = T(relu(x * sc + sh)) the consumer's BatchNorm+ReLU prologue (f32,
// rounded to the data type T) and taps t = (dh, dw) in 0..2:
//
//   forward  y[n, h, w, o]  = sum_{t, i} a[n, h + dh - 1, w + dw - 1, i] * W[o, t, i]
//   dgrad    da[n, h, w, i] = sum_{t, o} g[n, h - dh + 1, w - dw + 1, o] * W[o, t, i]
//   wgrad    dW[o, t, i]    = sum_{n, h, w} g[n, h, w, o] * a[n, h + dh - 1, w + dw - 1, i]
//
// with a and g zero outside the image: the padding is applied after the
// prologue and after the finalize, as the reference pads (mxnet_tpu/ops/
// fused_unit.py _k_conv3_fwd / _k_conv3_bwd: jnp.pad of the normalized
// activation and of the finalized cotangent).  In the backward the cotangent
// is finalized while it is staged, g = T(c1 * g_in + u0 + u1 * y_raw) (the
// consumer BatchNorm's deferred backward), dgrad is masked by the recomputed
// ReLU, dP = da * (relu(x * sc + sh) > 0), and the BatchNorm sums sum dP and
// sum dP * (x * xs + xh) come from the f32 dP.  The forward's optional sums
// are sum y and sum y^2 of the f32 accumulator.  The weight is read in the
// checkpoint's OHWI layout (Co, 3, 3, Ci) in place for all three products:
// the forward walks it along Ci, dgrad along Ci for each (o, tap) with the
// tap rotated by 180 degrees, and wgrad writes its f32 gradient in the same
// (Co, 3, 3, Ci) layout.
//
// Design.  The TPU kernels hold whole (batch tile, H, W, C) blocks in VMEM
// and pad them there.  Here a block owns a TH x TW = 8 x 8 spatial tile of
// one image (tiles at the right and bottom edges are masked) times a slab of
// 64 output channels; 8 x 8 covers ResNet-50's 56 x 56 exactly and its
// 28, 14 and 7 at 77-88% per side.  For each chunk of CK = 8 reduction
// channels it stages the tile's (TH + 2) x (TW + 2) halo through the
// prologue (or the finalize) with zeros outside the image, and the nine taps'
// weights for its slab, into shared memory, then walks the nine taps out of
// shared memory: each input element is read from device memory once per
// block, where the row-layout K3 / K6 read it once per tap.  256 threads each
// own 4 neighbouring pixels of one tile row times 4 channels; for each
// reduction channel and tap row they read 6 staged pixels once and reuse them
// across the tap row's three weights (48 FFMA for 6 scalar and 3 vector
// shared-memory reads).  The wgrad tiles the (o, i) weight gradient with all
// nine taps in one block (64 o x 32 i x 9 taps, 4 x 2 x 9 f32 accumulators a
// thread) and walks spatial tiles: per tile it stages the finalized g (64
// pixels x 64 o) and the activation halo (100 pixels x 32 i) and adds, per
// pixel, 72 products for one vector and nine pair reads.  Its sum over
// N x H x W is cut into a number of tile chunks fixed by the shapes alone and
// the chunks' partials are added in chunk order; the BatchNorm and forward
// sums are per-tile partials added in tile order.  No float atomics, so two
// launches on the same inputs give the same bits.
//
// Bound: at ResNet-50 widths these are well above the H100's FP32 ridge
// point, so arithmetic bounds them (2 * 9 * Ci * Co FLOP per output pixel per
// product).  This first version uses FFMA on CUDA cores with f32 staging in
// both dtypes, as K2 and K3 do; bf16 runs at the f32 rate, far from its
// tensor-core bound (K6, the row-layout twin of K7, runs on fu_mma.cuh).
#pragma once

#include "fu_gemm.cuh"

namespace fu4 {

using fu::from_f;
using fu::load4;
using fu::store4;
using fu::to_f;

constexpr int TH = 8;                         // tile rows
constexpr int TW = 8;                         // tile columns
constexpr int HWD = TW + 2;                   // halo width
constexpr int HPX = (TH + 2) * (TW + 2);      // halo pixels
constexpr int BN = 64;                        // output channels per block
constexpr int CK = 8;                         // channels per staged chunk
constexpr int THREADS = 256;
constexpr int WO = 64;                        // wgrad block: o ...
constexpr int WI = 32;                        // ... x i (x 9 taps)

enum Mode { FWD = 0, DGRAD = 1 };

struct Args {
  const void* x;       // (N, H, W, Ci) conv input, T
  const void* g;       // (N, H, W, Co) cotangent, T (backward)
  const void* yraw;    // (N, H, W, Co) raw conv output, T (backward)
  const float* c1;     // (Co,) deferred finalize vectors (backward)
  const float* u0;
  const float* u1;
  const void* w;       // (Co, 3, 3, Ci) OHWI weight, T
  const float* sc;     // (Ci,) prologue scale / shift
  const float* sh;
  const float* xs;     // (Ci,) xhat = x * xs + xh (backward)
  const float* xh;
  void* out;           // forward y (N, H, W, Co); backward dP (N, H, W, Ci)
  float* part;         // (2, N * tiles_img, NC) per-tile partial sums
  float* s;            // (NC,) sum y, or sum dP
  float* ss;           // (NC,) sum y^2, or sum dP * xhat
  float* dw;           // (Co, 9 * Ci) f32 (backward)
  float* wpart;        // (splits, Co, 9 * Ci) f32 when splits > 1
  int N, H, W, Ci, Co, tiles_w, tiles_img, splits, chunk;
};

__device__ __forceinline__ void tile_origin(const Args& p, int tile, int& img,
                                            int& h0, int& w0) {
  img = tile / p.tiles_img;
  const int t = tile - img * p.tiles_img;
  h0 = (t / p.tiles_w) * TH;
  w0 = (t % p.tiles_w) * TW;
}

__device__ __forceinline__ size_t pix(const Args& p, int img, int h, int w) {
  return ((size_t)img * p.H + h) * p.W + w;
}

// a = T(relu(x * sc + sh)) of input channels i..i+3 at element offset `off`
template <typename T>
__device__ __forceinline__ void load_a4(const Args& p, size_t off, int i,
                                        float v[4]) {
  load4(static_cast<const T*>(p.x) + off, v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float z = __fadd_rn(__fmul_rn(v[j], p.sc[i + j]), p.sh[i + j]);
    v[j] = to_f(from_f<T>(fmaxf(z, 0.f)));
  }
}

// g = T(((c1 * g_in) + u0) + (u1 * y_raw)) of channels o..o+3 at `off`
template <typename T>
__device__ __forceinline__ void load_g4(const Args& p, size_t off, int o,
                                        float v[4]) {
  float y[4];
  load4(static_cast<const T*>(p.g) + off, v);
  load4(static_cast<const T*>(p.yraw) + off, y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float z = __fadd_rn(__fadd_rn(__fmul_rn(p.c1[o + j], v[j]),
                                        p.u0[o + j]),
                              __fmul_rn(p.u1[o + j], y[j]));
    v[j] = to_f(from_f<T>(z));
  }
}

// The forward (MODE FWD: reduce over Ci, out Co) or the dgrad (MODE DGRAD:
// reduce over Co, out Ci) of one spatial tile (blockIdx.y) times 64 output
// channels (blockIdx.x).  STATS: per-tile partial sums into p.part.
template <typename T, int MODE, bool STATS>
__global__ void __launch_bounds__(THREADS)
halo_conv_kernel(const __grid_constant__ Args p) {
  __shared__ __align__(16) float Xs[CK][HPX + 4];   // staged halo, k-major
  __shared__ __align__(16) float Ws[9][CK][BN];     // [tap][k][n]

  const int tid = threadIdx.x;
  const int KC = MODE == FWD ? p.Ci : p.Co;   // reduction channels
  const int NC = MODE == FWD ? p.Co : p.Ci;   // output channels
  const int col0 = blockIdx.x * BN;
  int img, h0, w0;
  tile_origin(p, blockIdx.y, img, h0, w0);
  const T* w = static_cast<const T*>(p.w);

  // this thread's outputs: channels col0 + tx*4 .. +4 of pixels
  // (h0 + ph, w0 + pw .. + 4)
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ph = ty >> 1;
  const int pw = (ty & 1) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < KC; k0 += CK) {
    // the halo: HPX pixels x CK channels, four channels per load, zero
    // outside the image and past KC
    for (int e = tid; e < HPX * (CK / 4); e += THREADS) {
      const int px = e / (CK / 4);
      const int kq = (e - px * (CK / 4)) * 4;
      const int hh = h0 - 1 + px / HWD, ww = w0 - 1 + px % HWD;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && k0 + kq < KC) {
        const size_t off = pix(p, img, hh, ww) * KC + k0 + kq;
        if (MODE == FWD)
          load_a4<T>(p, off, k0 + kq, v);
        else
          load_g4<T>(p, off, k0 + kq, v);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Xs[kq + j][px] = v[j];
    }
    // the nine taps' weights of this chunk and slab
    if (MODE == FWD) {
      // W[n, t, k] is contiguous in k; consecutive threads take
      // consecutive n so that their shared-memory stores miss each other
      for (int e = tid; e < BN * 9 * (CK / 4); e += THREADS) {
        const int n = e % BN;
        const int r = e / BN;
        const int t = r / (CK / 4);
        const int kq = (r - t * (CK / 4)) * 4;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (col0 + n < NC && k0 + kq < KC)
          load4(w + ((size_t)(col0 + n) * 9 + t) * KC + k0 + kq, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) Ws[t][kq + j][n] = v[j];
      }
    } else {
      // halo offset t = (eh, ew) meets tap 8 - t (rotated by 180 degrees);
      // W[k, 8 - t, n] is contiguous in n
      for (int e = tid; e < CK * 9 * (BN / 4); e += THREADS) {
        const int nq = (e % (BN / 4)) * 4;
        const int r = e / (BN / 4);
        const int t = r % 9;
        const int k = r / 9;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (k0 + k < KC && col0 + nq < NC)
          load4(w + ((size_t)(k0 + k) * 9 + 8 - t) * NC + col0 + nq, v);
        *reinterpret_cast<float4*>(&Ws[t][k][nq]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < CK; ++k) {
#pragma unroll
      for (int eh = 0; eh < 3; ++eh) {
        const float* xr = &Xs[k][(ph + eh) * HWD + pw];
        float a[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) a[q] = xr[q];
#pragma unroll
        for (int ew = 0; ew < 3; ++ew) {
          const float4 b =
              *reinterpret_cast<const float4*>(&Ws[eh * 3 + ew][k][tx * 4]);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i + ew], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int c = col0 + tx * 4;
  const int oh = h0 + ph;
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, css[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ow = w0 + pw + i;
    if (oh < p.H && ow < p.W && c < NC) {
      const size_t off = pix(p, img, oh, ow) * NC + c;
      float v[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      if (MODE == DGRAD) {
        float xv[4];
        load4(static_cast<const T*>(p.x) + off, xv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a32 = fmaxf(
              __fadd_rn(__fmul_rn(xv[j], p.sc[c + j]), p.sh[c + j]), 0.f);
          v[j] = a32 > 0.f ? v[j] : 0.f;
          const float xhat =
              __fadd_rn(__fmul_rn(xv[j], p.xs[c + j]), p.xh[c + j]);
          cs[j] += v[j];
          css[j] += __fmul_rn(v[j], xhat);
        }
      } else if (STATS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cs[j] += v[j];
          css[j] += v[j] * v[j];
        }
      }
      store4(static_cast<T*>(p.out) + off, v);
    }
  }

  if (STATS) {
    // per-channel sums over the tile's pixels, in a fixed order; pixels
    // outside the image added nothing
    __shared__ float red[2][THREADS / 16][BN];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = cs[j];
      red[1][ty][tx * 4 + j] = css[j];
    }
    __syncthreads();
    const int which = tid / BN, col = tid % BN;
    if (tid < 2 * BN && col0 + col < NC) {
      float s = 0.f;
      for (int q = 0; q < THREADS / 16; ++q) s += red[which][q][col];
      p.part[((size_t)which * gridDim.y + blockIdx.y) * NC + col0 + col] = s;
    }
  }
}

// wgrad of the tiles [z * chunk, min(tiles, (z + 1) * chunk)) into the
// (o, tap, i) block (blockIdx.y * WO .., tap, blockIdx.x * WI ..).
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad4d_kernel(const __grid_constant__ Args p) {
  __shared__ __align__(16) float Gs[TH * TW][WO];   // finalized g, [px][o]
  __shared__ __align__(16) float As[HPX][WI];       // activation halo, [px][i]

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * WI;
  const int o0 = blockIdx.y * WO;
  const int tiles = p.N * p.tiles_img;
  const int tbeg = blockIdx.z * p.chunk;
  const int tend = min(tiles, tbeg + p.chunk);
  // this thread's outputs: o0 + og*4 .. +4, i0 + ig*2 .. +2, all nine taps
  const int og = tid & 15;
  const int ig = tid >> 4;

  float acc[9][4][2];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r][0] = acc[t][r][1] = 0.f;

  for (int tile = tbeg; tile < tend; ++tile) {
    int img, h0, w0;
    tile_origin(p, tile, img, h0, w0);
    // g at the tile's own pixels (zero outside the image: such pixels add
    // nothing), and the activation over its halo
    for (int e = tid; e < TH * TW * (WO / 4); e += THREADS) {
      const int px = e / (WO / 4);
      const int oq = (e - px * (WO / 4)) * 4;
      const int hh = h0 + px / TW, ww = w0 + px % TW;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (hh < p.H && ww < p.W && o0 + oq < p.Co)
        load_g4<T>(p, pix(p, img, hh, ww) * p.Co + o0 + oq, o0 + oq, v);
      *reinterpret_cast<float4*>(&Gs[px][oq]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int e = tid; e < HPX * (WI / 4); e += THREADS) {
      const int px = e / (WI / 4);
      const int iq = (e - px * (WI / 4)) * 4;
      const int hh = h0 - 1 + px / HWD, ww = w0 - 1 + px % HWD;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && i0 + iq < p.Ci)
        load_a4<T>(p, pix(p, img, hh, ww) * p.Ci + i0 + iq, i0 + iq, v);
      *reinterpret_cast<float4*>(&As[px][iq]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll 1
    for (int px = 0; px < TH * TW; ++px) {
      const float4 gq = *reinterpret_cast<const float4*>(&Gs[px][og * 4]);
      const float gv[4] = {gq.x, gq.y, gq.z, gq.w};
      const int base = (px / TW) * HWD + px % TW;
#pragma unroll
      for (int eh = 0; eh < 3; ++eh)
#pragma unroll
        for (int ew = 0; ew < 3; ++ew) {
          const float2 a = *reinterpret_cast<const float2*>(
              &As[base + eh * HWD + ew][ig * 2]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[eh * 3 + ew][r][0] = fmaf(gv[r], a.x, acc[eh * 3 + ew][r][0]);
            acc[eh * 3 + ew][r][1] = fmaf(gv[r], a.y, acc[eh * 3 + ew][r][1]);
          }
        }
    }
    __syncthreads();
  }

  float* out = p.splits == 1
                   ? p.dw
                   : p.wpart + (size_t)blockIdx.z * p.Co * 9 * p.Ci;
  const int i = i0 + ig * 2;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = o0 + og * 4 + r;
      if (o < p.Co && i < p.Ci)
        *reinterpret_cast<float2*>(out + ((size_t)o * 9 + t) * p.Ci + i) =
            make_float2(acc[t][r][0], acc[t][r][1]);
    }
}

// K4: the forward, plus the ordered reduction of its per-tile sums when
// with_stats.  Returns the first launch error.
template <typename T>
int launch_fwd(const Args& p, int with_stats, cudaStream_t st) {
  const dim3 grid((p.Co + BN - 1) / BN, p.N * p.tiles_img);
  if (!with_stats) {
    halo_conv_kernel<T, FWD, false><<<grid, THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  halo_conv_kernel<T, FWD, true><<<grid, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fu::stats_reduce_kernel<<<(p.Co + 127) / 128, 128, 0, st>>>(
      p.part, p.s, p.ss, grid.y, p.Co);
  return (int)cudaGetLastError();
}

// K7: dgrad with its BatchNorm sums, then wgrad and its chunk reduction.
template <typename T>
int launch_bwd(const Args& p, cudaStream_t st) {
  const dim3 dgrid((p.Ci + BN - 1) / BN, p.N * p.tiles_img);
  halo_conv_kernel<T, DGRAD, true><<<dgrid, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fu::stats_reduce_kernel<<<(p.Ci + 127) / 128, 128, 0, st>>>(
      p.part, p.s, p.ss, dgrid.y, p.Ci);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 wgrid((p.Ci + WI - 1) / WI, (p.Co + WO - 1) / WO, p.splits);
  wgrad4d_kernel<T><<<wgrid, THREADS, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const size_t n = (size_t)p.Co * 9 * p.Ci;
  fu::split_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      p.wpart, p.dw, p.splits, n);
  return (int)cudaGetLastError();
}

}  // namespace fu4
