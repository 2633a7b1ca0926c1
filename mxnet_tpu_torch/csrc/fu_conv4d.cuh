// The FFMA tile loop of K4 (fu_c3_fwd4d.cu): the 3x3 / stride 1 / pad 1
// convolution of the fused bottleneck unit over whole NHWC images, forward,
// on spatial tiles whose halo is staged in shared memory.  Its backward, K7,
// runs on the tensor cores (fu_halo.cuh).
//
// With a = T(relu(x * sc + sh)) the consumer's BatchNorm+ReLU prologue (f32,
// rounded to the data type T) and taps t = (dh, dw) in 0..2:
//
//   y[n, h, w, o] = sum_{t, i} a[n, h + dh - 1, w + dw - 1, i] * W[o, t, i]
//
// with a zero outside the image: the padding is applied after the prologue,
// as the reference pads (mxnet_tpu/ops/fused_unit.py _k_conv3_fwd: jnp.pad
// of the normalized activation).  The optional sums are sum y and sum y^2 of
// the f32 accumulator.  The weight is read in the checkpoint's OHWI layout
// (Co, 3, 3, Ci) in place, along Ci.
//
// Design.  The TPU kernel holds whole (batch tile, H, W, C) blocks in VMEM
// and pads them there.  Here a block owns a TH x TW = 8 x 8 spatial tile of
// one image (tiles at the right and bottom edges are masked) times a slab of
// 64 output channels; 8 x 8 covers ResNet-50's 56 x 56 exactly and its
// 28, 14 and 7 at 77-88% per side.  For each chunk of CK = 8 input channels
// it stages the tile's (TH + 2) x (TW + 2) halo through the prologue with
// zeros outside the image, and the nine taps' weights for its slab, into
// shared memory, then walks the nine taps out of shared memory: each input
// element is read from device memory once per block, where the row-layout
// K3 reads it once per tap.  256 threads each own 4 neighbouring pixels of
// one tile row times 4 channels; for each input channel and tap row they
// read 6 staged pixels once and reuse them across the tap row's three
// weights (48 FFMA for 6 scalar and 3 vector shared-memory reads).  The
// sums are per-tile partials added in tile order.  No float atomics, so two
// launches on the same inputs give the same bits.
//
// Bound: at ResNet-50 widths it is well above the H100's FP32 ridge point,
// so arithmetic bounds it (2 * 9 * Ci * Co FLOP per output pixel).  This
// first version uses FFMA on CUDA cores with f32 staging in both dtypes, as
// K2 does; bf16 runs at the f32 rate, far from its tensor-core bound.
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

struct Args {
  const void* x;       // (N, H, W, Ci) conv input, T
  const void* w;       // (Co, 3, 3, Ci) OHWI weight, T
  const float* sc;     // (Ci,) prologue scale / shift
  const float* sh;
  void* out;           // y (N, H, W, Co)
  float* part;         // (2, N * tiles_img, Co) per-tile partial sums
  float* s;            // (Co,) sum y
  float* ss;           // (Co,) sum y^2
  int N, H, W, Ci, Co, tiles_w, tiles_img;
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

// The forward of one spatial tile (blockIdx.y) times 64 output channels
// (blockIdx.x).  STATS: per-tile partial sums into p.part.
template <typename T, bool STATS>
__global__ void __launch_bounds__(THREADS)
halo_conv_kernel(const __grid_constant__ Args p) {
  __shared__ __align__(16) float Xs[CK][HPX + 4];   // staged halo, k-major
  __shared__ __align__(16) float Ws[9][CK][BN];     // [tap][k][n]

  const int tid = threadIdx.x;
  const int KC = p.Ci;   // reduction channels
  const int NC = p.Co;   // output channels
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
        load_a4<T>(p, pix(p, img, hh, ww) * KC + k0 + kq, k0 + kq, v);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Xs[kq + j][px] = v[j];
    }
    // the nine taps' weights of this chunk and slab
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
      if (STATS) {
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

// K4: the forward, plus the ordered reduction of its per-tile sums when
// with_stats.  Returns the first launch error.
template <typename T>
int launch_fwd(const Args& p, int with_stats, cudaStream_t st) {
  const dim3 grid((p.Co + BN - 1) / BN, p.N * p.tiles_img);
  if (!with_stats) {
    halo_conv_kernel<T, false><<<grid, THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  halo_conv_kernel<T, true><<<grid, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fu::stats_reduce_kernel<<<(p.Co + 127) / 128, 128, 0, st>>>(
      p.part, p.s, p.ss, grid.y, p.Co);
  return (int)cudaGetLastError();
}

}  // namespace fu4
