// K3 of the fused bottleneck unit: the 3x3 / stride 1 / pad 1 convolution of
// T(relu(x * sc + sh)) over whole NHWC images kept as (rows, C), with the
// optional per-channel sum / sum-of-squares epilogue of the f32
// accumulator.  Replaces the TPU kernel mxnet_tpu/ops/fused_unit.py
// _k_conv3_fwd_2d (pallas_call in _c3_fwd2d, "fu_c3_fwd2d"); its
// roll-and-mask tap shift becomes a gather in the staging of the
// activation, and it runs at every width.  On the tensor cores (bf16 MMA,
// f32 through 3xTF32), as K1 with k = (tap, channel) tap-major:
//   y (R, Co) = a' (R, 9 Ci) @ w' (9 Ci, Co), where a'[r, (t, c)] =
//   act(x)[r + dh * W + dw, c] (zero off the image, after the prologue) is
//   staged K-major through the prologue (G_SHIFT_KP) and w' is the OHWI
//   weight read in place, (Co, 9 Ci) K-major,
// on the tile and split of mma_plan(R, Co, 9 Ci).  Tiles, gathers, split
// K, bound and determinism: see fu_mma.cuh.
#include "fu_mma.cuh"

template <typename T>
static int run(const fmma::Gemm& p, int bm, int bn, float* s, float* ss,
               cudaStream_t st) {
  using namespace fmma;
  int err = gemm<T, K_MAJOR, X_PROLOGUE, K_MAJOR, X_RAW, EPI_Y, G_SHIFT_KP,
                 G_NONE>(p, bm, bn, st);
  if (err != cudaSuccess || !p.stats) return err;
  return col_sums(p, bm, s, ss, st);
}

// x (R, C) with R = n * H * W, w (N, 3, 3, C) OHWI, sc/sh (C,) f32, y (R,
// N).  with_stats: part (2, ceil(R / bm), N) f32 scratch, s/ss (N,) f32.
// ws (splits, R, N) f32 scratch when splits > 1.  (bm, bn) is the output
// tile and 9 * C is summed in `splits` chunks of `chunk` (ops/_cuda.py
// mma_plan).  bf16 selects bfloat16 x/w/y, else float32.
extern "C" int fu_c3_fwd2d(const void* x, const void* w, const void* sc,
                           const void* sh, void* y, void* part, void* s,
                           void* ss, void* ws, int R, int C, int N, int H,
                           int W, int bf16, int with_stats, int bm, int bn,
                           int splits, int chunk, void* stream) {
  fmma::Gemm p = {};
  p.a = {x, nullptr, static_cast<const float*>(sc),
         static_cast<const float*>(sh), nullptr, C, C, H, W};
  p.b = {w, nullptr, nullptr, nullptr, nullptr, 9 * C};
  p.out = y;
  p.ws = static_cast<float*>(ws);
  p.spart = static_cast<float*>(part);
  p.M = R;
  p.N = N;
  p.K = 9 * C;
  p.chunk = chunk;
  p.splits = splits;
  p.stats = with_stats;
  float* fs = static_cast<float*>(s);
  float* fss = static_cast<float*>(ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16>(p, bm, bn, fs, fss, st);
  return run<float>(p, bm, bn, fs, fss, st);
}
