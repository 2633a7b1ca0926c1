// K4 of the fused bottleneck unit: the 3x3 / stride 1 / pad 1 convolution
// of T(relu(x * sc + sh)) over NHWC images (zero padding after the
// prologue), with the optional per-channel sum / sum-of-squares epilogue
// of the f32 sum.  Replaces the TPU kernel mxnet_tpu/ops/fused_unit.py
// _k_conv3_fwd (pallas_call in _c3_fwd, "fu_c3_fwd"), the
// MXNET_FUSED_UNIT_C3=4d path; it runs at every width (the TPU's
// scoped-VMEM gates sent stage 4 to XLA).  On the tensor cores (bf16 MMA,
// f32 through 3xTF32), on the halo loop of K7's dgrad (fu_halo.cuh):
//   y (R, Co) = sum_t shift_t(act(x)) (R, Ci) @ w_t^T, BM x BN tiles, k =
//   (Ci chunk, tap); per chunk act(x) of a band of pixels is staged once
//   into a halo that the nine taps read at row m + (dh W + dw), and the
//   OHWI weight, (Co, 9 Ci) K-major, streams through fu_mma.cuh's ring;
//   Ci split in `splits` chunks of `chunk` (ops/_cuda.py halo_fwd_plan),
//   statistics per row tile added by col_sums.
// Halo, tiles, bound and determinism: see fu_halo.cuh and fu_mma.cuh.
#include "fu_halo.cuh"

template <typename T>
static int run(const fmma::Gemm& p, int bm, int bn, float* s, float* ss,
               cudaStream_t st) {
  int err = fhalo::conv<T, fhalo::FWD>(p, bm, bn, st);
  if (err != cudaSuccess || !p.stats) return err;
  return fmma::col_sums(p, bm, s, ss, st);
}

// x (N, H, W, C), w (Co, 3, 3, C) OHWI, sc/sh (C,) f32, y (N, H, W, Co).
// with_stats: part (2, ceil(R / bm), Co) f32 scratch, s/ss (Co,) f32.  ws
// (splits, R, Co) f32 scratch when splits > 1; R = N * H * W.  bf16
// selects bfloat16 x/w/y, else float32.
extern "C" int fu_c3_fwd4d(const void* x, const void* w, const void* sc,
                           const void* sh, void* y, void* part, void* s,
                           void* ss, void* ws, int N, int H, int W, int C,
                           int Co, int bf16, int with_stats, int bm, int bn,
                           int splits, int chunk, void* stream) {
  fmma::Gemm p = {};
  p.a = {x, nullptr, static_cast<const float*>(sc),
         static_cast<const float*>(sh), nullptr, C, C, H, W};
  p.b = {w, nullptr, nullptr, nullptr, nullptr, 9 * C};
  p.out = y;
  p.ws = static_cast<float*>(ws);
  p.spart = static_cast<float*>(part);
  p.M = N * H * W;
  p.N = Co;
  p.K = C;
  p.chunk = chunk;
  p.splits = splits;
  p.stats = with_stats;
  float* fs = static_cast<float*>(s);
  float* fss = static_cast<float*>(ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return run<__nv_bfloat16>(p, bm, bn, fs, fss, st);
  return run<float>(p, bm, bn, fs, fss, st);
}
