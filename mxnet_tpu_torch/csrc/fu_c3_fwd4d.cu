// K4 of the fused bottleneck unit: the 3x3 / stride 1 / pad 1 convolution of
// T(relu(x * sc + sh)) over NHWC images on 8 x 8 spatial tiles whose halo is
// staged in shared memory (zeros outside the image, after the prologue), with
// the optional per-channel sum / sum-of-squares epilogue.  Replaces the TPU
// kernel mxnet_tpu/ops/fused_unit.py _k_conv3_fwd (pallas_call in _c3_fwd,
// "fu_c3_fwd"), the MXNET_FUSED_UNIT_C3=4d path; it runs at every width (the
// TPU's scoped-VMEM gates sent stage 4 to XLA).  Tiling, bound and
// determinism: see fu_conv4d.cuh.
#include "fu_conv4d.cuh"

// x (N, H, W, C), w (Co, 3, 3, C) OHWI, sc/sh (C,) f32, y (N, H, W, Co);
// with_stats: part (2, N * tiles_img, Co) f32 scratch, s/ss (Co,) f32.
// tiles_w = ceil(W / 8), tiles_img = ceil(H / 8) * tiles_w.
extern "C" int fu_c3_fwd4d(const void* x, const void* w, const void* sc,
                           const void* sh, void* y, void* part, void* s,
                           void* ss, int N, int H, int W, int C, int Co,
                           int tiles_w, int tiles_img, int bf16,
                           int with_stats, void* stream) {
  fu4::Args p = {};
  p.x = x;
  p.w = w;
  p.sc = static_cast<const float*>(sc);
  p.sh = static_cast<const float*>(sh);
  p.out = y;
  p.part = static_cast<float*>(part);
  p.s = static_cast<float*>(s);
  p.ss = static_cast<float*>(ss);
  p.N = N;
  p.H = H;
  p.W = W;
  p.Ci = C;
  p.Co = Co;
  p.tiles_w = tiles_w;
  p.tiles_img = tiles_img;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return fu4::launch_fwd<__nv_bfloat16>(p, with_stats, st);
  return fu4::launch_fwd<float>(p, with_stats, st);
}
