// K8: the backward of a channels-last stride-1 1x1 convolution, dx = dy @ w
// (rounded to the data type) and dw = dy^T x (f32), in one call.  Replaces
// the TPU kernel mxnet_tpu/ops/nn.py _fused1x1_bwd_pallas.  These are K5's
// two products without the finalize, the prologue, the mask or the sums,
// so they run on K5's tiles (fu_bwd.cuh, where the bound and the
// determinism are described).
#include "fu_bwd.cuh"

// x (R, Ci), dy (R, Co), w (Co, Ci).  Writes dx (R, Ci) and dw (Co, Ci)
// f32; wpart (splits, Co, Ci) f32 is scratch.
extern "C" int nn_conv1x1_bwd(const void* x, const void* dy, const void* w,
                              void* dx, void* dw, void* wpart, int R, int Ci,
                              int Co, int splits, int chunk, int bf16,
                              void* stream) {
  fub::Args p = {};
  p.g = dy;
  p.x = x;
  p.w = w;
  p.dx = dx;
  p.dw = static_cast<float*>(dw);
  p.wpart = static_cast<float*>(wpart);
  p.R = R;
  p.Ci = Ci;
  p.Co = Co;
  p.splits = splits;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fub::launch<__nv_bfloat16, 1, fub::G_RAW, false>(p, st);
  return fub::launch<float, 1, fub::G_RAW, false>(p, st);
}
