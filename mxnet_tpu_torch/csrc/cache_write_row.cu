// K9: the single-row KV-cache write of the decode step,
//     cache[i, clamp(trunc(pos[i]), 0, T-1), :] = row[i, :]  for each slot i,
// in place; no other cache byte is read or written.  Replaces the TPU kernel
// mxnet_tpu/ops/cache.py _scatter_pallas (one DMA of the d-wide row per
// slot into the aliased cache).
//
// Bound on the H100: bytes.  The work moves 2 * slots * d elements (each row
// read once, written once) plus the positions: 2 * 8 * 200 * 4 B = 12.8 KB
// for the decoder at d = 200, about 4 ns at 3.35 TB/s, so a launch sits at
// the card's launch latency whatever the design.  What the design does
// about it is to touch nothing else: the one-hot blend this replaces reads
// and writes all T rows of every slot, so its time grows with T while this
// kernel's stays flat.
//
// Grid: one block per slot (x) and per chunk of the row (y).  Each block
// reads its slot's position on the device (float32, truncated toward zero
// as astype(int32) does, or int32), clamps it, and copies the row with
// 16-byte accesses when the row's byte width and both base pointers are
// 16-byte aligned, else with accesses of the element's width.  The launch
// is asynchronous on the caller's stream; the position never visits the
// host.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int read_index(const void* v, int i, int is_int) {
  if (is_int) return static_cast<const int*>(v)[i];
  return __float2int_rz(static_cast<const float*>(v)[i]);
}

template <typename V>
__global__ void write_row(char* __restrict__ cache,
                          const char* __restrict__ row,
                          const void* __restrict__ pos, int T, int nvec,
                          int row_bytes, int pos_int) {
  const int i = blockIdx.x;
  const int p = min(max(read_index(pos, i, pos_int), 0), T - 1);
  const V* src = reinterpret_cast<const V*>(row + (size_t)i * row_bytes);
  V* dst = reinterpret_cast<V*>(cache + ((size_t)i * T + p) * row_bytes);
  for (int v = blockIdx.y * blockDim.x + threadIdx.x; v < nvec;
       v += gridDim.y * blockDim.x)
    dst[v] = src[v];
}

template <typename V>
int launch(void* cache, const void* row, const void* pos, int slots, int T,
           int row_bytes, int pos_int, cudaStream_t st) {
  const int nvec = row_bytes / (int)sizeof(V);
  int chunks = (nvec + kThreads - 1) / kThreads;
  if (chunks > 65535) chunks = 65535;
  write_row<V><<<dim3(slots, chunks), kThreads, 0, st>>>(
      static_cast<char*>(cache), static_cast<const char*>(row), pos, T, nvec,
      row_bytes, pos_int);
  return (int)cudaGetLastError();
}

}  // namespace

// cache (slots, T, row_bytes) and row (slots, row_bytes) as raw bytes of
// elements esize bytes wide (4: f32, 2: f16 or bf16); pos (slots,) float32
// (pos_int 0) or int32 (pos_int 1).  Returns the CUDA error of the launch.
extern "C" int cache_write_row(void* cache, const void* row, const void* pos,
                               int slots, int T, int row_bytes, int esize,
                               int pos_int, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec16 = row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(row) % 16 == 0;
  if (vec16)
    return launch<uint4>(cache, row, pos, slots, T, row_bytes, pos_int, st);
  if (esize == 4)
    return launch<uint32_t>(cache, row, pos, slots, T, row_bytes, pos_int,
                            st);
  return launch<uint16_t>(cache, row, pos, slots, T, row_bytes, pos_int, st);
}
