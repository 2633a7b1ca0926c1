// K10: the multi-row KV-cache write that commits a speculative window,
//     cache[i, p + j, :] = rows[i, j, :]
//         for j < clamp(trunc(count[i]), 0, K) and 0 <= p + j < T,
//     where p = trunc(pos[i]),
// in place.  A row outside [0, T) is dropped, never clamped, and a rejected
// row moves zero bytes.  Replaces the TPU kernel mxnet_tpu/ops/cache.py
// _scatter_rows_pallas (grid (slots, K), one predicated DMA per row).
//
// Bound on the H100: bytes.  The work moves each accepted row twice (read,
// write) plus pos and count: at most 2 * slots * K * d elements, 64 KB for
// the decoder at 8 slots, K = 5, d = 200 in float32, about 19 ns at
// 3.35 TB/s, so a launch sits at the card's launch latency.  The blend chain
// it replaces reads and writes the whole (slots, T, d) cache K times.
//
// Grid: (slot, j, chunk of the row).  Each block reads its slot's position
// and count on the device, returns at once when its row is rejected or out
// of range, and otherwise copies the row with 16-byte accesses when the
// row's byte width and both base pointers allow it, else with accesses of
// the element's width.  Distinct j of one slot land on distinct rows, so
// the blocks never race.  Asynchronous on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int read_index(const void* v, int i, int is_int) {
  if (is_int) return static_cast<const int*>(v)[i];
  return __float2int_rz(static_cast<const float*>(v)[i]);
}

template <typename V>
__global__ void write_rows(char* __restrict__ cache,
                           const char* __restrict__ rows,
                           const void* __restrict__ pos,
                           const void* __restrict__ count, int T, int K,
                           int nvec, int row_bytes, int pos_int,
                           int count_int) {
  const int i = blockIdx.x;
  const int j = blockIdx.y;
  const int c = min(max(read_index(count, i, count_int), 0), K);
  if (j >= c) return;
  const int p = read_index(pos, i, pos_int) + j;
  if (p < 0 || p >= T) return;
  const V* src =
      reinterpret_cast<const V*>(rows + ((size_t)i * K + j) * row_bytes);
  V* dst = reinterpret_cast<V*>(cache + ((size_t)i * T + p) * row_bytes);
  for (int v = blockIdx.z * blockDim.x + threadIdx.x; v < nvec;
       v += gridDim.z * blockDim.x)
    dst[v] = src[v];
}

template <typename V>
int launch(void* cache, const void* rows, const void* pos, const void* count,
           int slots, int T, int K, int row_bytes, int pos_int, int count_int,
           cudaStream_t st) {
  const int nvec = row_bytes / (int)sizeof(V);
  int chunks = (nvec + kThreads - 1) / kThreads;
  if (chunks > 65535) chunks = 65535;
  write_rows<V><<<dim3(slots, K, chunks), kThreads, 0, st>>>(
      static_cast<char*>(cache), static_cast<const char*>(rows), pos, count,
      T, K, nvec, row_bytes, pos_int, count_int);
  return (int)cudaGetLastError();
}

}  // namespace

// cache (slots, T, row_bytes) and rows (slots, K, row_bytes) as raw bytes of
// elements esize bytes wide; pos and count (slots,) float32 (flag 0) or
// int32 (flag 1).  Returns the CUDA error of the launch.
extern "C" int cache_write_rows(void* cache, const void* rows, const void* pos,
                                const void* count, int slots, int T, int K,
                                int row_bytes, int esize, int pos_int,
                                int count_int, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec16 = row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  if (vec16)
    return launch<uint4>(cache, rows, pos, count, slots, T, K, row_bytes,
                         pos_int, count_int, st);
  if (esize == 4)
    return launch<uint32_t>(cache, rows, pos, count, slots, T, K, row_bytes,
                            pos_int, count_int, st);
  return launch<uint16_t>(cache, rows, pos, count, slots, T, K, row_bytes,
                          pos_int, count_int, st);
}
