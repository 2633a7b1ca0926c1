// Tensor-core tile loop of K1 (fu_mm_fwd.cu), K2 (fu_mm_skip_fwd.cu), K3
// (fu_c3_fwd2d.cu), K5 (fu_mm_bwd.cu), K6 (fu_c3_bwd2d.cu) and K8
// (nn_conv1x1_bwd.cu); its pieces (fragments, 3xTF32 split, cp.async ring,
// epilogues, reductions) also carry the halo-resident loop of K4 and K7
// (fu_halo.cuh).
//
// One templated GEMM  C[m, n] = sum_k A[m, k] * B[k, n]  with f32
// accumulation in the tensor cores (mma.sync), whose operands are staged
// from device memory through an optional per-element transform:
//   - X_RAW       the value as stored (K8's operands);
//   - X_PROLOGUE  T(relu(v * v0[ch] + v1[ch]))        act(x) (K1, K3, K5, K6);
//   - X_FINALIZE  T(v0[ch] * v + v1[ch] + v2[ch] * y) deferred g (K5, K6),
// each step rounded as the plain versions compute it (ops/fused_unit.py),
// where ch is the operand's channel: k for an operand stored K-major (k
// contiguous: K1's x and w, g in a dgrad), m or n for one stored MN-major
// (the OHWI weight in a dgrad, g^T and act(x) in a wgrad).  The weights are
// read in place in their OHWI layout.
//
// Gathers: where an operand's elements lie, for K3's and K6's 3x3 / stride
// 1 / pad 1 over whole images kept as (rows, C), rows = (n, h, w), with k or
// n = (t, c), c < gc, for tap t = 3 * (dh + 1) + (dw + 1):
//   - G_SHIFT_K  K-major A of K6's dgrad: (m, (t, c)) at row m - (dh*W + dw),
//                zero where pixel (h - dh, w - dw) leaves the image;
//   - G_SHIFT_KP K-major A of K3: (m, (t, c)) at row m + (dh*W + dw), zero
//                where pixel (h + dh, w + dw) leaves the image;
//   - G_SHIFT_N  MN-major B of the wgrad: (k, (t, c)) at row k + (dh*W + dw),
//                zero where pixel (h + dh, w + dw) leaves the image;
//   - G_OHWI     MN-major B of the dgrad, the (Co, 3, 3, Ci) weight read in
//                place: ((t, o), n) at w[(o * 9 + t) * Ci + n].
// A gather moves each quad's source address and narrows its validity,
// nothing else (gc % 4 == 0 keeps a quad inside one tap, and its cp.async
// source aligned).  Off the image a quad is zeroed after the transform, as
// past the edges, since neither finalize(0) nor relu(sh) is zero.  A
// K-major thread keeps its rows across k tiles, so their image edges are
// found once a block; an MN-major thread's k rows change every tile, and
// `issue` finds their pixels by multiply-high division, outside the
// multiply phase; the validity of the quads in flight rides in one
// register from `issue` to `transform`.
//
// Arithmetic.  bf16 operands go straight to mma.m16n8k16 (bf16 products
// are exact in f32).  f32 operands go through 3xTF32: each value v is split
// as it is staged into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna, round
// to nearest, ties away from zero), and every product is accumulated as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi on mma.m16n8k8.tf32, small terms first.
// The dropped lo*lo term and the rounding of lo leave about 2^-21 of each
// product, f32's own order, where one TF32 pass would keep 2^-11.  An MMA
// rounds its sum, its C operand included, toward zero (ops/fused_unit.py
// _MMA_BITS), so an accumulator that is every MMA's C drifts toward zero by
// up to an ulp of the running sum per MMA, a bias that grows with the
// length of the summed axis (2.7e-4 of K5's weight gradient summed over
// 800K rows on an H100; PERF.md, Findings).  So f32 promotes: each k
// tile's MMAs run into a partial `part` from zero, and the partial is added
// into the accumulator with an f32 add, rounded to nearest (promote).  The
// bias is then bounded by a tile's 12 MMAs, relative to the tile's own
// sum, whatever the axis' length.  bf16 accumulates in the MMAs' C (its
// products are exact, and its sums' drift stays under its outputs'
// rounding).
//
// Design (what bounds it, and what the loop does about it).  At ResNet-50
// widths every call is bound by arithmetic: 2*M*N*K operations against
// (M*K + K*N + M*N) elements.  The FFMA loop it replaces peaked near half of
// 67 TFLOP/s, held back by shared-memory bandwidth (two LDS.128 per 16
// FMAs).  Here a block of 256 threads (8 warps) owns a BM x BN output tile,
// 128 x 128 (bf16 only), 128 x 64 or 64 x 128, chosen with the split of K
// from the shapes alone in Python (ops/_cuda.py mma_plan, mma_wgrad_plan),
// so the sum order, and the bits, never depend on the device.  Each warp
// holds a 64 x 32 or 32 x 32 f32 accumulator as m16n8 fragments; fragment
// loads are ldmatrix where the layout allows and conflict-free LDS.32 for
// tf32 in MN-major tiles.  128-byte k tiles (32 f32, 64 bf16) stream
// through a ring of shared-memory stages by cp.async, the next tile in
// flight while one is multiplied; once a thread's copies of a tile have
// landed it rewrites them in place (the operand's transform and rounding,
// with its per-channel vectors fetched a tile ahead, and for f32 the split
// into hi and lo planes), once per element, and one barrier a tile
// publishes them, so the inner loop holds only fragment loads and MMAs.
// Two blocks share an SM (at most 128 registers a thread, about 110 KB of
// ring, the whole carveout as shared memory), which is why f32 takes no
// 128 x 128 tile: its two-plane stages would leave one block an SM.
// Padded rows keep the fragment loads free of bank conflicts.  Rows past
// M, columns past N and k past K (or past the block's chunk) stage zeros,
// so any M and any K, N that are multiples of 4 work.  On an NVIDIA H100
// 80GB HBM3 at 700 W the multiply phase is bound by the shared-memory
// traffic of the fragment loads (about half of TF32's dense rate in f32, a
// third of bf16's), and the staging rewrite adds 25-60% to it
// (chip_mma_probe.py; PERF.md, Findings).
//
// Split K.  A call whose tile grid leaves most of the 132 SMs idle (the
// dgrads, K1's and K3's products at stages 2-4, K2's at stage 4, every
// wgrad, where K = rows) cuts K into `splits` chunks: each block writes its
// f32 partial tile, and a second kernel adds the partials in chunk order
// and applies the epilogue.  The epilogues (K1, K3, K4: T(y) and the
// statistics of the f32 sum; K2: T(y + skip), the residual added to the
// complete f32 sum and rounded once; the dgrads of K5, K6 and K7: the ReLU
// mask, T(dP) and the BatchNorm sums of the f32 dP) take per-column sums
// over each BM-row tile in a fixed order into a (2, row tiles, N) buffer
// that col_sums_kernel adds in a fixed order with 32 loads in flight per
// column.  No float atomics anywhere: two launches on the same inputs give
// the same bits.
#pragma once

#include "fu_gemm.cuh"

namespace fmma {

constexpr int THREADS = 256;
constexpr int TILE_BYTES_K = 128;  // bytes of k per shared-memory tile row
constexpr int MAX_RED = 256;       // stats scratch: WARPS_M * BN floats

enum Xform { X_RAW = 0, X_PROLOGUE = 1, X_FINALIZE = 2 };
// where k runs in device memory: K_MAJOR element (i, k) at p[i * ld + k],
// MN_MAJOR element (i, k) at p[k * ld + i]
enum Major { K_MAJOR = 0, MN_MAJOR = 1 };
// EPI_Y: K1's, K3's and K4's T(y) (+ statistics), K8's dx; EPI_DP: the
// masked T(dP) and BN sums of K5's, K6's and K7's dgrads; EPI_F32: the f32
// sum itself (the weight gradients); EPI_SKIP: K2's T(y + skip)
enum Epi { EPI_Y = 0, EPI_DP = 1, EPI_F32 = 2, EPI_SKIP = 3 };
// where an operand's elements lie (see the gathers above)
enum Gather { G_NONE = 0, G_SHIFT_K = 1, G_SHIFT_N = 2, G_OHWI = 3,
              G_SHIFT_KP = 4 };

struct Operand {
  const void* p;     // T
  const void* y;     // X_FINALIZE: y_raw, laid out as p
  const float* v0;   // per-channel f32 vectors of the transform
  const float* v1;
  const float* v2;
  int ld;            // row stride of p, elements
  int gc, H, W;      // gathers: channels of one tap; the images' H and W
};

struct Gemm {
  Operand a, b;
  void* out;         // EPI_Y: y (M, N) T; EPI_DP: dP (M, N) T; EPI_F32: f32
  float* ws;         // (splits, M, N) f32 partials when splits > 1
  float* spart;      // (2, row tiles, N) f32 statistics partials
  const void* x;     // EPI_DP: raw conv input (M, N) T
  const void* skip;  // EPI_SKIP: the residual (M, N) T
  const float* sc;   // EPI_DP: prologue scale / shift, xhat = x * xs + xh
  const float* sh;
  const float* xs;
  const float* xh;
  int M, N, K, chunk, splits, stats;
};

template <typename T>
struct Ty {
  static constexpr int BK = TILE_BYTES_K / sizeof(T);  // k per tile
  static constexpr int KS = 32 / sizeof(T);            // k per MMA
  static constexpr int QW = sizeof(T);                 // words per quad
};

// Shared-memory layout of one operand tile of R rows (m or n) and BK k:
// K-major as [R][BK] with rows padded to 144 bytes (ldmatrix phases hit
// eight distinct 16-byte bank groups); MN-major as [BK][R + 8] (tf32
// fragments read with word stride = 8 mod 32, bf16 with ldmatrix.trans).
template <typename T, int MAJ, int R>
struct Lay {
  static constexpr int STRIDE = MAJ == K_MAJOR
      ? Ty<T>::BK * (int)sizeof(T) + 16 : (R + 8) * (int)sizeof(T);
  static constexpr int BYTES = (MAJ == K_MAJOR ? R : Ty<T>::BK) * STRIDE;
  static constexpr int QUADS = R * Ty<T>::BK / 4;
  static constexpr int NQ = QUADS / THREADS;           // quads per thread
  static_assert(QUADS % THREADS == 0, "tile does not split into quads");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// cvt.rna.tf32.f32: the f32 bits with the low 13 cleared (on sm_90 the
// instruction clears them; tests/test_torch_kernels.py checks it against
// fused_unit._tf32 on the card)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float f, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint32_t w[Ty<T>::QW],
                                       float f[4]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = __uint_as_float(w[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      f[2 * j] = v.x;
      f[2 * j + 1] = v.y;
    }
  }
}

// round four f32 values to T and pack them
template <typename T>
__device__ __forceinline__ void pack(const float f[4],
                                     uint32_t w[Ty<T>::QW]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __float_as_uint(f[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// one quad (16 bytes of f32, 8 of bf16) into shared memory, or zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 ::"r"(dst), "l"(src), "r"(ok ? 8 : 0));
}

// a quad of QW words in shared memory, as one vector access
template <int QW>
__device__ __forceinline__ void ld_words(const unsigned char* s,
                                         uint32_t w[QW]) {
  if constexpr (QW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(s);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(s);
    w[0] = v.x; w[1] = v.y;
  }
}

template <int QW>
__device__ __forceinline__ void st_words(unsigned char* s,
                                         const uint32_t w[QW]) {
  if constexpr (QW == 4)
    *reinterpret_cast<uint4*>(s) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(s) = make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float4 ld_vec4(const float* p, int ch) {
  return __ldg(reinterpret_cast<const float4*>(p + ch));
}

// n / d by one multiply-high with m = ceil(2^32 / d) (0 for d = 1), exact
// while n * d < 2^32, which the wrappers check
struct Div {
  int d;
  unsigned m;
  __device__ __forceinline__ void set(int dd) {
    d = dd;
    m = dd > 1 ? 0xFFFFFFFFu / (unsigned)dd + 1u : 0u;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return m ? (int)__umulhi((unsigned)n, m) : n;
  }
};

// the image-edge bits of a pixel: h == 0, h == H - 1, w == 0, w == W - 1
__device__ __forceinline__ unsigned edge_bits(int h, int w, int H, int W) {
  return (unsigned)(h == 0) | (unsigned)(h == H - 1) << 1
         | (unsigned)(w == 0) << 2 | (unsigned)(w == W - 1) << 3;
}

// One landed quad rewritten in place at s: its four values (words w, and
// y_raw's words yw for X_FINALIZE) through the transform at the channel
// vectors v0..v2, zeros where !valid, then rounded to T (bf16) or split
// into tf32 hi (at s) and lo (at s + plane) (f32).
template <typename T, int X>
__device__ __forceinline__ void rewrite_quad(unsigned char* s, int plane,
                                             uint32_t (&w)[Ty<T>::QW],
                                             const uint32_t (&yw)[Ty<T>::QW],
                                             const float (&v0)[4],
                                             const float (&v1)[4],
                                             const float (&v2)[4],
                                             bool valid) {
  constexpr int QW = Ty<T>::QW;
  float f[4];
  unpack<T>(w, f);
  if constexpr (X == X_PROLOGUE) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = fmaxf(__fadd_rn(__fmul_rn(f[j], v0[j]), v1[j]), 0.f);
  } else if constexpr (X == X_FINALIZE) {
    float y[4];
    unpack<T>(yw, y);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __fadd_rn(__fadd_rn(__fmul_rn(v0[j], f[j]), v1[j]),
                       __fmul_rn(v2[j], y[j]));
  }
  if (!valid) {
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = 0.f;
  }
  if constexpr (sizeof(T) == 4) {
    uint32_t lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(f[j], w[j], lo[j]);
    st_words<QW>(s + plane, lo);
  } else {
    pack<T>(f, w);
  }
  st_words<QW>(s, w);
}

// One operand tile, NQ quads of four consecutive elements per thread.
// In a stage the operand has one or two planes: f32 keeps tf32 hi and lo
// (the raw value, and y_raw for X_FINALIZE, land in them first); bf16 the
// value, and y_raw beside it for X_FINALIZE.  `issue` starts the copies of
// a tile (zeros past the edges) into ring slot `slot` of the tiles in
// flight; `transform` rewrites this thread's own quads of the oldest landed
// tile in place: the operand's transform and rounding, then for f32 the
// split into hi and lo, once per element.  A thread's quads lie STEP smem
// rows apart: rows of the tile (K-major) or k (MN-major).  `rows` is M or
// N, [k0, kend) the block's k range, G the operand's gather.
template <typename T, int MAJ, int X, int R, int G = G_NONE>
struct Loader {
  using L = Lay<T, MAJ, R>;
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int QW = Ty<T>::QW;
  static constexpr int QB = 4 * (int)sizeof(T);       // bytes per quad
  static constexpr int PLANES = F32 || X == X_FINALIZE ? 2 : 1;
  static constexpr int BYTES = PLANES * L::BYTES;
  static constexpr bool REWRITE = F32 || X != X_RAW;
  // quads per smem row: along k (K-major) or along the tile's rows
  static constexpr int QPR = MAJ == K_MAJOR ? Ty<T>::BK / 4 : R / 4;
  static constexpr int STEP = THREADS / QPR;
  static_assert(THREADS % QPR == 0, "quads per row");

  static constexpr int NV = X == X_RAW ? 0 : X == X_PROLOGUE ? 2 : 3;
  // the K-major tap gathers (K6's dgrad, K3), and those that test the
  // image, and so carry each quad's validity
  static constexpr bool KSHIFT = G == G_SHIFT_K || G == G_SHIFT_KP;
  static constexpr bool SHIFT = KSHIFT || G == G_SHIFT_N;
  static_assert(G == G_NONE || KSHIFT == (MAJ == K_MAJOR),
                "G_SHIFT_K(P) gather a K-major operand, the others MN-major");
  static_assert(!SHIFT || L::NQ <= 8, "a tile's validity bits fill a byte");

  const int a, b;   // smem row of quad 0, and its element within the row
  // the transform's vectors at this thread's four channels: those of the
  // next tile (K-major, fetched a tile ahead) or of its rows (MN-major)
  float4 vec[NV > 0 ? NV : 1];
  Div byc, byw, byh;     // gathers: division by gc, W and H
  unsigned edges = 0;    // KSHIFT: edge_bits of each of its rows, 4 a row
  unsigned pend = 0;     // SHIFT: each tile in flight's quad validity, a
                         // byte per ring slot, the oldest lowest
  int c = 0, th = 0, tw = 0, shift = 0;   // G_SHIFT_N: this thread's column
                         // (t, c): c, the tap's dh and dw, and dh * W + dw

  __device__ __forceinline__ explicit Loader(int tid)
      : a(tid / QPR), b((tid % QPR) * 4) {}

  // what a gather knows once a block: the divisors, and the pixels of a
  // K-major thread's rows (KSHIFT) or the tap of an MN-major thread's
  // column (G_SHIFT_N)
  __device__ __forceinline__ void setup(const Operand& o, int row0) {
    if constexpr (G != G_NONE) byc.set(o.gc);
    if constexpr (SHIFT) {
      byw.set(o.W);
      byh.set(o.H);
    }
    if constexpr (KSHIFT) {
#pragma unroll
      for (int i = 0; i < L::NQ; ++i) {
        const int m = row0 + a + i * STEP, q = byw(m);
        edges |= edge_bits(q - byh(q) * o.H, m - q * o.W, o.H, o.W) << 4 * i;
      }
    }
    if constexpr (G == G_SHIFT_N) {
      const int n = row0 + b, t = byc(n);
      c = n - t * o.gc;
      th = t / 3 - 1;
      tw = t % 3 - 1;
      shift = th * o.W + tw;
    }
  }

  // the vectors of the tile at k0 (K-major), or of the block's rows
  __device__ __forceinline__ void fetch_vecs(const Operand& o, int row0,
                                             int rows, int k0, int kend) {
    int ch = MAJ == K_MAJOR ? k0 + b : row0 + b;
    const bool v = MAJ == K_MAJOR ? ch < kend : ch < rows;
    if constexpr (KSHIFT) ch -= byc(ch) * o.gc;
    if constexpr (G == G_SHIFT_N) ch = c;
    const float* src[3] = {o.v0, o.v1, o.v2};
#pragma unroll
    for (int j = 0; j < NV; ++j)
      vec[j] = v ? ld_vec4(src[j], ch) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ int at(int i) const {
    return (a + i * STEP) * L::STRIDE + b * (int)sizeof(T);
  }
  __device__ __forceinline__ bool ok(int i, int row0, int rows, int k0,
                                     int kend) const {
    return MAJ == K_MAJOR
        ? row0 + a + i * STEP < rows && k0 + b < kend
        : k0 + a + i * STEP < kend && row0 + b < rows;
  }

  __device__ __forceinline__ void issue(const Operand& o, int row0, int rows,
                                        int k0, int kend, unsigned char* s,
                                        int slot) {
    const T* src = static_cast<const T*>(o.p);
    const T* ysrc = static_cast<const T*>(o.y);
    long long base = MAJ == K_MAJOR
        ? (long long)(row0 + a) * o.ld + k0 + b
        : (long long)(k0 + a) * o.ld + row0 + b;
    unsigned forbid = 0, bits = 0;
    if constexpr (KSHIFT) {
      // every quad of this thread is at k0 + b: one tap, one shift (sh,
      // sw), the source pixel's offset from the output pixel: -(dh, dw) in
      // K6's dgrad, +(dh, dw) in K3
      const int k = k0 + b, t = byc(k), sg = G == G_SHIFT_K ? -1 : 1;
      const int sh = sg * (t / 3 - 1), sw = sg * (t % 3 - 1);
      base = (long long)(row0 + a + sh * o.W + sw) * o.ld + k - t * o.gc;
      forbid = (unsigned)(sh < 0) | (unsigned)(sh > 0) << 1
               | (unsigned)(sw < 0) << 2 | (unsigned)(sw > 0) << 3;
    }
#pragma unroll
    for (int i = 0; i < L::NQ; ++i) {
      bool v = ok(i, row0, rows, k0, kend);
      long long off = base + (long long)i * STEP * o.ld;
      if constexpr (KSHIFT) v = v && !((edges >> 4 * i) & forbid);
      if constexpr (G == G_SHIFT_N) {
        const int r = k0 + a + i * STEP, q = byw(r);
        const int h = q - byh(q) * o.H, w = r - q * o.W;
        v = v && (unsigned)(h + th) < (unsigned)o.H
            && (unsigned)(w + tw) < (unsigned)o.W;
        off = (long long)(r + shift) * o.ld + c;
      }
      if constexpr (G == G_OHWI) {
        const int k = k0 + a + i * STEP, t = byc(k);
        off = ((long long)(k - t * o.gc) * 9 + t) * o.ld + row0 + b;
      }
      if (!v) off = 0;
      cp_async<QB>(smem_u32(s + at(i)), src + off, v);
      if constexpr (X == X_FINALIZE)
        cp_async<QB>(smem_u32(s + L::BYTES + at(i)), ysrc + off, v);
      bits |= (unsigned)v << i;
    }
    if constexpr (SHIFT) pend |= bits << 8 * slot;
  }

  __device__ __forceinline__ void transform(const Operand& o, int row0,
                                            int rows, int k0, int kend,
                                            unsigned char* s) {
    // the validity `issue` found for this tile's quads (SHIFT)
    const unsigned okb = pend;
    if constexpr (SHIFT) pend >>= 8;
    if constexpr (REWRITE) {
      // every quad is read before the first is written back: the
      // compiler cannot move a shared-memory load past a store that might
      // alias it, so interleaving them would run the quads one by one
      uint32_t w[L::NQ][QW], yw[X == X_FINALIZE ? L::NQ : 1][QW];
#pragma unroll
      for (int i = 0; i < L::NQ; ++i) {
        ld_words<QW>(s + at(i), w[i]);
        if constexpr (X == X_FINALIZE) ld_words<QW>(s + L::BYTES + at(i),
                                                    yw[i]);
      }
      const float v0[4] = {vec[0].x, vec[0].y, vec[0].z, vec[0].w};
      const float v1[4] = {vec[NV > 1 ? 1 : 0].x, vec[NV > 1 ? 1 : 0].y,
                           vec[NV > 1 ? 1 : 0].z, vec[NV > 1 ? 1 : 0].w};
      const float v2[4] = {vec[NV - 1 > 0 ? NV - 1 : 0].x,
                           vec[NV - 1 > 0 ? NV - 1 : 0].y,
                           vec[NV - 1 > 0 ? NV - 1 : 0].z,
                           vec[NV - 1 > 0 ? NV - 1 : 0].w};
#pragma unroll
      for (int i = 0; i < L::NQ; ++i)
        rewrite_quad<T, X>(s + at(i), L::BYTES, w[i],
                           yw[X == X_FINALIZE ? i : 0], v0, v1, v2,
                           SHIFT ? ((okb >> i) & 1u) != 0
                                 : ok(i, row0, rows, k0, kend));
    }
  }
};

// A fragments (4 words) of the m16 tile at row m0, k step ks
template <typename T, int MAJ, int R>
__device__ __forceinline__ void frag_a(const unsigned char* s, int m0,
                                       int ks, int lane, uint32_t a[4]) {
  using L = Lay<T, MAJ, R>;
  if constexpr (MAJ == K_MAJOR) {
    ldsm_x4(a, smem_u32(s + (m0 + (lane & 15)) * L::STRIDE + ks * 32
                        + (lane >> 4) * 16));
  } else if constexpr (sizeof(T) == 2) {
    ldsm_x4_t(a, smem_u32(s + (ks * 16 + (lane & 7) + ((lane >> 4) << 3))
                              * L::STRIDE
                          + (m0 + ((lane >> 3) & 1) * 8) * 2));
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s);
    constexpr int S = L::STRIDE / 4;
    const int g = lane >> 2, t = lane & 3;
    const int k = ks * 8 + t;
    a[0] = w[k * S + m0 + g];
    a[1] = w[k * S + m0 + g + 8];
    a[2] = w[(k + 4) * S + m0 + g];
    a[3] = w[(k + 4) * S + m0 + g + 8];
  }
}

// B fragments of the two n8 tiles at n0 and n0 + 8, k step ks:
// b[0], b[1] for the first, b[2], b[3] for the second
template <typename T, int MAJ, int R>
__device__ __forceinline__ void frag_b2(const unsigned char* s, int n0,
                                        int ks, int lane, uint32_t b[4]) {
  using L = Lay<T, MAJ, R>;
  if constexpr (MAJ == K_MAJOR) {
    ldsm_x4(b, smem_u32(s + (n0 + (lane & 7) + ((lane >> 4) << 3))
                                * L::STRIDE
                        + ks * 32 + ((lane >> 3) & 1) * 16));
  } else if constexpr (sizeof(T) == 2) {
    ldsm_x4_t(b, smem_u32(s + (ks * 16 + (lane & 7)
                               + (((lane >> 3) & 1) << 3)) * L::STRIDE
                          + (n0 + ((lane >> 4) << 3)) * 2));
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s);
    constexpr int S = L::STRIDE / 4;
    const int g = lane >> 2, t = lane & 3;
    const int k = ks * 8 + t;
    b[0] = w[k * S + n0 + g];
    b[1] = w[(k + 4) * S + n0 + g];
    b[2] = w[k * S + n0 + 8 + g];
    b[3] = w[(k + 4) * S + n0 + 8 + g];
  }
}

// two adjacent values (c, c + 1) of T as f32, and their store
template <typename T>
__device__ __forceinline__ float2 ld_pair(const void* p, size_t off) {
  if constexpr (sizeof(T) == 4)
    return *reinterpret_cast<const float2*>(static_cast<const float*>(p)
                                            + off);
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(p) + off));
}

template <typename T>
__device__ __forceinline__ void st_pair(void* out, size_t off, float v0,
                                        float v1) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
        make_float2(v0, v1);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out)
                                       + off) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// The epilogue of output element (r, c) with input xv (EPI_DP: the raw
// conv input; EPI_SKIP: the residual): returns the value to store and adds
// its statistics (EPI_Y: v, v^2; EPI_DP: dP, dP * xhat, with dP = v masked
// by the recomputed ReLU; EPI_SKIP: none).
template <int EPI>
__device__ __forceinline__ float epi(const Gemm& p, int c, float xv, float v,
                                     float& s, float& ss) {
  if constexpr (EPI == EPI_SKIP) {
    v = __fadd_rn(v, xv);
  } else if constexpr (EPI == EPI_DP) {
    const float a32 =
        fmaxf(__fadd_rn(__fmul_rn(xv, p.sc[c]), p.sh[c]), 0.f);
    v = a32 > 0.f ? v : 0.f;
    const float xhat = __fadd_rn(__fmul_rn(xv, p.xs[c]), p.xh[c]);
    s += v;
    ss += __fmul_rn(v, xhat);
  } else {
    s += v;
    ss += v * v;
  }
  return v;
}

// The eight warps of a BM x BN block tile: WARPS_M x WARPS_N warps of
// MT x NT m16n8 fragments each (128 x 128: 2 x 4 warps of 64 x 32; 128 x
// 64: 4 x 2 of 32 x 32; 64 x 128: 2 x 4 of 32 x 32).
template <int BM, int BN>
struct WarpTiling {
  static constexpr int WARPS_M = (BM == 128 && BN == 128) ? 2
                                 : (BM == 128 ? 4 : 2);
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
};

// One pass of m16n8k8 tf32 MMAs over a warp tile: acc[i][j] += a[i] b[j].
// A k step of 3xTF32 is three passes, a_lo b_hi, a_hi b_lo, a_hi b_hi in
// that order (neighbouring MMAs independent), with each operand's
// fragments loaded just before its first pass so that three of the four
// fragment sets are live at once.
template <int MT, int NT>
__device__ __forceinline__ void mma_pass(float (&acc)[MT][NT][4],
                                         const uint32_t (&a)[MT][4],
                                         const uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i], b[j][0], b[j][1]);
}

template <int MT, int NT>
__device__ __forceinline__ void zero_frags(float (&f)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) f[i][j][q] = 0.f;
}

// f32 promotion (see the top of this file): a k tile's partial into the
// accumulator, rounded to nearest
template <int MT, int NT>
__device__ __forceinline__ void promote(float (&acc)[MT][NT][4],
                                        const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[i][j][q] = __fadd_rn(acc[i][j][q], part[i][j][q]);
}

// Stages of the shared-memory ring: as many (4, 3 or 2) as let two blocks
// share an SM, and never fewer than two.
template <typename T, int BM, int BN, int AMAJ, int AX, int BMAJ, int BX>
struct Ring {
  static constexpr int A = Loader<T, AMAJ, AX, BM>::BYTES;
  static constexpr int STAGE = A + Loader<T, BMAJ, BX, BN>::BYTES;
  static constexpr int LIMIT = 104 * 1024;
  static constexpr int NS = 4 * STAGE <= LIMIT ? 4
                            : 3 * STAGE <= LIMIT ? 3 : 2;
  static constexpr int BYTES = NS * STAGE;
};

// Per-column sums over the block's BM rows, in a fixed order: the warp's
// 16 row groups by shuffles, then the WARPS_M warps in order, into the
// block's row of p.spart.
template <int BN, int WARPS_M, int WARPS_N, int NT>
__device__ __forceinline__ void stats_tile(const Gemm& p,
                                           const float (&cs)[NT][2],
                                           const float (&css)[NT][2],
                                           int warp, int g, int tq, int wn0,
                                           int n0) {
  __shared__ float red[2][MAX_RED];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s = cs[j][q], ss = css[j][q];
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, sh);
        ss += __shfl_xor_sync(0xffffffffu, ss, sh);
      }
      if (g == 0) {
        const int col = wn0 + j * 8 + 2 * tq + q;
        red[0][(warp / WARPS_N) * BN + col] = s;
        red[1][(warp / WARPS_N) * BN + col] = ss;
      }
    }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < 2 * BN) {
    const int which = tid / BN, col = tid % BN;
    if (n0 + col < p.N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS_M; ++w) s += red[which][w * BN + col];
      p.spart[((size_t)which * gridDim.y + blockIdx.y) * p.N + n0 + col] = s;
    }
  }
}

// The epilogue of a block's BM x BN output tile at (m0, n0), held as
// m16n8 fragments acc[MT][NT] by each warp at (wm0, wn0): the f32
// partial of split blockIdx.z (EPI_F32, or any split plan), else T(y),
// T(y + skip) or the masked T(dP), with their statistics into p.spart (row
// tile blockIdx.y).  Shared by mma_kernel and the halo loop (fu_halo.cuh).
template <typename T, int BM, int BN, int EPI, int WARPS_M, int WARPS_N,
          int MT, int NT>
__device__ __forceinline__ void tile_epilogue(const Gemm& p,
                                              const float (&acc)[MT][NT][4],
                                              int m0, int n0, int wm0,
                                              int wn0, int warp, int lane) {
  // fragment (i, j) holds rows g, g + 8 and columns 2t, 2t + 1
  const int g = lane >> 2, tq = lane & 3;
  constexpr bool STATS = EPI == EPI_Y || EPI == EPI_DP;
  constexpr bool READS = EPI == EPI_DP || EPI == EPI_SKIP;
  const bool partial = EPI == EPI_F32 || p.splits > 1;
  const bool stats = STATS && !partial && (EPI == EPI_DP || p.stats);
  const void* in = EPI == EPI_DP ? p.x : p.skip;
  float* pout = EPI == EPI_F32 && p.splits == 1 ? static_cast<float*>(p.out)
                                                : p.ws;
  pout += (size_t)blockIdx.z * p.M * p.N;
  float cs[NT][2], css[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    cs[j][0] = cs[j][1] = css[j][0] = css[j][1] = 0.f;
  // EPI_DP reads the raw input, EPI_SKIP the residual, at every output
  // element: a row block's loads are issued before its first store (which
  // the compiler could not move them past), so they are in flight together
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float2 xin[2][NT];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = m0 + wm0 + i * 16 + g + 8 * h;
        const int c = n0 + wn0 + j * 8 + 2 * tq;
        xin[h][j] = READS && !partial && r < p.M && c < p.N
            ? ld_pair<T>(in, (size_t)r * p.N + c) : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm0 + i * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = n0 + wn0 + j * 8 + 2 * tq;
        if (r >= p.M || c >= p.N) continue;   // N % 4 == 0: c + 1 < N too
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        const size_t off = (size_t)r * p.N + c;
        if (partial) {
          *reinterpret_cast<float2*>(pout + off) = make_float2(v0, v1);
        } else {
          if constexpr (EPI != EPI_F32) {
            v0 = epi<EPI>(p, c, xin[h][j].x, v0, cs[j][0], css[j][0]);
            v1 = epi<EPI>(p, c + 1, xin[h][j].y, v1, cs[j][1], css[j][1]);
          }
          st_pair<T>(p.out, off, v0, v1);
        }
      }
    }
  }
  if constexpr (STATS) {
    if (!stats) return;   // uniform over the block
    stats_tile<BN, WARPS_M, WARPS_N, NT>(p, cs, css, warp, g, tq, wn0, n0);
  }
}

template <typename T, int BM, int BN, int AMAJ, int AX, int BMAJ, int BX,
          int EPI, int AG, int BG>
__global__ void __launch_bounds__(THREADS, 2)
mma_kernel(const __grid_constant__ Gemm p) {
  using WT = WarpTiling<BM, BN>;
  constexpr int WARPS_M = WT::WARPS_M, WARPS_N = WT::WARPS_N;
  constexpr int WTM = WT::WTM, WTN = WT::WTN, MT = WT::MT, NT = WT::NT;
  constexpr int BK = Ty<T>::BK, KSTEPS = BK / Ty<T>::KS;
  constexpr bool F32 = sizeof(T) == 4;
  using RG = Ring<T, BM, BN, AMAJ, AX, BMAJ, BX>;
  using LdA = Loader<T, AMAJ, AX, BM, AG>;
  using LdB = Loader<T, BMAJ, BX, BN, BG>;
  constexpr int NS = RG::NS;
  constexpr int PA = Lay<T, AMAJ, BM>::BYTES;   // hi to lo plane
  constexpr int PB = Lay<T, BMAJ, BN>::BYTES;
  static_assert(NT % 2 == 0 && WARPS_M * BN <= MAX_RED, "warp tiling");

  extern __shared__ __align__(128) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * WTM, wn0 = (warp % WARPS_N) * WTN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.K, kbeg + p.chunk);
  const int ntiles = (kend - kbeg + BK - 1) / BK;
  LdA lda(tid);
  LdB ldb(tid);
  lda.setup(p.a, m0);
  ldb.setup(p.b, n0);
  lda.fetch_vecs(p.a, m0, p.M, kbeg, kend);
  ldb.fetch_vecs(p.b, n0, p.N, kbeg, kend);

  // tile t into its stage; `slot` is its place among the tiles in flight
  auto issue = [&](int t, int slot) {
    unsigned char* st = ring + (t % NS) * RG::STAGE;
    const int k0 = kbeg + t * BK;
    lda.issue(p.a, m0, p.M, k0, kend, st, slot);
    ldb.issue(p.b, n0, p.N, k0, kend, st + RG::A, slot);
  };

  float acc[MT][NT][4];
  zero_frags(acc);

#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) issue(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    unsigned char* st = ring + (t % NS) * RG::STAGE;
    const unsigned char* sa = st;
    const unsigned char* sb = st + RG::A;
    // this thread's copies of tile t have landed: rewrite them in place
    cp_async_wait<NS - 2>();
    const int k0 = kbeg + t * BK;
    lda.transform(p.a, m0, p.M, k0, kend, st);
    ldb.transform(p.b, n0, p.N, k0, kend, st + RG::A);
    // every thread's tile t is in place, and every thread is done with
    // tile t - 1, whose stage the next copies overwrite
    __syncthreads();
    if (t + NS - 1 < ntiles) issue(t + NS - 1, NS - 2);
    cp_async_commit();
    // the next tile's K-major vectors load while this tile is multiplied
    if constexpr (AMAJ == K_MAJOR && AX != X_RAW)
      lda.fetch_vecs(p.a, m0, p.M, k0 + BK, kend);
    if constexpr (BMAJ == K_MAJOR && BX != X_RAW)
      ldb.fetch_vecs(p.b, n0, p.N, k0 + BK, kend);
    float part[MT][NT][4];   // f32: this k tile's sum (promotion)
    if constexpr (F32) zero_frags(part);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // f32: b_hi and a_lo, the first pass; then b_lo and a_hi in a_lo's
      // registers (mma_pass)
      const auto load_b = [&](const unsigned char* s, uint32_t (&f)[NT][2]) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          frag_b2<T, BMAJ, BN>(s, wn0 + j * 8, ks, lane, b);
#pragma unroll
          for (int q = 0; q < 4; ++q) f[j + q / 2][q & 1] = b[q];
        }
      };
      uint32_t bh[NT][2];
      load_b(sb, bh);
      if constexpr (F32) {
        uint32_t a[MT][4], bl[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          frag_a<T, AMAJ, BM>(sa + PA, wm0 + i * 16, ks, lane, a[i]);
        mma_pass(part, a, bh);
        load_b(sb + PB, bl);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          frag_a<T, AMAJ, BM>(sa, wm0 + i * 16, ks, lane, a[i]);
        mma_pass(part, a, bl);
        mma_pass(part, a, bh);
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t ah[4];
          frag_a<T, AMAJ, BM>(sa, wm0 + i * 16, ks, lane, ah);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
    if constexpr (F32) promote(acc, part);
  }

  tile_epilogue<T, BM, BN, EPI, WARPS_M, WARPS_N, MT, NT>(p, acc, m0, n0,
                                                        wm0, wn0, warp,
                                                        lane);
}

// The split-K epilogue: out = epilogue(sum_z ws[z]) in z order, with the
// statistics of each `rows`-row tile (the GEMM's BM) into p.spart.  Block:
// 16 columns x 16 row lanes, each lane every 16th row of the tile, the
// lanes' sums added in lane order.
template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS)
split_epi_kernel(const __grid_constant__ Gemm p, int rows) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int c = blockIdx.x * 16 + tx;
  const int r0 = blockIdx.y * rows, r1 = min(p.M, r0 + rows);
  const size_t mn = (size_t)p.M * p.N;
  float s = 0.f, ss = 0.f;
  if (c < p.N) {
    for (int r = r0 + ty; r < r1; r += 16) {
      const size_t off = (size_t)r * p.N + c;
      float v = 0.f;
      for (int z = 0; z < p.splits; ++z) v += p.ws[z * mn + off];
      const float xv =
          EPI == EPI_DP ? fu::to_f(static_cast<const T*>(p.x)[off])
          : EPI == EPI_SKIP ? fu::to_f(static_cast<const T*>(p.skip)[off])
          : 0.f;
      v = epi<EPI>(p, c, xv, v, s, ss);
      static_cast<T*>(p.out)[off] = fu::from_f<T>(v);
    }
  }
  if (!(EPI == EPI_DP || (EPI == EPI_Y && p.stats))) return;
  __shared__ float red[2][16][16];
  red[0][ty][tx] = s;
  red[1][ty][tx] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int which = threadIdx.x >> 4;
    const int col = blockIdx.x * 16 + tx;
    if (col < p.N) {
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) t += red[which][q][tx];
      p.spart[((size_t)which * gridDim.y + blockIdx.y) * p.N + col] = t;
    }
  }
}

// s[c] = sum_b part[0][b][c] and ss[c] = sum_b part[1][b][c] over the nrb
// row tiles: 32 lanes each add every 32nd row tile in order, then the
// lanes' sums are added in lane order, a fixed order with 32 loads in
// flight per column.  Block: 8 columns x 32 lanes; grid (columns / 8, 2).
static __global__ void __launch_bounds__(THREADS)
col_sums_kernel(const float* __restrict__ part, float* __restrict__ s,
                float* __restrict__ ss, int nrb, int N) {
  const int tx = threadIdx.x & 7, lane = threadIdx.x >> 3;
  const int c = blockIdx.x * 8 + tx;
  const float* src = part + (size_t)blockIdx.y * nrb * N;
  float a = 0.f;
  if (c < N)
    for (int b = lane; b < nrb; b += 32) a += src[(size_t)b * N + c];
  __shared__ float red[32][8];
  red[lane][tx] = a;
  __syncthreads();
  if (threadIdx.x < 8 && blockIdx.x * 8 + threadIdx.x < N) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < 32; ++q) t += red[q][threadIdx.x];
    (blockIdx.y ? ss : s)[blockIdx.x * 8 + threadIdx.x] = t;
  }
}

// the statistics partials of a GEMM on bm-row tiles added into s, ss
static int col_sums(const Gemm& p, int bm, float* s, float* ss,
                    cudaStream_t st) {
  const dim3 grid((p.N + 7) / 8, 2);
  col_sums_kernel<<<grid, THREADS, 0, st>>>(p.spart, s, ss,
                                            (p.M + bm - 1) / bm, p.N);
  return (int)cudaGetLastError();
}

// static: internal linkage keeps `sized` to this library (a function
// static of a template with external linkage is one object in the whole
// process, shared by every library that instantiates it)
template <typename T, int BM, int BN, int AMAJ, int AX, int BMAJ, int BX,
          int EPI, int AG, int BG>
static int launch_tile(const Gemm& p, cudaStream_t st) {
  using RG = Ring<T, BM, BN, AMAJ, AX, BMAJ, BX>;
  auto kern = mma_kernel<T, BM, BN, AMAJ, AX, BMAJ, BX, EPI, AG, BG>;
  static bool sized = false;   // once per instantiation (one device)
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, RG::BYTES);
    // the whole of the SM's 228 KB as shared memory, so that two blocks
    // fit (the default carveout leaves room for one)
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.splits);
  kern<<<grid, THREADS, RG::BYTES, st>>>(p);
  return (int)cudaGetLastError();
}

// The GEMM on a (bm, bn) tile; an unknown tile is cudaErrorInvalidValue.
template <typename T, int AMAJ, int AX, int BMAJ, int BX, int EPI, int AG,
          int BG>
static int launch_any(const Gemm& p, int bm, int bn, cudaStream_t st) {
  // f32 plans and weight gradients take no 128 x 128 tile
  if constexpr (sizeof(T) == 2 && EPI != EPI_F32) {
    if (bm == 128 && bn == 128)
      return launch_tile<T, 128, 128, AMAJ, AX, BMAJ, BX, EPI, AG, BG>(p,
                                                                       st);
  }
  if (bm == 128 && bn == 64)
    return launch_tile<T, 128, 64, AMAJ, AX, BMAJ, BX, EPI, AG, BG>(p, st);
  if (bm == 64 && bn == 128)
    return launch_tile<T, 64, 128, AMAJ, AX, BMAJ, BX, EPI, AG, BG>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The GEMM with p.splits chunks of p.chunk k, then, when split, the ordered
// split reduction (EPI_F32) or split epilogue; AG and BG are the operands'
// gathers.  Returns the first launch error.
template <typename T, int AMAJ, int AX, int BMAJ, int BX, int EPI,
          int AG = G_NONE, int BG = G_NONE>
static int gemm(const Gemm& p, int bm, int bn, cudaStream_t st) {
  const int err = launch_any<T, AMAJ, AX, BMAJ, BX, EPI, AG, BG>(p, bm, bn,
                                                                 st);
  if (err != cudaSuccess || p.splits == 1) return err;
  if constexpr (EPI == EPI_F32) {
    const size_t n = (size_t)p.M * p.N;
    fu::split_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        p.ws, static_cast<float*>(p.out), p.splits, n);
  } else {
    const dim3 grid((p.N + 15) / 16, (p.M + bm - 1) / bm);
    split_epi_kernel<T, EPI><<<grid, THREADS, 0, st>>>(p, bm);
  }
  return (int)cudaGetLastError();
}

}  // namespace fmma
