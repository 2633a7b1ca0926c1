// The loops of K4 (fu_c3_fwd4d.cu) and K7 (fu_c3_bwd4d.cu): the fused
// unit's 3x3 / stride 1 / pad 1 convolution, forward and backward, on the
// tensor cores, with the operand that the nine taps share resident in
// shared memory.
//
// K3 and K6 (fu_c3_fwd2d.cu, fu_c3_bwd2d.cu) compute the same functions on
// fu_mma.cuh's loop, k = (tap, channel): every tap gathers, transforms and
// splits its own copy of the shared operand, about nine times per source
// element.  Here the operand is staged once per band of pixels and channel
// chunk: a band of `band` consecutive pixels of the (n, h, w) row layout
// (crossing image rows and images) needs the rows [r0 - W - 1, r0 + band +
// W + 1) for all nine taps (one window of band + 2W + 2 rows), or, where W
// > band + 2, three windows of band + 2 rows, one per tap row.  Each tap's
// fragments are read out of that halo at rows shifted by its offset:
// ldmatrix takes one row address per lane and the tf32 LDS.32 loads one
// address each, so a lane whose pixel's neighbour for this tap lies off the
// image reads a zero row instead (the pixel's image-edge bits, as
// fu_mma.cuh's gathers test them).  The zero padding is thus applied after
// the transform, as the reference pads (neither finalize(0) nor relu(sh) is
// zero), and the band wastes no rows at any image size.
//
//   conv   one loop, two directions (conv_kernel):
//          fwd    y (R, Co) = sum_t shift_t(act(x)) (R, Ci) @ w_t^T (K4);
//          dgrad  dP (R, Ci) = mask(sum_t shift_t(fin(g)) (R, Co) @ w_t)
//                 (K7).
//          A block owns a BM x BN tile (BM pixels x BN output channels of
//          the product) and walks k = (chunk of one 128-byte tile of the
//          summed channels, tap): per chunk it stages the halo K-major
//          ([pixel][channel], f32 hi and lo planes) through the transform
//          (the prologue act(x) forward, the finalize fin(g) in the
//          dgrad), then nine k tiles, one per tap, each with its OHWI
//          weight slice streamed through fu_mma.cuh's cp.async ring (the
//          forward reads w as a K-major (Co, 9 Ci) operand, the dgrad as
//          an MN-major one through G_OHWI) and its A fragments from the
//          halo at row m + (dh W + dw) forward, m - (dh W + dw) in the
//          dgrad; the epilogue is fu_mma.cuh's EPI_Y forward (T(y), the
//          statistics of the f32 sum) and EPI_DP in the dgrad (ReLU mask,
//          T(dP), BatchNorm sums of the f32 dP), per row tile in a fixed
//          order, split over the summed channels' chunks by the same plan
//          rules as mma_plan (ops/_cuda.py halo_fwd_plan,
//          halo_dgrad_plan);
//   wgrad  dW[o, t, i] = sum_p fin(g)[p, o] * act(x)[p + dh W + dw, i]:
//          a block of nine warps, one a tap, owns 32 o x 32 i x 9 taps and
//          walks bands of pixels: per band it stages fin(g) (band x 32 o)
//          and the activation halo (halo rows x 32 i) through their
//          transforms, and each warp multiplies the same g tile by the
//          halo at its tap's offset (MN-major fragments, k = pixel); the
//          sum over pixels is cut into chunks fixed by the shapes (ops/
//          _cuda.py halo_wgrad_plan) and added in chunk order by
//          fu::split_reduce_kernel; dW keeps the OHWI (Co, 3, 3, Ci) f32
//          layout.
//
// Arithmetic as fu_mma.cuh: bf16 MMA, f32 through 3xTF32 with the split
// into hi and lo made once as an element is staged, each k tile (a tap of a
// 32-channel chunk; in the wgrad a band of 64 pixels) summed from zero and
// promoted into the accumulator with a round-to-nearest add.  The halo
// rows are padded so that the fragment loads of every tap shift are
// conflict-free (eight consecutive pixels hit eight bank groups; only the
// zero-row lanes at image edges may share one).  Staging and multiplying are not
// overlapped inside a block (one halo buffer: the f32 halo of a 128-pixel
// band at W = 56 is 70 KB); two blocks an SM hide each other's staging.
// On an NVIDIA H100 80GB HBM3 at 700 W (chip_mma_probe.py; PERF.md,
// Findings) a dgrad k tile takes 7-20% fewer cycles than K6's, its
// multiply phase lighter and its staging no cheaper (the weight slice's
// hi/lo split, which every block repeats, outweighs the halo); the
// wgrad's staging costs about as much as its multiply phase.
// No float atomics: two launches give the same bits.
#pragma once

#include <type_traits>

#include "fu_mma.cuh"

namespace fhalo {

using namespace fmma;

constexpr int HROW = TILE_BYTES_K + 16;   // bytes of a K-major halo row
constexpr int WTHREADS = 9 * 32;          // wgrad: one warp a tap
constexpr int WB = 32;                    // wgrad: i and o per block

// the halo of a band of `band` pixels over images W wide: 1 or 3 windows
__host__ __device__ inline int halo_windows(int band, int W) {
  return W <= band + 2 ? 1 : 3;
}
__host__ __device__ inline int halo_rows(int band, int W) {
  return halo_windows(band, W) == 1 ? band + 2 * W + 2 : 3 * (band + 2);
}

struct Halo {
  int nw, len, rows, W;
  __device__ __forceinline__ void set(int band, int w) {
    W = w;
    nw = halo_windows(band, w);
    rows = halo_rows(band, w);
    len = rows / nw;
  }
  // the halo row of source row r0 + m + sh * W + sw, sh and sw in -1..1
  __device__ __forceinline__ int row(int m, int sh, int sw) const {
    return (sh + 1) * (nw == 1 ? W : len) + 1 + m + sw;
  }
  // the source row of halo row e of the band at r0
  __device__ __forceinline__ int src(int e, int r0) const {
    if (nw == 1) return r0 - W - 1 + e;
    const int j = e / len;
    return r0 + (j - 1) * W - 1 + (e - j * len);
  }
};

// Pixel rows of an operand staged with their channels contiguous: row e of
// the tile is row src(e) of o.p, channels [ch0, ch0 + 4 QPR) at STRIDE
// bytes a row, in one plane or two `plane` bytes apart (f32: tf32 hi and
// lo; X_FINALIZE lands y_raw in the second first), as fu_mma.cuh's Loader
// stages a tile.  Each of the NT threads owns column quad q = tid % QPR of
// every (NT / QPR)-th row: `issue` starts its copies (zeros for rows
// outside [0, R) and channels from chend), `transform` rewrites them in
// place once they have landed (rewrite_quad: zeros where the copy was).
template <typename T, int X, int QPR, int NT, int STRIDE>
struct Rows {
  static constexpr int QB = 4 * (int)sizeof(T);
  static constexpr int QW = Ty<T>::QW;
  static constexpr int STEP = NT / QPR;
  static constexpr int NV = X == X_RAW ? 0 : X == X_PROLOGUE ? 2 : 3;
  static_assert(NT % QPR == 0, "a thread's quads share one column");
  const int q, r;

  __device__ __forceinline__ explicit Rows(int tid)
      : q(tid % QPR), r(tid / QPR) {}

  template <typename Src>
  __device__ __forceinline__ void issue(const Operand& o, unsigned char* s,
                                        int plane, int n, int R, int ch0,
                                        int chend, Src src) const {
    const T* p = static_cast<const T*>(o.p);
    const T* y = static_cast<const T*>(o.y);
    const int ch = ch0 + 4 * q;
    for (int e = r; e < n; e += STEP) {
      const int sr = src(e);
      const bool v = ch < chend && (unsigned)sr < (unsigned)R;
      const long long off = v ? (long long)sr * o.ld + ch : 0;
      const uint32_t d = smem_u32(s + e * STRIDE + q * QB);
      cp_async<QB>(d, p + off, v);
      if constexpr (X == X_FINALIZE) cp_async<QB>(d + plane, y + off, v);
    }
  }

  template <typename Src>
  __device__ __forceinline__ void transform(const Operand& o,
                                            unsigned char* s, int plane,
                                            int n, int R, int ch0,
                                            int chend, Src src) const {
    const int ch = ch0 + 4 * q;
    const bool cv = ch < chend;
    const float* vs[3] = {o.v0, o.v1, o.v2};
    float v[3][4] = {};
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (cv) {
        const float4 t = ld_vec4(vs[j], ch);
        v[j][0] = t.x; v[j][1] = t.y; v[j][2] = t.z; v[j][3] = t.w;
      }
    for (int e = r; e < n; e += STEP) {
      unsigned char* d = s + e * STRIDE + q * QB;
      uint32_t w[QW], yw[QW] = {};
      ld_words<QW>(d, w);
      if constexpr (X == X_FINALIZE) ld_words<QW>(d + plane, yw);
      const int sr = src(e);
      rewrite_quad<T, X>(d, plane, w, yw, v[0], v[1], v[2],
                         cv && (unsigned)sr < (unsigned)R);
    }
  }
};

// ---------------------------------------------------------------------------
// conv: the forward (K4) and the dgrad (K7)
// ---------------------------------------------------------------------------

enum Dir { FWD = 0, DGRAD = 1 };

// What the direction sets: the halo's transform (act(x) forward, fin(g) in
// the dgrad), the weight's loader (the OHWI weight as a K-major (Co, 9 Ci)
// operand forward, an MN-major ((t, o), i) one through G_OHWI in the
// dgrad), the epilogue, and the shared memory on BN-column tiles: the
// weight's two-stage ring, then the halo (rows and a zero row) in one
// plane (bf16 forward) or two (f32: tf32 hi and lo; X_FINALIZE lands
// y_raw in the second).
template <typename T, int DIR, int BN>
struct Conv {
  static constexpr int AX = DIR == FWD ? X_PROLOGUE : X_FINALIZE;
  static constexpr int BMAJ = DIR == FWD ? K_MAJOR : MN_MAJOR;
  static constexpr int EPI = DIR == FWD ? EPI_Y : EPI_DP;
  using LdB = std::conditional_t<DIR == FWD,
                                 Loader<T, K_MAJOR, X_RAW, BN>,
                                 Loader<T, MN_MAJOR, X_RAW, BN, G_OHWI>>;
  static constexpr int NS = 2;
  static constexpr int RING = NS * LdB::BYTES;
  static constexpr int HPLANES = sizeof(T) == 4 || AX == X_FINALIZE ? 2 : 1;
  __host__ __device__ static int bytes(int hrows) {
    return RING + HPLANES * (hrows + 1) * HROW;
  }
};

// p.a: the halo's operand, forward the activation (x, sc, sh; ld Ci, H,
// W), in the dgrad the cotangent (g, y_raw, c1, u0, u1; ld Co, H, W); p.b:
// the OHWI weight (forward ld 9 Ci; dgrad ld Ci, gc Co); M = R pixels, N =
// the output's channels (Co forward, Ci in the dgrad), K = the summed
// channels (Ci, Co) over [blockIdx.z * chunk, + chunk); the EPI_Y or
// EPI_DP fields as fu_mma.cuh's.
template <typename T, int DIR, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_kernel(const __grid_constant__ Gemm p) {
  using WT = WarpTiling<BM, BN>;
  constexpr int WARPS_M = WT::WARPS_M, WARPS_N = WT::WARPS_N;
  constexpr int MT = WT::MT, NT = WT::NT;
  constexpr int BK = Ty<T>::BK, KSTEPS = BK / Ty<T>::KS;
  constexpr bool F32 = sizeof(T) == 4;
  using SM = Conv<T, DIR, BN>;
  using LdB = typename SM::LdB;
  constexpr int NS = SM::NS, BMAJ = SM::BMAJ;
  constexpr int PB = Lay<T, BMAJ, BN>::BYTES;   // hi to lo plane

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WARPS_N) * WT::WTM, wn0 = (warp % WARPS_N) * WT::WTN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.K, kbeg + p.chunk);
  const int ntiles = 9 * ((kend - kbeg + BK - 1) / BK);
  Halo hg;
  hg.set(BM, p.a.W);
  unsigned char* ring = smem;
  unsigned char* halo = smem + SM::RING;
  const int plane = (hg.rows + 1) * HROW;
  // the zero row after the halo's rows, in each plane
  if (tid < SM::HPLANES * HROW / 16)
    *reinterpret_cast<uint4*>(halo + (tid / (HROW / 16)) * plane
                              + hg.rows * HROW + (tid % (HROW / 16)) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  // the image-edge bits of this lane's ldmatrix row in each m16 tile
  unsigned edges = 0;
  {
    Div byw, byh;
    byw.set(p.a.W);
    byh.set(p.a.H);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = m0 + wm0 + i * 16 + (lane & 15), q = byw(r);
      edges |= edge_bits(q - byh(q) * p.a.H, r - q * p.a.W, p.a.H, p.a.W)
               << 4 * i;
    }
  }
  Rows<T, SM::AX, BK / 4, THREADS, HROW> hs(tid);
  const auto src = [&](int e) { return hg.src(e, m0); };
  LdB ldb(tid);
  ldb.setup(p.b, n0);
  // k tile j: tap t of the channel chunk [c0, c1)
  const auto tile = [&](int j, int& t, int& c0, int& c1) {
    const int c = j / 9;
    t = j - 9 * c;
    c0 = kbeg + c * BK;
    c1 = min(c0 + BK, kend);
  };
  const auto issue_b = [&](int j) {
    int t, c0, c1;
    tile(j, t, c0, c1);
    ldb.issue(p.b, n0, p.N, t * p.K + c0, t * p.K + c1,
              ring + (j % NS) * LdB::BYTES, 0);
  };

  float acc[MT][NT][4];
  zero_frags(acc);

#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < ntiles) issue_b(j);
    cp_async_commit();
  }
  for (int j = 0; j < ntiles; ++j) {
    int t, c0, c1;
    tile(j, t, c0, c1);
    unsigned char* sb = ring + (j % NS) * LdB::BYTES;
    if (t == 0) {
      // a new channel chunk: every warp is done with the last one's halo
      if (j) __syncthreads();
      hs.issue(p.a, halo, plane, hg.rows, p.M, c0, c1, src);
      cp_async_commit();
      cp_async_wait<0>();
      hs.transform(p.a, halo, plane, hg.rows, p.M, c0, c1, src);
    } else {
      cp_async_wait<NS - 2>();
    }
    ldb.transform(p.b, n0, p.N, t * p.K + c0, t * p.K + c1, sb);
    // the halo and tile j are in place, and every warp is done with tile
    // j - 1, whose stage the next copies overwrite
    __syncthreads();
    if (j + NS - 1 < ntiles) issue_b(j + NS - 1);
    cp_async_commit();
    // tap t reads its operand at pixel (h + sh, w + sw), (sh, sw) = (dh,
    // dw) forward and -(dh, dw) in the dgrad: the halo at row m + (sh W +
    // sw), or the zero row where that pixel is off the image
    const int sg = DIR == FWD ? 1 : -1;
    const int sh = sg * (t / 3 - 1), sw = sg * (t % 3 - 1);
    const unsigned forbid = (unsigned)(sh < 0) | (unsigned)(sh > 0) << 1
                            | (unsigned)(sw < 0) << 2
                            | (unsigned)(sw > 0) << 3;
    uint32_t arow[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = wm0 + i * 16 + (lane & 15);
      const int row = (edges >> 4 * i) & forbid ? hg.rows
                                                : hg.row(m, sh, sw);
      arow[i] = smem_u32(halo + row * HROW + (lane >> 4) * 16);
    }
    float part[MT][NT][4];   // f32: this k tile's sum (promotion)
    if constexpr (F32) zero_frags(part);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      // f32 pass by pass, as fu_mma.cuh's loop (mma_pass)
      const auto load_b = [&](const unsigned char* s, uint32_t (&f)[NT][2]) {
#pragma unroll
        for (int jj = 0; jj < NT; jj += 2) {
          uint32_t b[4];
          frag_b2<T, BMAJ, BN>(s, wn0 + jj * 8, ks, lane, b);
#pragma unroll
          for (int q = 0; q < 4; ++q) f[jj + q / 2][q & 1] = b[q];
        }
      };
      uint32_t bh[NT][2], ah[MT][4];
      load_b(sb, bh);
      if constexpr (F32) {
        uint32_t bl[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(ah[i], arow[i] + plane + ks * 32);
        mma_pass(part, ah, bh);
        load_b(sb + PB, bl);
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(ah[i], arow[i] + ks * 32);
        mma_pass(part, ah, bl);
        mma_pass(part, ah, bh);
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i) ldsm_x4(ah[i], arow[i] + ks * 32);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int jj = 0; jj < NT; ++jj)
            mma_bf16(acc[i][jj], ah[i], bh[jj][0], bh[jj][1]);
      }
    }
    if constexpr (F32) promote(acc, part);
  }
  tile_epilogue<T, BM, BN, SM::EPI, WARPS_M, WARPS_N, MT, NT>(
      p, acc, m0, n0, wm0, wn0, warp, lane);
}

// static: see fu_mma.cuh launch_tile
template <typename T, int DIR, int BM, int BN>
static int launch_conv(const Gemm& p, cudaStream_t st) {
  auto kern = conv_kernel<T, DIR, BM, BN>;
  const int bytes = Conv<T, DIR, BN>::bytes(halo_rows(BM, p.a.W));
  static int sized = 0;   // the most dynamic shared memory allowed so far
  if (bytes > sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    sized = bytes;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.splits);
  kern<<<grid, THREADS, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// K4's forward or K7's dgrad on a (bm, bn) tile, then, when split over the
// summed channels, fu_mma.cuh's split epilogue; the statistics partials
// are left in p.spart for col_sums.  An unknown tile is
// cudaErrorInvalidValue.
template <typename T, int DIR>
static int conv(const Gemm& p, int bm, int bn, cudaStream_t st) {
  int err = (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {   // f32 takes no 128 x 128 tile
    if (bm == 128 && bn == 128) err = launch_conv<T, DIR, 128, 128>(p, st);
  }
  if (bm == 128 && bn == 64)
    err = launch_conv<T, DIR, 128, 64>(p, st);
  else if (bm == 64 && bn == 128)
    err = launch_conv<T, DIR, 64, 128>(p, st);
  if (err != cudaSuccess || p.splits == 1) return err;
  constexpr int EPI = DIR == FWD ? EPI_Y : EPI_DP;
  const dim3 grid((p.N + 15) / 16, (p.M + bm - 1) / bm);
  split_epi_kernel<T, EPI><<<grid, THREADS, 0, st>>>(p, bm);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad
// ---------------------------------------------------------------------------

// Shared memory of the wgrad: fin(g) of a band (two planes) and the
// activation halo (rows and a zero row; f32 two planes, bf16 one), each row
// 32 channels padded by 8 so that MN-major fragment loads are
// conflict-free.
template <typename T>
struct WgradSmem {
  static constexpr int BAND = sizeof(T) == 4 ? 64 : 128;   // pixels a k tile
  static constexpr int STRIDE = (WB + 8) * (int)sizeof(T);
  static constexpr int GPLANE = BAND * STRIDE;
  static constexpr int HPLANES = sizeof(T) == 4 ? 2 : 1;
  __host__ __device__ static int bytes(int hrows) {
    return 2 * GPLANE + HPLANES * (hrows + 1) * STRIDE;
  }
};

// p.a: the activation (x, sc, sh; ld Ci, H, W); p.b: the cotangent (g,
// y_raw, c1, u0, u1; ld Co); M = Ci, N = Co, K = R pixels summed over
// [blockIdx.z * chunk, + chunk); p.out: dW (Co, 9, Ci) f32, or p.ws the
// (splits, Co, 9, Ci) partials.  Warp t computes tap t's 32 i x 32 o.
template <typename T>
__global__ void __launch_bounds__(WTHREADS, 2)
wgrad_kernel(const __grid_constant__ Gemm p) {
  using SM = WgradSmem<T>;
  constexpr int BAND = SM::BAND, S = SM::STRIDE;
  constexpr int KSTEPS = BAND / Ty<T>::KS;
  constexpr int MT = WB / 16, NT = WB / 8;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int QPR = WB / 4;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned char eb[BAND];   // the band's pixels' edge bits
  const int tid = threadIdx.x, lane = tid & 31, t = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int i0 = blockIdx.x * WB, o0 = blockIdx.y * WB;
  const int kbeg = blockIdx.z * p.chunk;
  const int kend = min(p.K, kbeg + p.chunk);
  Halo hg;
  hg.set(BAND, p.a.W);
  unsigned char* gs = smem;
  unsigned char* hs = smem + 2 * SM::GPLANE;
  const int hplane = (hg.rows + 1) * S;
  if (tid < SM::HPLANES * S / 16)
    *reinterpret_cast<uint4*>(hs + (tid / (S / 16)) * hplane + hg.rows * S
                              + (tid % (S / 16)) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  Div byw, byh;
  byw.set(p.a.W);
  byh.set(p.a.H);
  Rows<T, X_FINALIZE, QPR, WTHREADS, S> gst(tid);
  Rows<T, X_PROLOGUE, QPR, WTHREADS, S> ast(tid);
  // tap t reads act(x) at pixel (h + dh, w + dw)
  const int dh = t / 3 - 1, dw = t % 3 - 1;
  const unsigned forbid = (unsigned)(dh < 0) | (unsigned)(dh > 0) << 1
                          | (unsigned)(dw < 0) << 2 | (unsigned)(dw > 0) << 3;

  float acc[MT][NT][4];
  zero_frags(acc);

  for (int p0 = kbeg; p0 < kend; p0 += BAND) {
    const auto gsrc = [&](int e) { return p0 + e; };
    const auto asrc = [&](int e) { return hg.src(e, p0); };
    // every warp is done with the last band
    if (p0 != kbeg) __syncthreads();
    gst.issue(p.b, gs, SM::GPLANE, BAND, kend, o0, p.N, gsrc);
    ast.issue(p.a, hs, hplane, hg.rows, p.K, i0, p.M, asrc);
    cp_async_commit();
    if (tid < BAND) {
      const int r = p0 + tid, q = byw(r);
      eb[tid] = r < kend ? (unsigned char)edge_bits(q - byh(q) * p.a.H,
                                                    r - q * p.a.W, p.a.H,
                                                    p.a.W)
                         : 0;
    }
    cp_async_wait<0>();
    gst.transform(p.b, gs, SM::GPLANE, BAND, kend, o0, p.N, gsrc);
    ast.transform(p.a, hs, hplane, hg.rows, p.K, i0, p.M, asrc);
    __syncthreads();
    float part[MT][NT][4];   // f32: this band's sum (promotion)
    if constexpr (F32) zero_frags(part);
#pragma unroll 2
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const auto load_b = [&](const unsigned char* s, uint32_t (&f)[NT][2]) {
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          frag_b2<T, MN_MAJOR, WB>(s, j * 8, ks, lane, b);
#pragma unroll
          for (int q = 0; q < 4; ++q) f[j + q / 2][q & 1] = b[q];
        }
      };
      uint32_t bh[NT][2];
      load_b(gs, bh);
      // this lane's pixel rows of the k step, tap-shifted in the halo, or
      // the zero row off the image
      const auto hrow = [&](int k) {
        return eb[k] & forbid ? hg.rows : hg.row(k, dh, dw);
      };
      uint32_t ah[MT][4];
      if constexpr (F32) {
        // pass by pass, as fu_mma.cuh's loop (mma_pass)
        const int k = ks * 8 + tq;
        const uint32_t* h = reinterpret_cast<const uint32_t*>(hs);
        const int ra = hrow(k) * (S / 4) + g, rb = hrow(k + 4) * (S / 4) + g;
        const auto load_a = [&](int plane) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            ah[i][0] = h[plane + ra + i * 16];
            ah[i][1] = h[plane + ra + i * 16 + 8];
            ah[i][2] = h[plane + rb + i * 16];
            ah[i][3] = h[plane + rb + i * 16 + 8];
          }
        };
        uint32_t bl[NT][2];
        load_a(hplane / 4);
        mma_pass(part, ah, bh);
        load_b(gs + SM::GPLANE, bl);
        load_a(0);
        mma_pass(part, ah, bl);
        mma_pass(part, ah, bh);
      } else {
        const int k = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
        const uint32_t base = smem_u32(hs + hrow(k) * S
                                       + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldsm_x4_t(ah[i], base + i * 32);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[i][j], ah[i], bh[j][0], bh[j][1]);
        }
      }
    }
    if constexpr (F32) promote(acc, part);
  }

  float* out = p.splits == 1
                   ? static_cast<float*>(p.out)
                   : p.ws + (size_t)blockIdx.z * p.N * 9 * p.M;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ii = i0 + i * 16 + g + 8 * (q >> 1);
        const int o = o0 + j * 8 + 2 * tq + (q & 1);
        if (ii < p.M && o < p.N)
          out[((size_t)o * 9 + t) * p.M + ii] = acc[i][j][q];
      }
}

// K7's wgrad, then, when split over pixels, the ordered chunk reduction.
template <typename T>
static int wgrad(const Gemm& p, cudaStream_t st) {
  auto kern = wgrad_kernel<T>;
  const int bytes = WgradSmem<T>::bytes(halo_rows(WgradSmem<T>::BAND,
                                                  p.a.W));
  static int sized = 0;
  if (bytes > sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    sized = bytes;
  }
  const dim3 grid((p.M + WB - 1) / WB, (p.N + WB - 1) / WB, p.splits);
  kern<<<grid, WTHREADS, bytes, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const size_t n = (size_t)p.N * 9 * p.M;
  fu::split_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      p.ws, static_cast<float*>(p.out), p.splits, n);
  return (int)cudaGetLastError();
}

}  // namespace fhalo
