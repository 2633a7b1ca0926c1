"""How an op module validates, allocates for and launches a hand-written
CUDA kernel: shared by ``fused_unit`` (K1-K7) and ``nn`` (K8), with the
tile and split plans of the tensor-core loops: ``csrc/fu_mma.cuh`` (K1,
K2, K3, K5, K6, K8) and its halo-resident form ``csrc/fu_halo.cuh`` (K4,
K7).

A wrapper asks ``on_host`` first and, for a CPU or meta tensor, runs its
plain version; for a CUDA tensor it checks its operands with ``check`` and
``check_dims``, allocates, and calls ``launch``, which raises when the
entry point returns a CUDA error.  Nothing here falls back.
"""
import ctypes

import torch

from ..base import MXNetError

DTYPES = (torch.float32, torch.bfloat16)
# operands that are per-channel f32 vectors whatever the data type
F32_VECTORS = ("sc", "sh", "xs", "xh", "c1", "u0", "u1")


def on_host(t):
    """True for a CPU or meta tensor (the plain version runs), False for a
    CUDA tensor (the kernel runs); raises for any other device."""
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type != "cuda":
        raise MXNetError("the port's kernels run on CUDA or CPU tensors, "
                         "got %s" % t.device)
    return False


def check(name, dtype, device, **tensors):
    """Device, dtype, contiguity and alignment checks for a launch."""
    for k, t in tensors.items():
        want = torch.float32 if k in F32_VECTORS else dtype
        if t.device != device:
            raise MXNetError("%s: %s is on %s, x on %s"
                             % (name, k, t.device, device))
        if t.dtype != want:
            raise MXNetError("%s: %s has dtype %s, expected %s"
                             % (name, k, t.dtype, want))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise MXNetError("%s: %s must be contiguous and 16-byte "
                             "aligned" % (name, k))
    if dtype not in DTYPES:
        raise MXNetError("%s: dtype %s not supported (float32, bfloat16)"
                         % (name, dtype))


def check_dims(name, k, n):
    """The kernels stage four channels per vector load."""
    if k % 4 or n % 4:
        raise MXNetError("%s: input and output channels must be multiples "
                         "of 4, got %d and %d" % (name, k, n))


def launch(name, *args):
    """Call entry point ``name`` (built on first use) with tensors passed
    as device pointers; raise if it returns a CUDA error."""
    from .. import cuda_build
    fn = cuda_build.load(name)
    rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args])
    if rc != 0:
        raise MXNetError("%s: launch failed with CUDA error %d" % (name, rc))


def stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# The tensor-core tile loop of K1, K2, K3, K5, K6 and K8 (csrc/fu_mma.cuh):
# output tiles of 128 x 128, 128 x 64 or 64 x 128 and a split of the summed
# axis, chosen from the shapes and the element size alone so that the sum
# order (and the result) never depends on the device.  MMA_BLOCKS is the block
# count a plan aims at: one per SM of an H100 SXM.  In f32 each k tile is
# summed from zero and promoted into the accumulator, which the plans leave
# as they were: its 32 more registers a thread fit beside 32 x 32 warp tiles
# because the loops load each operand's fragments just before its first
# MMA pass; of the main path's f32 instantiations only K7's wgrad spills
# (40 bytes, at the 96 registers two of its 288-thread blocks leave;
# PERF.md, Findings).
MMA_BLOCKS = 132
MMA_TILES = ((128, 128), (128, 64), (64, 128))
MMA_K_ALIGN = 64        # chunks are whole 128-byte k tiles of either dtype


def _cdiv(a, b):
    return -(-a // b)


def mma_tiles(m, n, f32=True):
    """(bm, bn) for an (m, n) output: 128 x 64 where n is 64 or less,
    128 x 128 where that fills the SMs (bf16 only: an f32 128 x 128 tile's
    hi and lo planes leave one block an SM), else 64 x 128."""
    if n <= 64:
        return 128, 64
    if not f32 and _cdiv(m, 128) * _cdiv(n, 128) >= MMA_BLOCKS:
        return 128, 128
    return 64, 128


def _chunked(k, splits):
    chunk = _cdiv(_cdiv(k, splits), MMA_K_ALIGN) * MMA_K_ALIGN
    return _cdiv(k, chunk), chunk


def mma_plan(m, n, k, f32=True):
    """(bm, bn, splits, chunk) of an (m, n) product over k channels (K1,
    K2, K3, the dgrads of K5, K6 and K8) in f32 or bf16: the k range is
    halved while each chunk keeps at least 256 channels and the blocks number
    fewer than one an SM (bf16) or two (f32).  Two blocks share an SM, so
    196 blocks leave 64 SMs with twice the work of the other 68; in f32 a
    further split pays for its partials, in bf16, whose 128 x 128 tiles
    split into twice the partials, it did not (PERF.md, Findings)."""
    bm, bn = mma_tiles(m, n, f32)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    target = MMA_BLOCKS * (2 if f32 else 1)
    splits = 1
    while tiles * splits < target and k >= 2 * splits * 256:
        splits *= 2
    return (bm, bn) + _chunked(k, splits)


def mma_wgrad_plan(m, n, rows):
    """(bm, bn, splits, chunk) of an (m, n) weight gradient summed over
    ``rows`` (K5, K6, K8), in either dtype: about two blocks per SM, at
    least 512 rows a chunk, and no 128 x 128 tile (its two MN-major
    operands, one through the finalize, need more registers than two
    blocks an SM leave)."""
    bm, bn = mma_tiles(m, n)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    splits = max(1, min(_cdiv(2 * MMA_BLOCKS, tiles), rows // 512))
    return (bm, bn) + _chunked(rows, splits)


# The halo-resident loops of K4 and K7 (csrc/fu_halo.cuh).  A band of
# pixels of the (n, h, w) row layout reads, over all nine taps, a halo of
# rows around it: one window of band + 2W + 2 rows, or three of band + 2
# where W > band + 2.
HALO_ROW_BYTES = 144        # a K-major halo row: 128 bytes of k + padding
# dynamic shared memory that leaves two blocks an SM (228 KB, less 1 KB
# reserved a block and the 2 KB of statistics scratch each)
SMEM_TWO_BLOCKS = 111 * 1024
# the wgrad block's o and i (nine warps, a tap each)
HALO_WGRAD_TILE = 32


def halo_rows(band, w_):
    """Rows of the halo of a band of ``band`` pixels over images w_ wide."""
    return min(band + 2 * w_ + 2, 3 * (band + 2))


def halo_dgrad_smem(bm, bn, w_, f32=True):
    """Dynamic shared memory of K7's dgrad on a (bm, bn) tile: a two-stage
    ring of (k tile x bn) weight slices, MN-major (f32: hi and lo planes),
    and the halo of bm pixels, with a zero row, in two planes (f32: hi and
    lo; bf16: g and y_raw)."""
    stage = (256 if f32 else 128) * (bn + 8)
    return 2 * stage + 2 * (halo_rows(bm, w_) + 1) * HALO_ROW_BYTES


def halo_fwd_smem(bm, bn, w_, f32=True):
    """Dynamic shared memory of K4's forward on a (bm, bn) tile: a
    two-stage ring of (bn x k tile) weight slices, K-major with rows of
    HALO_ROW_BYTES, and the halo of bm pixels with a zero row, in two planes
    (hi and lo) in f32 and one in bf16."""
    planes = 2 if f32 else 1
    return planes * (2 * bn + halo_rows(bm, w_) + 1) * HALO_ROW_BYTES


def _halo_plan(rows, n, k, w_, f32, smem):
    """(bm, bn, splits, chunk) of a halo loop's (rows, n) product summed
    over k channels and nine taps, on images w_ wide: ``mma_tiles``' tile,
    or 64 x 128 where a 128-pixel band's halo would leave one block an SM
    (``smem``: the loop's shared memory); k is halved, in whole 64-channel
    chunks, while the blocks number fewer than two an SM (f32) or one
    (bf16) and each chunk keeps at least 256 of the 9 * k products a pixel,
    as ``mma_plan`` splits."""
    bm, bn = mma_tiles(rows, n, f32)
    if bm == 128 and smem(bm, bn, w_, f32) > SMEM_TWO_BLOCKS:
        bm, bn = 64, 128
    tiles = _cdiv(rows, bm) * _cdiv(n, bn)
    target = MMA_BLOCKS * (2 if f32 else 1)
    splits = 1
    while tiles * splits < target and 9 * k >= 2 * splits * 256:
        splits *= 2
    return (bm, bn) + _chunked(k, splits)


def halo_dgrad_plan(rows, ci, co, w_, f32=True):
    """(bm, bn, splits, chunk) of K7's dgrad dP (rows, ci) summed over co
    channels and nine taps (``_halo_plan``)."""
    return _halo_plan(rows, ci, co, w_, f32, halo_dgrad_smem)


def halo_fwd_plan(rows, ci, co, w_, f32=True):
    """(bm, bn, splits, chunk) of K4's forward y (rows, co) summed over ci
    channels and nine taps (``_halo_plan``)."""
    return _halo_plan(rows, co, ci, w_, f32, halo_fwd_smem)


def halo_wgrad_band(f32=True):
    """Pixels of K7's wgrad k tile: 64 in f32, 128 in bf16."""
    return 64 if f32 else 128


def halo_wgrad_plan(rows, ci, co, f32=True):
    """(splits, chunk) of K7's wgrad dW (co, 9, ci) summed over ``rows``
    pixels: about two blocks an SM of its 32 o x 32 i x 9-tap tiles, at
    least four bands a chunk, chunks of whole bands."""
    band = halo_wgrad_band(f32)
    tiles = _cdiv(ci, HALO_WGRAD_TILE) * _cdiv(co, HALO_WGRAD_TILE)
    splits = max(1, min(_cdiv(2 * MMA_BLOCKS, tiles), rows // (4 * band)))
    chunk = _cdiv(_cdiv(rows, splits), band) * band
    return _cdiv(rows, chunk), chunk
