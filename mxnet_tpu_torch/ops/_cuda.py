"""How an op module validates, allocates for and launches a hand-written
CUDA kernel: shared by ``fused_unit`` (K1-K7) and ``nn`` (K8), with the
tile and split plans of the tensor-core loop that K1, K5, K6 and K8 run
on (``csrc/fu_mma.cuh``).

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


# The tensor-core tile loop of K1, K5, K6 and K8 (csrc/fu_mma.cuh): output
# tiles of 128 x 128, 128 x 64 or 64 x 128 and a split of the summed axis,
# chosen from the shapes and the element size alone so that the sum order
# (and the result) never depends on the device.  MMA_BLOCKS is the block
# count a plan aims at: one per SM of an H100 SXM.
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
    the dgrads of K5, K6 and K8) in f32 or bf16: the k range is halved
    while each chunk keeps at least 256 channels and the blocks number
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
