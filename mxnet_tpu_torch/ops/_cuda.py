"""How an op module validates, allocates for and launches a hand-written
CUDA kernel: shared by ``fused_unit`` (K1-K3, K5, K6) and ``nn`` (K8).

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


def wgrad_split(rows, m, n):
    """(splits, chunk) of the wgrad's reduction over ``rows`` for an
    (m, n) weight gradient: about 256 blocks of 64 x 64 tiles and at least
    1024 rows a chunk, from the shapes alone, so that the sum order (and
    the result) never depends on the device."""
    tiles = -(-m // 64) * -(-n // 64)
    splits = max(1, min(-(-256 // tiles), rows // 1024))
    chunk = -(-rows // splits)
    chunk = -(-chunk // 16) * 16
    return -(-rows // chunk), chunk


def wgrad_buffers(rows, m, n, device):
    """(dW (m, n) f32, partials or None, splits, chunk)."""
    splits, chunk = wgrad_split(rows, m, n)
    dw = torch.empty((m, n), dtype=torch.float32, device=device)
    wpart = torch.empty((splits, m, n), dtype=torch.float32,
                        device=device) if splits > 1 else None
    return dw, wpart, splits, chunk
