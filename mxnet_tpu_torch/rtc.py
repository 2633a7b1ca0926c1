"""Runtime kernels: CUDA C++ written at run time, and ops registered at run
time.

Counterpart of ``mxnet_tpu/rtc.py``, which registers Pallas (or jax)
functions as operators and whose ``CudaModule`` is a marker that points
at Pallas.  Here the two halves are MXNet's own:

- ``CudaModule(source, options, exports)`` compiles CUDA C++ once per
  source and options (``nvcc -cubin`` for sm_90a, ``cuda_build.
  build_cubin``), loads it through the CUDA driver API and hands out
  ``CudaKernel``s whose ``launch(args, ctx, grid_dims, block_dims,
  shared_mem)`` runs them on torch's current stream of that card.  The
  kernel's C signature (``"const float *x, float *y, int n"``) is parsed
  as MXNet parses it into the argument packing, and every array argument
  is checked for device, dtype and contiguity.
- ``register_kernel_op(name, fn, ...)`` installs a torch function (which
  may launch such kernels) as an operator usable from ``mt.nd``,
  ``mt.sym``, the ``Executor`` and ``autograd``; ``vjp=(fwd, bwd)`` gives
  it a hand-written backward through ``torch.autograd.Function``.

Nothing here falls back: ``CudaModule`` without a card or without
``nvcc`` raises, and ``pallas_call`` raises and names ``CudaModule``.
"""
from __future__ import annotations

import ctypes
import re
import threading

import numpy as np
import torch

from .base import MXNetError
from .context import Context
from .ops.registry import OpDef, register_opdef

__all__ = ["register_kernel_op", "pallas_call", "CudaModule", "CudaKernel"]


def pallas_call(*args, **kwargs):
    """The reference re-exports Pallas for kernel authors; Pallas targets
    the TPU, so here it raises and points at ``CudaModule``."""
    raise MXNetError(
        "pallas_call writes TPU kernels, which do not run here; write the "
        "kernel in CUDA C++, compile it with mxnet_tpu_torch.rtc.CudaModule "
        "and register the function that launches it with "
        "register_kernel_op")


# ---------------------------------------------------------------------------
# register_kernel_op
# ---------------------------------------------------------------------------

def _user_attrs(attrs):
    return {k: v for k, v in attrs.items() if not k.startswith("_")}


def _custom_vjp(fn, fwd_fn, bwd_fn, nout):
    """impl(attrs, *inputs) running ``fn`` as it is, and ``fwd_fn`` /
    ``bwd_fn`` as its forward and backward when a gradient is recorded:
    ``fwd_fn(*xs, **attrs) -> (out, res)``, ``bwd_fn(res, cot, **attrs) ->
    one cotangent per input`` (None for an input without one), the
    reference's custom_vjp pair."""

    class KernelFunction(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, *xs):
            out, res = fwd_fn(*xs, **a)
            ctx.res, ctx.a = res, a
            return out

        @staticmethod
        def backward(ctx, *cots):
            grads = bwd_fn(ctx.res, cots[0] if nout == 1 else cots,
                           **ctx.a)
            if isinstance(grads, torch.Tensor):
                grads = (grads,)
            return (None,) + tuple(grads)

    def impl(attrs, *inputs):
        a = _user_attrs(attrs)
        if torch.is_grad_enabled() and any(
                isinstance(x, torch.Tensor) and x.requires_grad
                for x in inputs):
            return KernelFunction.apply(a, *inputs)
        return fn(*inputs, **a)
    return impl


def register_kernel_op(name, fn, nin=1, nout=1, input_names=None,
                       params=None, vjp=None, aliases=()):
    """Register a runtime-written kernel as an operator.

    ``fn(*inputs, **attrs) -> output(s)`` is a torch function (it may
    launch ``CudaKernel``s; on meta tensors, which shape inference passes,
    it must not).  ``params`` declares typed attrs ({name: ops.P(...)}).
    ``vjp``: optional (fwd_res_fn, bwd_fn) pair for a kernel torch cannot
    differentiate.  The op appears at once as ``mt.nd.<name>`` and
    ``mt.sym.<name>`` (and under each alias).  Returns the OpDef; the
    reference's ``rtc.register_kernel_op`` with the same meaning."""
    if vjp is not None:
        impl = _custom_vjp(fn, vjp[0], vjp[1], nout)
    else:
        def impl(attrs, *inputs):
            return fn(*inputs, **_user_attrs(attrs))
    opdef = OpDef(name, impl, params=params or {}, nin=nin, nout=nout,
                  input_names=input_names, doc=fn.__doc__ or "")
    register_opdef(opdef, aliases=aliases)
    from . import ndarray as _nd
    from . import symbol as _sym
    from .ndarray.register import make_op_func
    from .symbol.register import make_sym_func
    for public in (name,) + tuple(aliases):
        setattr(_nd, public, make_op_func(opdef, public))
        setattr(_sym, public, make_sym_func(opdef, public))
    return opdef


# ---------------------------------------------------------------------------
# CudaModule: the CUDA driver API through ctypes
# ---------------------------------------------------------------------------

class _Driver:
    """The few CUDA driver calls a runtime kernel needs, on the primary
    context of each card (the one the CUDA runtime, and so torch, uses)."""

    def __init__(self):
        try:
            lib = ctypes.CDLL("libcuda.so.1")
        except OSError as e:
            raise MXNetError("the CUDA driver (libcuda.so.1) cannot be "
                             "loaded: %s" % e) from e
        self.lib = lib
        lib.cuGetErrorString.argtypes = [ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_char_p)]
        lib.cuLaunchKernel.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_uint] * 7
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
        lib.cuModuleGetFunction.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.c_char_p]
        lib.cuModuleLoadData.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                         ctypes.c_char_p]
        lib.cuCtxSetCurrent.argtypes = [ctypes.c_void_p]
        lib.cuDevicePrimaryCtxRetain.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        self.check(lib.cuInit(0), "cuInit")
        self._contexts = {}
        self._lock = threading.Lock()

    def check(self, rc, what):
        if rc != 0:
            msg = ctypes.c_char_p()
            self.lib.cuGetErrorString(rc, ctypes.byref(msg))
            raise MXNetError("%s failed: CUDA error %d (%s)" % (
                what, rc, (msg.value or b"unknown").decode()))

    def make_current(self, ordinal):
        """Make card ``ordinal``'s primary context current in this thread:
        the CUDA driver's current context is per thread, and a serving engine
        launches from threads of its own."""
        with self._lock:
            pctx = self._contexts.get(ordinal)
            if pctx is None:
                torch.cuda.init()      # the runtime makes the primary ctx
                dev = ctypes.c_int()
                self.check(self.lib.cuDeviceGet(ctypes.byref(dev), ordinal),
                           "cuDeviceGet")
                pctx = ctypes.c_void_p()
                self.check(self.lib.cuDevicePrimaryCtxRetain(
                    ctypes.byref(pctx), dev), "cuDevicePrimaryCtxRetain")
                self._contexts[ordinal] = pctx
        self.check(self.lib.cuCtxSetCurrent(pctx), "cuCtxSetCurrent")

    def load(self, image):
        mod = ctypes.c_void_p()
        self.check(self.lib.cuModuleLoadData(ctypes.byref(mod), image),
                   "cuModuleLoadData")
        return mod

    def function(self, module, name):
        fn = ctypes.c_void_p()
        self.check(self.lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                                name.encode()),
                   "cuModuleGetFunction(%r) (declare the kernel extern "
                   "\"C\" so that its name is not mangled)" % name)
        return fn

    def launch(self, fn, grid, block, shared_mem, stream, params):
        self.check(self.lib.cuLaunchKernel(
            fn, *grid, *block, shared_mem, stream,
            ctypes.cast(params, ctypes.c_void_p), None), "cuLaunchKernel")


_driver = None
_driver_lock = threading.Lock()


def _get_driver():
    global _driver
    with _driver_lock:
        if _driver is None:
            _driver = _Driver()
    return _driver


# C type of a kernel argument -> (numpy dtype, ctypes scalar type)
_CTYPES = {
    "float": (np.float32, ctypes.c_float),
    "double": (np.float64, ctypes.c_double),
    "__half": (np.float16, None),
    "half": (np.float16, None),
    "__nv_bfloat16": ("bfloat16", None),
    "uint8_t": (np.uint8, ctypes.c_uint8),
    "int8_t": (np.int8, ctypes.c_int8),
    "char": (np.int8, ctypes.c_int8),
    "int": (np.int32, ctypes.c_int32),
    "int32_t": (np.int32, ctypes.c_int32),
    "int64_t": (np.int64, ctypes.c_int64),
    "size_t": (np.uint64, ctypes.c_uint64),
}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")


def _torch_dtype(dt):
    return torch.bfloat16 if dt == "bfloat16" else getattr(
        torch, np.dtype(dt).name)


def parse_signature(signature):
    """``"const float *x, float *y, int n"`` -> [(is_array, is_const,
    torch dtype, ctypes type or None), ...], as MXNet parses a kernel
    signature."""
    args = []
    for part in signature.split(","):
        m = _ARG.match(part)
        if not m or m.group(2) not in _CTYPES:
            raise MXNetError(
                "invalid kernel argument %r in signature %r: expected "
                "'[const] <type> [*]name' with type one of %s"
                % (part.strip(), signature, sorted(_CTYPES)))
        dt, cty = _CTYPES[m.group(2)]
        is_array = m.group(3) is not None
        if not is_array and cty is None:
            raise MXNetError("scalar arguments of type %s are not "
                             "supported" % m.group(2))
        args.append((is_array, m.group(1) is not None, _torch_dtype(dt),
                     cty))
    return args


class CudaModule:
    """CUDA C++ compiled at run time (MXNet's ``mx.rtc.CudaModule``):

        mod = CudaModule(source, options=(), exports=())
        kernel = mod.get_kernel("axpy", "const float *x, float *y, int n")
        kernel.launch([x, y, n], mt.gpu(0), (blocks, 1, 1), (256, 1, 1))

    Kernels are looked up by name, so declare them ``extern "C"``;
    ``exports`` names the kernels the source must define (each is looked
    up when the module is first loaded on a card).  The source is
    compiled once per source and options by ``nvcc -cubin`` for sm_90a.
    Raises MXNetError without a card or without ``nvcc``."""

    def __init__(self, source, options=(), exports=()):
        if not torch.cuda.is_available():
            raise MXNetError("CudaModule needs a CUDA card: it compiles and "
                             "runs CUDA C++ there (no card is available)")
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        from . import cuda_build
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self.path = cuda_build.build_cubin(source, self.options)
        with open(self.path, "rb") as f:
            self._image = f.read()
        self._modules = {}
        self._lock = threading.Lock()

    def _module(self, ordinal):
        drv = _get_driver()
        drv.make_current(ordinal)
        with self._lock:
            mod = self._modules.get(ordinal)
            if mod is None:
                mod = drv.load(self._image)
                for name in self.exports:
                    drv.function(mod, name)
                self._modules[ordinal] = mod
        return mod

    def get_kernel(self, name, signature):
        """The kernel ``name`` with C argument list ``signature``."""
        return CudaKernel(self, name, parse_signature(signature))


class CudaKernel:
    """One kernel of a ``CudaModule``.  ``CudaKernel.launches`` counts the
    launches of every runtime kernel in the process."""

    launches = 0

    def __init__(self, module, name, args):
        self.module = module
        self.name = name
        self.args = args
        self._functions = {}

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on card ``ctx`` (a gpu Context) over ``grid_dims`` x
        ``block_dims`` (1 to 3 entries each) with ``shared_mem`` bytes of
        dynamic shared memory, on torch's current stream of that card.
        ``args`` follow the signature: NDArrays or CUDA tensors for
        pointers (on ``ctx``, of the declared dtype, contiguous), numbers
        for scalars."""
        if not isinstance(ctx, Context) or ctx.device_type != "gpu":
            raise MXNetError("%s: runtime kernels launch on a gpu context, "
                             "got %r" % (self.name, ctx))
        if len(args) != len(self.args):
            raise MXNetError("%s: %d arguments given, the signature has %d"
                             % (self.name, len(args), len(self.args)))
        device = ctx.device
        values = []
        for i, (a, (is_array, _const, dtype, cty)) in enumerate(
                zip(args, self.args)):
            if is_array:
                t = getattr(a, "_data", a)
                if not isinstance(t, torch.Tensor):
                    raise MXNetError("%s: argument %d must be an array, got "
                                     "%s" % (self.name, i, type(a).__name__))
                if t.device != device or t.dtype != dtype \
                        or not t.is_contiguous():
                    raise MXNetError(
                        "%s: argument %d must be a contiguous %s array on "
                        "%s, got %s on %s" % (self.name, i, dtype, device,
                                              t.dtype, t.device))
                values.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if isinstance(a, (torch.Tensor, np.ndarray)) \
                        or hasattr(a, "_data"):
                    raise MXNetError("%s: argument %d is a scalar in the "
                                     "signature" % (self.name, i))
                values.append(cty(a))
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        ordinal = device.index or 0
        mod = self.module._module(ordinal)
        fn = self._functions.get(ordinal)
        if fn is None:
            fn = self._functions[ordinal] = _get_driver().function(
                mod, self.name)
        params = (ctypes.c_void_p * len(values))(
            *[ctypes.cast(ctypes.byref(v), ctypes.c_void_p) for v in values])
        stream = ctypes.c_void_p(torch.cuda.current_stream(device)
                                 .cuda_stream)
        _get_driver().launch(fn, grid, block, int(shared_mem), stream,
                             params)
        CudaKernel.launches += 1


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError("%s must be 1 to 3 positive sizes, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))
