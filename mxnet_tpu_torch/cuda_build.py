"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` beside the package (a directory git ignores).  The
library's file name carries a hash of its sources and flags, so a stale
build is never loaded; a build writes a temporary file and renames it, so
concurrent builders cannot load a half-written library.  ``build()``
starts one ``nvcc`` per source, all at once.

Nothing here runs at import: a kernel is built the first time a wrapper
launches it, or up front through ``build()``.

A second route serves kernels written at run time (``rtc.CudaModule``):
``build_cubin`` compiles a source string with ``nvcc -cubin`` for
``sm_90a`` into ``build/rtc/<sha of source and options>.cubin``, which
the CUDA driver loads as a module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .base import MXNetError

__all__ = ["KERNELS", "build", "load", "build_dir", "build_cubin"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_COMMON = ["fu_gemm.cuh", "fu_mma.cuh", "fu_halo.cuh"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every kernel entry point: (argtypes) -> int cudaError_t
KERNELS = {
    "fu_mm_fwd": [_P] * 9 + [_I] * 9 + [_P],
    "fu_mm_skip_fwd": [_P] * 7 + [_I] * 8 + [_P],
    "fu_c3_fwd2d": [_P] * 9 + [_I] * 11 + [_P],
    "fu_c3_fwd4d": [_P] * 9 + [_I] * 10 + [_P],
    "fu_mm_bwd": [_P] * 18 + [_I] * 13 + [_P],
    "fu_c3_bwd2d": [_P] * 18 + [_I] * 14 + [_P],
    "fu_c3_bwd4d": [_P] * 18 + [_I] * 12 + [_P],
    "nn_conv1x1_bwd": [_P] * 7 + [_I] * 12 + [_P],
    "cache_write_row": [_P] * 3 + [_I] * 5 + [_P],
    "cache_write_rows": [_P] * 4 + [_I] * 7 + [_P],
}

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded = {}
build_log = {}      # name -> (seconds, nvcc stderr) of builds this process ran


def build_dir():
    return os.path.join(os.path.dirname(_PKG), "build", "kernels")


def rtc_dir():
    return os.path.join(os.path.dirname(_PKG), "build", "rtc")


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                     "build only where the CUDA toolkit is installed")


def _lib_path(name):
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in [name + ".cu"] + _COMMON:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(build_dir(), "lib%s-%s.so" % (name,
                                                      h.hexdigest()[:16]))


def build(names=None):
    """Compile every named kernel library that is not built yet, one nvcc
    process per source, all started together.  Returns {name: path}."""
    names = list(names or KERNELS)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            continue
        tmp = "%s.tmp%d" % (path, os.getpid())
        cmd = [_nvcc()] + FLAGS + ["-o", tmp, os.path.join(_CSRC,
                                                           name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = (time.perf_counter() - t0, out)
        if proc.returncode != 0:
            failed.append("%s:\n%s" % (name, out))
            continue
        os.replace(tmp, path)
    if failed:
        raise MXNetError("nvcc failed for\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name):
    """The ctypes function of kernel ``name``, built on first use."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            path = build([name])[name]
            fn = getattr(ctypes.CDLL(path), name)
            fn.argtypes = KERNELS[name]
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn


CUBIN_FLAGS = ["-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3"]


def build_cubin(source, options=()):
    """Compile the CUDA C++ ``source`` (with extra nvcc ``options``) into
    a cubin for sm_90a, once per source and options; returns its path.
    Raises MXNetError with nvcc's output when it fails."""
    options = [str(o) for o in options]
    h = hashlib.sha256("\0".join([source] + CUBIN_FLAGS + options)
                       .encode()).hexdigest()[:24]
    path = os.path.join(rtc_dir(), h + ".cubin")
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(rtc_dir(), exist_ok=True)
    tmp = "%s.tmp%d" % (path, os.getpid())
    src = tmp + ".cu"
    with open(src, "w") as f:
        f.write(source)
    try:
        proc = subprocess.run([nvcc] + CUBIN_FLAGS + options
                              + ["-o", tmp, src], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise MXNetError("nvcc failed to compile the runtime "
                             "kernel:\n%s%s" % (proc.stdout, proc.stderr))
        os.replace(tmp, path)
    finally:
        for f in (src, tmp):
            if os.path.exists(f):
                os.remove(f)
    return path
