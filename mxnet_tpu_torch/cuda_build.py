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

__all__ = ["KERNELS", "build", "load", "build_dir"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_COMMON = ["fu_gemm.cuh", "fu_bwd.cuh"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every kernel entry point: (argtypes) -> int cudaError_t
KERNELS = {
    "fu_mm_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fu_mm_skip_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fu_c3_fwd2d": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _P],
    "fu_mm_bwd": [_P] * 17 + [_I] * 7 + [_P],
    "fu_c3_bwd2d": [_P] * 17 + [_I] * 8 + [_P],
    "nn_conv1x1_bwd": [_P] * 6 + [_I] * 6 + [_P],
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
