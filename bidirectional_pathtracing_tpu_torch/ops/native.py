"""ctypes loader of the native (C++) BVH builder, csrc/bvh_builder.cpp.

A port of bidirectional_pathtracing_tpu/ops/native/__init__.py.  The
builder runs on the host.  On first use it is compiled with g++ by the
build step of the CUDA kernels (ops/_build.py compile_library): into
build/torch_kernels/ at the repository root, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.  Nothing is built at import time.

available() says whether g++ is on the PATH.  scene/bvh.py takes this
builder whenever it is, and the numpy copy (_build_numpy) only where it is
not, and records which one ran; a failed build raises with the compiler's
output.  -ffp-contract=off keeps g++ from fusing a multiply and an add, so
the split costs and planes round as numpy's do and both builders give the
same tree.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from bidirectional_pathtracing_tpu_torch.ops import _build

SOURCE = os.path.join(_build.CSRC, "bvh_builder.cpp")
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def available() -> bool:
    """Whether the native builder can be built here (g++ on the PATH)."""
    return shutil.which("g++") is not None


def get_lib() -> ctypes.CDLL:
    """The loaded builder library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on the PATH; the native "
                               "BVH builder cannot be built")
        so = _build.compile_library(cxx, CXX_FLAGS, SOURCE, "bvh_builder")
        lib = ctypes.CDLL(so)
        sig = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
        for fn in (lib.bvh_build, lib.bvh_build_sah):
            fn.restype = ctypes.c_int64
            fn.argtypes = sig
        _lib = lib
        return lib


def bvh_build_native(lo: np.ndarray, hi: np.ndarray, max_leaf: int,
                     sah: bool = False):
    """Build a flattened pre-order BVH over primitive bounds lo, hi [n, 3]
    (float64); the tuple of scene/bvh.py _build_numpy.  sah=True uses the
    binned surface-area-heuristic split (bvh_build_sah) instead of the
    reference's midpoint split."""
    lib = get_lib()
    n = lo.shape[0]
    cap = 2 * n + 2
    lo = np.ascontiguousarray(lo, np.float64)
    hi = np.ascontiguousarray(hi, np.float64)
    bounds_lo = np.zeros((cap, 3), np.float32)
    bounds_hi = np.zeros((cap, 3), np.float32)
    is_leaf = np.zeros(cap, np.uint8)
    prim_start = np.zeros(cap, np.int32)
    prim_count = np.zeros(cap, np.int32)
    escape = np.zeros(cap, np.int32)
    order = np.zeros(n, np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    fn = lib.bvh_build_sah if sah else lib.bvh_build
    n_nodes = fn(
        p(lo, ctypes.c_double), p(hi, ctypes.c_double),
        ctypes.c_int64(n), ctypes.c_int64(max_leaf),
        p(bounds_lo, ctypes.c_float), p(bounds_hi, ctypes.c_float),
        p(is_leaf, ctypes.c_uint8), p(prim_start, ctypes.c_int32),
        p(prim_count, ctypes.c_int32), p(escape, ctypes.c_int32),
        p(order, ctypes.c_int64))
    if n_nodes <= 0:
        raise RuntimeError(f"bvh_build failed on {n} primitives")
    k = int(n_nodes)
    return (bounds_lo[:k], bounds_hi[:k], is_leaf[:k].astype(bool),
            prim_start[:k], prim_count[:k], escape[:k], order)
