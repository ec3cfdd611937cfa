"""Build and load the port's CUDA kernels from the sources in csrc/.

Each kernel is one .cu file with a plain C entry point.  On first use it is
compiled with nvcc for sm_90a into build/torch_kernels/ at the repository
root (a directory .gitignore lists), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
A missing nvcc or a failed build raises with the compiler's output.
Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}   # name -> {"seconds", "cached", "log", "so"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the CUDA kernels cannot be built")


def _so_path(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}_{digest.hexdigest()[:16]}.so")


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for csrc/<name>.cu, building it if needed."""
    return load_all([name])[name]


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Load csrc/<name>.cu for every name, starting one nvcc per source
    that needs a build, all at once, and waiting for all of them."""
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        if name in _LOADED or name in jobs:
            continue
        src, so = _so_path(name)
        proc = tmp = None
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        jobs[name] = (src, so, tmp, proc)
    failed = []
    for name, (src, so, tmp, proc) in jobs.items():
        log = ""
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src} "
                              f"(exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, so)
        _LOADED[name] = ctypes.CDLL(so)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "cached": proc is None, "log": log, "so": so}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _LOADED[name] for name in names}
