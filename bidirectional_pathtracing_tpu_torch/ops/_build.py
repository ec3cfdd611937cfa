"""Build and load the port's CUDA kernels from the sources in csrc/.

Each kernel is one .cu file with a plain C entry point.  On first use it is
compiled with nvcc for sm_90a into build/torch_kernels/ at the repository
root (a directory .gitignore lists), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
A missing nvcc or a failed build raises with the compiler's output.
Nothing is compiled at import time.  start / finish / compile_library are the
build step itself, which ops/native.py also uses for its g++ build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

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


class Job(NamedTuple):
    """One library being built: started by start(), waited for by
    finish()."""

    src: str
    so: str
    tmp: str | None             # the compiler's output until it succeeds
    proc: subprocess.Popen | None  # None when `so` was already built


def start(compiler: str, flags, src: str, prefix: str) -> Job:
    """Start `compiler *flags -o <so> src` unless the library is already
    built.  The library is BUILD_DIR/lib<prefix>_<hash>.so, named by a hash
    of the source and the flags; the compiler writes a file of its own
    that finish() moves into place, so a concurrent build never sees half
    of one."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    so = os.path.join(BUILD_DIR, f"lib{prefix}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return Job(src, so, None, None)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([compiler, *flags, "-o", tmp, src],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return Job(src, so, tmp, proc)


def finish(job: Job) -> str:
    """Wait for a started build and return the compiler's output; raise
    with that output if it failed."""
    if job.proc is None:
        return ""
    log = job.proc.communicate()[0]
    if job.proc.returncode != 0:
        tool = os.path.basename(job.proc.args[0])
        raise RuntimeError(f"{tool} failed for {job.src} "
                           f"(exit {job.proc.returncode}):\n{log}")
    os.replace(job.tmp, job.so)
    return log


def compile_library(compiler: str, flags, src: str, prefix: str) -> str:
    """Build one library (start, then finish); its path."""
    job = start(compiler, flags, src, prefix)
    finish(job)
    return job.so


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
        jobs[name] = start(_nvcc(), NVCC_FLAGS,
                           os.path.join(CSRC, f"{name}.cu"), name)
    failed = []
    for name, job in jobs.items():
        try:
            log = finish(job)
        except RuntimeError as e:
            failed.append(str(e))
            continue
        _LOADED[name] = ctypes.CDLL(job.so)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "cached": job.proc is None, "log": log,
                           "so": job.so}
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _LOADED[name] for name in names}
