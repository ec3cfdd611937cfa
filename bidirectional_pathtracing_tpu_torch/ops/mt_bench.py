"""K3, the per-cluster Möller–Trumbore microbenchmark: the hand-written CUDA
kernels csrc/mt_bench.cu, their plain torch versions, and the benchmark's
inputs.

Port of tools/profiling/mxu_mt_bench.py (`_vpu_kernel`, `_mxu_kernel`,
`amat_from_tris`, the data of `run`).  It times the clustered kernel's inner
loop in isolation: `iters` cluster visits, visit i testing every ray
against the TC = 128 triangles of slot i % NSLOT of a preloaded table.

  - mt_vpu(rays [8,R], tris [8, 9 or 16, 128], iters, late): Möller–Trumbore
    on the vertex rows (0-2 v0, 3-5 v1, 6-8 v2);
  - mt_linear(rays [8,R], amat [8,512,16], iters, late): the same test with
    its numerators as the dot product of each amat row with the per-ray
    features z = [o, d, o x d, 1, 0 x 6] (the TPU's MXU form), computed
    inside the kernel, in FP32;
  - rays rows: o xyz, d xyz, min_t, max_t.  Out [2,R] f32: best t (INF =
    3.0e38 on a miss, not the renderer's 1e30) and the in-cluster index of
    the winner as f32 (-1 on a miss).

late=False tests t <= min(max_t, best_t) per element; late=True moves the
limit to the reduced cluster minimum (cmin < best_t and cmin <= max_t).
Both give the same closest hit.  Inside a visit the lowest in-cluster index
wins ties among equal minimum t; across visits a strict < keeps the earlier
one.

Each wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors, or raises; there is no fallback.  mt_vpu.launches and
mt_linear.launches count kernel launches.  The plain versions sum every dot
product term by term in the kernel's order, so with nvcc's -fmad=false
(ops/_build.py) kernel and plain version agree bitwise.

Not ported: the TPU tool's `chunk` variants (vpu-chunk16 / vpu-chunk32 and
the chunked mxu-late).  They split a cluster into [chunk, R] pieces so the
live set fits the TPU's vector registers, and give the same result as the
unchunked late form; one thread per ray has no such knob.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.ops import _build

TC = 128       # triangles per cluster
NSLOT = 8      # preloaded clusters cycled over
INF = 3.0e38   # the benchmark's miss sentinel
N_FEAT = 16    # linear-form features per ray
FLOPS_PER_TEST = 55   # the JAX tool's MT-equivalent count per ray-triangle

_KERNEL = "mt_bench"


def amat_from_tris(tris: np.ndarray) -> np.ndarray:
    """tris [NSLOT, 16, TC] -> A [NSLOT, 4*TC, 16] linear-form matrices
    (copy of tools/profiling/mxu_mt_bench.py:148-164).  Rows 0..TC-1 give
    the denominator, then t, b1 and b2 numerators, against z."""
    v0 = tris[:, 0:3, :].transpose(0, 2, 1)   # [S, TC, 3]
    v1 = tris[:, 3:6, :].transpose(0, 2, 1)
    v2 = tris[:, 6:9, :].transpose(0, 2, 1)
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    a = np.zeros((tris.shape[0], 4, tris.shape[2], 16), np.float32)
    a[:, 0, :, 3:6] = -n                                   # denom = -n.d
    a[:, 1, :, 0:3] = n                                    # t_num = n.o - n.v0
    a[:, 1, :, 9] = -np.sum(n * v0, -1)
    a[:, 2, :, 6:9] = e2                                   # b1 = e2.c - (e2xv0).d
    a[:, 2, :, 3:6] = -np.cross(e2, v0)
    a[:, 3, :, 6:9] = -e1                                  # b2 = -e1.c - (v0xe1).d
    a[:, 3, :, 3:6] = -np.cross(v0, e1)
    return a.reshape(tris.shape[0], 4 * tris.shape[2], 16)


def make_inputs(r: int, seed: int = 0):
    """(rays [8,r], tris [NSLOT,16,TC], amat [NSLOT,4*TC,16]) as f32 numpy,
    drawn exactly as the TPU tool's `run` draws them (:168-177)."""
    rng = np.random.default_rng(seed)
    tris = rng.uniform(-1, 1, (NSLOT, 16, TC)).astype(np.float32)
    tris[:, 9:, :] = 0
    rays = np.zeros((8, r), np.float32)
    rays[0:3] = rng.uniform(-2, 2, (3, r))
    dd = rng.normal(size=(3, r))
    rays[3:6] = dd / np.linalg.norm(dd, axis=0)
    rays[6] = 1e-4
    rays[7] = 1e9
    return rays, tris, amat_from_tris(tris)


def _visit(bt, bi, t, b1, b2, denom, min_t, max_t, late):
    """One visit's per-element test, in-cluster scan and epilogue on
    [TC, R] tensors; returns the new (best t, best index)."""
    ok = ((denom != 0) & (t >= min_t[None, :])
          & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1))
    if not late:
        ok = ok & (t <= torch.minimum(max_t, bt)[None, :])
    tm = torch.where(ok, t, INF)
    kmin = tm.amin(dim=0)
    iota = torch.arange(t.shape[0], device=t.device,
                        dtype=torch.float32)[:, None]
    kidx = torch.where(tm <= kmin[None, :], iota, INF).amin(dim=0)
    closer = kmin < bt
    if late:
        closer = closer & (kmin <= max_t)
    return torch.where(closer, kmin, bt), torch.where(closer, kidx, bi)


def _inv(denom):
    return torch.where(denom == 0, 0.0,
                       1.0 / torch.where(denom == 0, 1.0, denom))


def mt_vpu_plain(rays, tris, iters: int, late: bool = False):
    """The plain torch version of mt_vpu, whole [TC, R] planes per visit,
    every product and sum in the kernel's order."""
    o = [rays[k] for k in range(3)]
    d = [rays[3 + k] for k in range(3)]
    min_t, max_t = rays[6], rays[7]
    r = rays.shape[1]
    bt = torch.full((r,), INF, dtype=torch.float32, device=rays.device)
    bi = torch.full((r,), -1.0, dtype=torch.float32, device=rays.device)
    for i in range(iters):
        v = tris[i % NSLOT]
        e1 = [(v[3 + k] - v[k])[:, None] for k in range(3)]
        e2 = [(v[6 + k] - v[k])[:, None] for k in range(3)]
        s = [o[k][None, :] - v[k][:, None] for k in range(3)]
        s1 = [d[(k + 1) % 3][None, :] * e2[(k + 2) % 3]
              - d[(k + 2) % 3][None, :] * e2[(k + 1) % 3] for k in range(3)]
        s2 = [s[(k + 1) % 3] * e1[(k + 2) % 3]
              - s[(k + 2) % 3] * e1[(k + 1) % 3] for k in range(3)]
        denom = s1[0] * e1[0] + s1[1] * e1[1] + s1[2] * e1[2]
        inv = _inv(denom)
        t = (s2[0] * e2[0] + s2[1] * e2[1] + s2[2] * e2[2]) * inv
        b1 = (s1[0] * s[0] + s1[1] * s[1] + s1[2] * s[2]) * inv
        b2 = (s2[0] * d[0][None, :] + s2[1] * d[1][None, :]
              + s2[2] * d[2][None, :]) * inv
        bt, bi = _visit(bt, bi, t, b1, b2, denom, min_t, max_t, late)
    return torch.stack([bt, bi])


def _features(rays):
    """z [16, R]: o, d, o x d, 1, then six zeros (_mxu_kernel :104-108)."""
    o = [rays[k] for k in range(3)]
    d = [rays[3 + k] for k in range(3)]
    c = [o[(k + 1) % 3] * d[(k + 2) % 3] - o[(k + 2) % 3] * d[(k + 1) % 3]
         for k in range(3)]
    one = torch.ones_like(rays[0])
    zero = torch.zeros_like(rays[0])
    return torch.stack(o + d + c + [one] + [zero] * 6)


def mt_linear_plain(rays, amat, iters: int, late: bool = False):
    """The plain torch version of mt_linear: each row's 16 products summed
    left to right, as the kernel sums them."""
    z = _features(rays)
    min_t, max_t = rays[6], rays[7]
    r = rays.shape[1]
    bt = torch.full((r,), INF, dtype=torch.float32, device=rays.device)
    bi = torch.full((r,), -1.0, dtype=torch.float32, device=rays.device)
    for i in range(iters):
        a = amat[i % NSLOT]
        out = a[:, 0, None] * z[0][None, :]
        for q in range(1, N_FEAT):
            out = out + a[:, q, None] * z[q][None, :]
        denom, t_num, b1_num, b2_num = out.view(4, TC, r).unbind(0)
        inv = _inv(denom)
        bt, bi = _visit(bt, bi, t_num * inv, b1_num * inv, b2_num * inv,
                        denom, min_t, max_t, late)
    return torch.stack([bt, bi])


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _lib():
    """The loaded library with both entry points' ctypes signatures:
    mt_vpu(rays, tris, tri_rows, iters, late, out, n_rays, stream) and
    mt_linear(rays, amat, iters, late, out, n_rays, stream), each ->
    cudaError_t."""
    lib = _build.load(_KERNEL)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mt_vpu.argtypes = [vp, vp, i32, i32, i32, vp, i32, vp]
    lib.mt_linear.argtypes = [vp, vp, i32, i32, vp, i32, vp]
    lib.mt_vpu.restype = lib.mt_linear.restype = ctypes.c_int
    return lib


def _check(rays, table, shape_ok, what, iters):
    if rays.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"rays and {what} must be float32, got {rays.dtype}"
                        f" / {table.dtype}")
    if rays.dim() != 2 or rays.shape[0] != 8:
        raise ValueError(f"rays must be [8, R], got {tuple(rays.shape)}")
    if not shape_ok(tuple(table.shape)):
        raise ValueError(f"unexpected {what} shape {tuple(table.shape)}")
    if table.device != rays.device:
        raise ValueError(f"{what} is on {table.device}, rays on "
                         f"{rays.device}")
    if not 0 <= iters < 2 ** 31 or rays.shape[1] >= 2 ** 31 // 8:
        raise ValueError(f"iters {iters} or {rays.shape[1]} rays out of the "
                         "kernel's int32 range")


def _run(fn, rays, args, iters, late):
    rays = rays.contiguous()
    r = rays.shape[1]
    out = torch.empty((2, r), dtype=torch.float32, device=rays.device)
    with torch.cuda.device(rays.device):
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = fn(_ptr(rays), *args, int(iters), int(bool(late)), _ptr(out),
                 r, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def mt_vpu(rays, tris, iters: int, late: bool = False):
    """Best (t, index) [2, R] over `iters` visits of the vertex table: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(rays, tris, lambda s: len(s) == 3 and s[0] == NSLOT
           and s[1] >= 9 and s[2] == TC, "tris", iters)
    if rays.device.type == "cpu":
        return mt_vpu_plain(rays, tris, iters, late)
    if not rays.is_cuda:
        raise NotImplementedError(f"no K3 kernel for {rays.device}")
    tris = tris.contiguous()
    out = _run(_lib().mt_vpu, rays, (_ptr(tris), tris.shape[1]), iters, late)
    mt_vpu.launches += 1
    return out


def mt_linear(rays, amat, iters: int, late: bool = False):
    """Best (t, index) [2, R] over `iters` visits of the linear-form table:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    _check(rays, amat, lambda s: s == (NSLOT, 4 * TC, N_FEAT), "amat", iters)
    if rays.device.type == "cpu":
        return mt_linear_plain(rays, amat, iters, late)
    if not rays.is_cuda:
        raise NotImplementedError(f"no K3 kernel for {rays.device}")
    amat = amat.contiguous()
    if amat.data_ptr() % 16:
        raise ValueError("amat must be 16-byte aligned (float4 loads)")
    out = _run(_lib().mt_linear, rays, (_ptr(amat),), iters, late)
    mt_linear.launches += 1
    return out


mt_vpu.launches = 0
mt_linear.launches = 0
