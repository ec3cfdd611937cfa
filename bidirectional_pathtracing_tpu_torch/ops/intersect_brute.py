"""Brute-force closest hit: the hand-written CUDA kernel csrc/brute_hit.cu,
its plain torch version, and the winner resolve.

Port of bidirectional_pathtracing_tpu/ops/intersect_pallas.py.  The kernel
tests every ray against every triangle and sphere of the scene and returns
(t, prim): t = 1e30 on a miss, prim an int32 global primitive id (-1 on a
miss, num_tris + q for sphere q).  brute_hit is the wrapper:

  - for CPU tensors it returns the plain version, brute_hit_plain (the
    chunked torch `intersect` of ops/intersect.py read as (t, prim));
  - for CUDA tensors it launches the kernel or raises.  There is no
    fallback.  It raises on rays or windows that require grad: the
    kernel has no backward (ops/intersect.py refuse_grad).

brute_hit.launches counts the kernel launches of this process.  The
kernel's [T, 9] / [Q, 5] tables are built once per geometry, with a host
copy: tables within param_caps() go to the kernel by value, as a kernel
parameter; larger ones are read from device memory.

intersect_brute resolves the winner (barycentric normal and material for a
triangle, analytic normal and material for a sphere) with plain gathers;
the TPU kernel's one-hot matmul resolve is a TPU workaround and is not
ported.
"""

from __future__ import annotations

import ctypes

import torch

from bidirectional_pathtracing_tpu_torch.core.math import INF_D
from bidirectional_pathtracing_tpu_torch.ops import _build
from bidirectional_pathtracing_tpu_torch.ops._memo import last_of
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    Hit, _cross3, _dot3, _unit, _window, intersect, refuse_grad)
from bidirectional_pathtracing_tpu_torch.scene.types import Geometry

_KERNEL = "brute_hit"


def make_tri_soa(geom: Geometry):
    """[T, 9] triangle table (v0, e1 = v1 - v0, e2 = v2 - v0), f32,
    contiguous; invalid triangles are zero rows (denominator 0: no hit)."""
    p = torch.where(geom.tri_valid[:, None, None], geom.tri_p, 0.0)
    return torch.cat([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]],
                     dim=1).to(torch.float32).contiguous()


def make_sph_soa(geom: Geometry):
    """[Q, 5] sphere table (cx cy cz r valid), f32, contiguous."""
    return torch.cat([geom.sph_c, geom.sph_r[:, None],
                      geom.sph_valid[:, None].to(torch.float32)],
                     dim=1).to(torch.float32).contiguous()


def _build_tables(geom: Geometry):
    tri, sph = make_tri_soa(geom), make_sph_soa(geom)
    host = torch.cat([tri.reshape(-1), sph.reshape(-1)]).cpu()
    return tri, sph, host


# (make_tri_soa, make_sph_soa, their host copy packed [T*9 + Q*5] f32) of a
# geometry, built once per geometry (ops/_memo.py): one device-to-host copy
# per geometry, not one per launch
_tables = last_of(lambda g: (g.tri_p, g.tri_valid, g.sph_c, g.sph_r,
                             g.sph_valid), _build_tables)


def brute_hit_plain(geom: Geometry, o, d, min_t, max_t):
    """The plain torch version: (t [R] f32, prim [R] int32)."""
    hit = intersect(geom, o, d, min_t, max_t)
    return hit.t, hit.prim


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _kernel():
    """The C entry point, built on first use, with its ctypes signature:
    (o, d, min_t, max_t, tris, n_tris, sph, n_sph, prim_base, host_tables,
    t_out, prim_out, n_rays, stream) -> cudaError_t."""
    fn = _build.load(_KERNEL).brute_hit
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, i32, vp, i32, i32, vp, vp, vp, i32,
                   vp]
    fn.restype = ctypes.c_int
    return fn


def param_caps() -> tuple[int, int]:
    """(triangles, spheres): the largest tables the kernel takes as a
    parameter (brute_hit_param_caps; set by the CUDA toolkit's version)."""
    if param_caps.caps is None:
        lib = _build.load(_KERNEL)
        n_t, n_q = ctypes.c_int(), ctypes.c_int()
        lib.brute_hit_param_caps(ctypes.byref(n_t), ctypes.byref(n_q))
        param_caps.caps = (n_t.value, n_q.value)
    return param_caps.caps


param_caps.caps = None


def _launch(geom: Geometry, o, d, min_t, max_t):
    refuse_grad("brute_hit", o=o, d=d, min_t=min_t, max_t=max_t)
    r = o.shape[0]
    dev = o.device
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"rays must be float32, got {o.dtype} / {d.dtype}")
    if o.shape != (r, 3) or d.shape != (r, 3):
        raise ValueError(f"o, d must be [R, 3], got {tuple(o.shape)} "
                         f"and {tuple(d.shape)}")
    if r >= 2 ** 31 // 3:
        raise ValueError(f"{r} rays overflow the kernel's int32 indexing")
    o = o.contiguous()
    d = d.contiguous()
    lo = _window(min_t, r, o).contiguous()
    hi = _window(max_t, r, o).contiguous()
    tris, sph, host = _tables(geom)
    for name, x in (("d", d), ("min_t", lo), ("max_t", hi), ("tris", tris),
                    ("spheres", sph)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
    cap_t, cap_q = param_caps()
    by_value = tris.shape[0] <= cap_t and sph.shape[0] <= cap_q
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    prim = torch.empty((r,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(o), _ptr(d), _ptr(lo), _ptr(hi), _ptr(tris),
                 tris.shape[0], _ptr(sph), sph.shape[0], geom.num_tris,
                 _ptr(host) if by_value else None, _ptr(t), _ptr(prim), r,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"brute_hit kernel launch failed: CUDA error {err}")
    brute_hit.launches += 1
    return t, prim


def brute_hit(geom: Geometry, o, d, min_t, max_t):
    """Closest hit (t [R] f32, prim [R] int32) of every ray against every
    primitive: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if o.is_cuda:
        return _launch(geom, o, d, min_t, max_t)
    if o.device.type != "cpu":
        raise NotImplementedError(f"no brute-force kernel for {o.device}")
    return brute_hit_plain(geom, o, d, min_t, max_t)


brute_hit.launches = 0


def resolve(geom: Geometry, o, d, t, prim) -> Hit:
    """Hit record for kernel output (t, prim): the winning triangle's
    barycentric normal and material, or the winning sphere's analytic
    normal and material, by plain gathers."""
    num_t = geom.num_tris
    found = (prim >= 0) & (t < INF_D)
    sph_hit = found & (prim >= num_t)
    tri_hit = found & (prim < num_t)
    tid = torch.clamp(prim, 0, num_t - 1).long()

    tp = geom.tri_p[tid]
    p0, e1, e2 = tp[:, 0], tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]
    s = o - p0
    s1 = _cross3(d, e2)
    s2 = _cross3(s, e1)
    den = _dot3(s1, e1)
    inv = torch.where(den == 0, 0.0, 1.0 / torch.where(den == 0, 1.0, den))
    b1 = (_dot3(s1, s) * inv)[:, None]
    b2 = (_dot3(s2, d) * inv)[:, None]
    tn = geom.tri_n[tid]
    n_tri = _unit(tn[:, 0] * (1.0 - b1 - b2) + tn[:, 1] * b1 + tn[:, 2] * b2)

    best_t = torch.where(found, t, INF_D)
    best_n = torch.where(tri_hit[:, None], n_tri, 0.0)
    best_mat = torch.where(tri_hit, geom.tri_mat[tid], -1)
    best_prim = torch.where(found, prim, -1)

    if geom.num_spheres > 0:
        qid = torch.clamp(prim - num_t, 0, geom.num_spheres - 1).long()
        n_sph = _unit(o + best_t[:, None] * d - geom.sph_c[qid])
        best_n = torch.where(sph_hit[:, None], n_sph, best_n)
        best_mat = torch.where(sph_hit, geom.sph_mat[qid], best_mat)
    return Hit(t=best_t, valid=best_t < INF_D, n=best_n,
               mat=best_mat.to(torch.int32), prim=best_prim.to(torch.int32))


def intersect_brute(geom: Geometry, o, d, min_t, max_t) -> Hit:
    """Closest hit through brute_hit, with the winner resolved."""
    t, prim = brute_hit(geom, o, d, min_t, max_t)
    return resolve(geom, o, d, t, prim)
