"""The escape-link BVH walk: the hand-written CUDA kernel csrc/bvh_walk.cu
and its plain torch version.

The counterpart of the JAX package's intersect_bvh (ops/intersect.py:
270-383), whose `lax.while_loop` walks the tree on the device: the route
of a scene above the brute-force kernel's triangle cap with a BVH and no
cluster tables (ops/intersect.py kernel_route "bvh").  It is not the port
of a Pallas kernel.  bvh_walk is the wrapper:

  - for CPU tensors it returns the plain version, ops/intersect.py
    intersect_bvh;
  - for CUDA tensors it launches the kernel or raises.  There is no
    fallback.  It raises on rays or windows that require grad: the kernel
    has no backward (ops/intersect.py refuse_grad).

Closest hit returns the Hit record (t, valid, n, mat, prim) as the plain
version does; any hit a bool [R].  The kernel equals the plain version bit
for bit on t, valid, mat, prim and the any hit; its normal differs from the
plain one by rounding at most (csrc/bvh_walk.cu says why).

bvh_walk.launches counts the kernel launches of this process.  The
kernel's tables (the tree's arrays and the geometry's, contiguous, f32 /
int32 / uint8) are built once per scene (ops/_memo.py).
"""

from __future__ import annotations

import ctypes

import torch

from bidirectional_pathtracing_tpu_torch.ops import _build
from bidirectional_pathtracing_tpu_torch.ops._memo import last_of
from bidirectional_pathtracing_tpu_torch.ops.intersect import (
    Hit, _window, intersect_bvh, refuse_grad)
from bidirectional_pathtracing_tpu_torch.scene.types import Geometry

_KERNEL = "bvh_walk"


def _build_tables(key):
    """The kernel's tables, in its argument order: the tree (bounds_lo,
    bounds_hi, is_leaf as uint8, prim_start, prim_count, escape,
    prim_order) and the geometry (tri_p [T, 9], tri_n [T, 9], tri_mat,
    sph [Q, 4] = (c, r), sph_mat)."""
    geom, bvh = key
    f32, i32 = torch.float32, torch.int32

    def c(x, dtype):
        return x.to(dtype).contiguous()

    t = geom.num_tris
    return (c(bvh.bounds_lo, f32), c(bvh.bounds_hi, f32),
            c(bvh.is_leaf, torch.uint8), c(bvh.prim_start, i32),
            c(bvh.prim_count, i32), c(bvh.escape, i32),
            c(bvh.prim_order, i32),
            c(geom.tri_p.reshape(t, 9), f32), c(geom.tri_n.reshape(t, 9), f32),
            c(geom.tri_mat, i32),
            c(torch.cat([geom.sph_c, geom.sph_r[:, None]], dim=1), f32),
            c(geom.sph_mat, i32))


# the tables of the last (geometry, BVH) seen, built again only when one of
# their tensors is another object or was modified in place
_tables = last_of(lambda key: (*key[0], *key[1]), _build_tables)


def _ptr(x: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _kernel():
    """The C entry point, built on first use, with its ctypes signature:
    (o, d, min_t, max_t, n_rays, bounds_lo, bounds_hi, is_leaf,
    prim_start, prim_count, escape, prim_order, n_nodes, tri_p, tri_n,
    tri_mat, n_tris, sph, sph_mat, any_hit, t, valid, n, mat, prim,
    stream) -> cudaError_t."""
    fn = _build.load(_KERNEL).bvh_walk
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([vp] * 4 + [i32] + [vp] * 7 + [i32] + [vp] * 3 + [i32]
                   + [vp] * 2 + [i32] + [vp] * 6)
    fn.restype = ctypes.c_int
    return fn


def _launch(geom: Geometry, bvh, o, d, min_t, max_t, any_hit: bool):
    refuse_grad("bvh_walk", o=o, d=d, min_t=min_t, max_t=max_t)
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
    tables = _tables((geom, bvh))
    for name, x in (("d", d), ("min_t", lo), ("max_t", hi),
                    ("bvh", tables[0]), ("geometry", tables[7])):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
    (b_lo, b_hi, leaf, start, count, escape, order,
     tri_p, tri_n, tri_mat, sph, sph_mat) = tables
    valid = torch.empty((r,), dtype=torch.bool, device=dev)
    t = n = mat = prim = None      # an any hit writes valid only
    if not any_hit:
        t = torch.empty((r,), dtype=torch.float32, device=dev)
        n = torch.empty((r, 3), dtype=torch.float32, device=dev)
        mat = torch.empty((r,), dtype=torch.int32, device=dev)
        prim = torch.empty((r,), dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(o), _ptr(d), _ptr(lo), _ptr(hi), r,
                 _ptr(b_lo), _ptr(b_hi), _ptr(leaf), _ptr(start),
                 _ptr(count), _ptr(escape), _ptr(order), leaf.shape[0],
                 _ptr(tri_p), _ptr(tri_n), _ptr(tri_mat), geom.num_tris,
                 _ptr(sph), _ptr(sph_mat), int(any_hit),
                 _ptr(t), _ptr(valid), _ptr(n), _ptr(mat), _ptr(prim),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bvh_walk kernel launch failed: CUDA error {err}")
    bvh_walk.launches += 1
    if any_hit:
        return valid
    return Hit(t=t, valid=valid, n=n, mat=mat, prim=prim)


def bvh_walk(geom: Geometry, bvh, o, d, min_t, max_t, any_hit: bool = False):
    """Closest hit (Hit) or any hit (bool [R]) of rays o, d [R, 3] over
    [min_t, max_t] (scalars or [R]) by the escape-link walk of `bvh`: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.is_cuda:
        return _launch(geom, bvh, o, d, min_t, max_t, any_hit)
    if o.device.type != "cpu":
        raise NotImplementedError(f"no BVH walk kernel for {o.device}")
    return intersect_bvh(geom, bvh, o, d, min_t, max_t, any_hit=any_hit)


bvh_walk.launches = 0
