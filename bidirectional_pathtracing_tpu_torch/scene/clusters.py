"""Two-level triangle clustering for the large-scene kernel.

A port of bidirectional_pathtracing_tpu/scene/clusters.py (flat layout,
:71-92 and :133-228).  The reference makes large meshes tractable with a
recursive BVH (reference src/scene/bvh.cpp:51-129 build, :161-188
traversal); the kernel walks a shallow two-level cut of the same BVH
instead:

  - a BVH with max_leaf_size = CLUSTER_SIZE is built on the host
    (scene/bvh.py build_nodes: the native C++ builder first, as in the
    JAX package (:150-153), numpy where g++ is missing; SAH split by
    default); every leaf becomes a "cluster" of up to CLUSTER_SIZE
    triangles with a tight AABB,
  - clusters are packed contiguously; padding slots hold zero triangles,
    which Möller–Trumbore can never hit,
  - consecutive clusters (spatially coherent in BVH pre-order) are grouped
    into BLOCKS of BLOCK_SIZE clusters with merged AABBs.

The kernel (ops/intersect_clustered.py, csrc/clustered_hit.cu) slab-tests
each block's AABB, then the member clusters' AABBs, and runs
Möller–Trumbore only on the clusters a ray's segment cuts.

Differences from the JAX package's tables: `tris` keeps only the 9 vertex
rows ([C, 9, CLUSTER_SIZE]; rows 9..15 there are TPU DMA padding), and the
paired 64-triangle layout (PairedClusteredTris) is not ported: it exists
only because Mosaic cannot slice under 128 lanes.  The JAX package's
environment knobs become the `build=` argument with its default.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.scene import bvh as bvh_mod

CLUSTER_SIZE = 128   # triangles per cluster
BLOCK_SIZE = 128     # clusters per block


class ClusteredTris(NamedTuple):
    """Tables of the two-level clustered intersection kernel."""

    block_b: torch.Tensor     # f32 [NBpad, 8]: lo.xyz, hi.xyz, 2 pad lanes
    cluster_b: torch.Tensor   # f32 [8, Cpad]:  rows lo.xyz, hi.xyz, 2 pad
    tris: torch.Tensor        # f32 [C, 9, CLUSTER_SIZE]: v0/v1/v2 xyz rows
    pad2global: torch.Tensor  # int32 [C*CLUSTER_SIZE] global tri id or -1

    @property
    def n_clusters(self) -> int:
        return self.tris.shape[0]

    @property
    def n_blocks(self) -> int:
        return -(-self.tris.shape[0] // BLOCK_SIZE)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _tri_bounds(geom):
    """(lo, hi [n, 3] float64, global ids [n] int32, tri_p [T, 3, 3]
    float32) of a Geometry's valid triangles, the input of the cut's BVH
    build; None when there is none."""
    tri_p = bvh_mod._host(geom.tri_p).astype(np.float32)
    tv = bvh_mod._host(geom.tri_valid).astype(bool)
    ids = np.arange(tri_p.shape[0], dtype=np.int32)[tv]
    if ids.size == 0:
        return None
    lo = tri_p[tv].min(axis=1).astype(np.float64)
    hi = tri_p[tv].max(axis=1).astype(np.float64)
    return lo, hi, ids, tri_p


def _leaf_cut(geom, leaf_size: int, build: str = "sah"):
    """Host-side BVH leaf cut: returns (leaves, bounds_lo, bounds_hi,
    prim_start, prim_count, gids, tri_p) or None when no triangles.
    build: "midpoint" | "sah"."""
    if build not in ("midpoint", "sah"):
        raise ValueError(f"unknown cluster build {build!r}")
    tb = _tri_bounds(geom)
    if tb is None:
        return None
    lo, hi, ids, tri_p = tb
    (bounds_lo, bounds_hi, is_leaf, prim_start, prim_count, _escape,
     order) = bvh_mod.build_nodes(lo, hi, leaf_size, sah=build == "sah")
    gids = ids[order]  # leaf-ordered global triangle ids
    leaves = np.where(is_leaf)[0]
    return leaves, bounds_lo, bounds_hi, prim_start, prim_count, gids, tri_p


def build_clusters(geom, build: str = "sah", device=None):
    """Build the flat two-level cut (midpoint or SAH leaf cut, _leaf_cut)
    with CLUSTER_SIZE triangles per cluster and BLOCK_SIZE clusters per
    block, the sizes the kernel is compiled for.

    geom: a Geometry of torch tensors or numpy arrays.  Returns
    ClusteredTris on `device` (default: the device of geom.tri_p, else the
    CPU), or None when the scene has no valid triangle.
    """
    if device is None:
        device = geom.tri_p.device if isinstance(
            geom.tri_p, torch.Tensor) else "cpu"
    cut = _leaf_cut(geom, CLUSTER_SIZE, build)
    if cut is None:
        return None
    leaves, bounds_lo, bounds_hi, prim_start, prim_count, gids, tri_p = cut
    c_count = len(leaves)

    pad2global = np.full((c_count * CLUSTER_SIZE,), -1, np.int32)
    tris = np.zeros((c_count, 9, CLUSTER_SIZE), np.float32)
    c_pad = max(_ceil_to(c_count, BLOCK_SIZE), BLOCK_SIZE)
    cb = np.zeros((8, c_pad), np.float32)
    cb[0:3, :] = np.inf          # padding clusters: inverted AABB, never hit
    cb[3:6, :] = -np.inf
    for ci, node in enumerate(leaves):
        s, n = int(prim_start[node]), int(prim_count[node])
        sel = gids[s:s + n]
        pad2global[ci * CLUSTER_SIZE:ci * CLUSTER_SIZE + n] = sel
        tris[ci, :, :n] = tri_p[sel].reshape(n, 9).T
        cb[0:3, ci] = bounds_lo[node]
        cb[3:6, ci] = bounds_hi[node]

    n_blocks = -(-c_count // BLOCK_SIZE)
    nb_pad = max(_ceil_to(n_blocks, 8), 8)
    bb = np.zeros((nb_pad, 8), np.float32)
    bb[:, 0:3] = np.inf
    bb[:, 3:6] = -np.inf
    for b in range(n_blocks):
        s = b * BLOCK_SIZE
        e = min(s + BLOCK_SIZE, c_count)
        bb[b, 0:3] = cb[0:3, s:e].min(axis=1)
        bb[b, 3:6] = cb[3:6, s:e].max(axis=1)

    def conv(a):
        return torch.from_numpy(a).to(device)

    return ClusteredTris(block_b=conv(bb), cluster_b=conv(cb),
                         tris=conv(tris), pad2global=conv(pad2global))
