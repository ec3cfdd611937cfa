"""Struct-of-arrays scene schema as NamedTuples of torch tensors.

Mirrors bidirectional_pathtracing_tpu/scene/types.py field for field, so a
scene built by either package carries the same leaves:

  - SceneObjects::Scene{objects, lights}      reference src/scene/scene.h:65-94
  - Triangle / Sphere primitives              src/scene/{triangle,sphere}.h
  - BSDF subclasses (6 kinds)                 src/pathtracer/bsdf.h:132-304
  - SceneLight implementations                src/scene/light.h:16-182
  - Camera                                    src/pathtracer/camera.h:18-126

The host-side builders make_geometry / make_materials / make_lights are
copies of the JAX package's numpy code (scene/types.py:168-263), kept
jax-free so the port runs where jax is not installed.  from_numpy builds a
Scene from the JAX scene's leaves converted with np.asarray, so both
packages compute on identical numbers.

The cluster tables (scene/clusters.py ClusteredTris) and the environment
map (Envmap) ride along in both: a JAX scene with flat clusters or an
envmap converts leaf by leaf.

The builders put their tensors on the card unless the caller names another
device (device="cpu" in the CPU tests); without a card they raise.

BVHArrays (scene/bvh.py build_bvh) is the flattened BVH the escape-link
walk reads (ops/intersect.py intersect_bvh, ops/intersect_bvh.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Material kinds (matching the 6 reference BSDF classes, bsdf.h:132-304)
MAT_DIFFUSE = 0
MAT_EMISSION = 1
MAT_MIRROR = 2
MAT_REFRACTION = 3
MAT_GLASS = 4
MAT_MICROFACET = 5

# Light kinds (light.h:16-182; env light handled separately)
LIGHT_AREA = 0
LIGHT_POINT = 1
LIGHT_DIRECTIONAL = 2
LIGHT_HEMISPHERE = 3
LIGHT_SPOT = 4


class Materials(NamedTuple):
    """Material table; every field has leading dim M."""

    kind: torch.Tensor           # int32 [M]
    albedo: torch.Tensor         # f32 [M,3]  diffuse reflectance
    emission: torch.Tensor       # f32 [M,3]  emission radiance
    reflectance: torch.Tensor    # f32 [M,3]  mirror/glass
    transmittance: torch.Tensor  # f32 [M,3]  refraction/glass
    ior: torch.Tensor            # f32 [M]
    roughness: torch.Tensor      # f32 [M]    microfacet alpha
    eta: torch.Tensor            # f32 [M,3]  microfacet conductor eta
    k: torch.Tensor              # f32 [M,3]  microfacet conductor k

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Geometry(NamedTuple):
    """World-space triangle soup + analytic spheres, padded to static sizes;
    *_valid masks mark real primitives.  Global primitive ids are [0, T)
    triangles then [T, T+Q) spheres."""

    tri_p: torch.Tensor       # f32 [T,3,3]  vertices p0,p1,p2
    tri_n: torch.Tensor       # f32 [T,3,3]  vertex normals n0,n1,n2
    tri_mat: torch.Tensor     # int32 [T]
    tri_valid: torch.Tensor   # bool [T]
    sph_c: torch.Tensor       # f32 [Q,3]
    sph_r: torch.Tensor       # f32 [Q]
    sph_mat: torch.Tensor     # int32 [Q]
    sph_valid: torch.Tensor   # bool [Q]

    @property
    def num_tris(self) -> int:
        return self.tri_p.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_c.shape[0]


class Lights(NamedTuple):
    """Light table; leading dim L.  Fields are interpreted per kind:

    AREA   (light.cpp:197-284): radiance, position, direction (normal),
           dim_x, dim_y, area = |dim_x| |dim_y|
    POINT  (light.cpp:100-153): radiance, position
    DIRECTIONAL (light.cpp:9-51): radiance, direction = dir_to_light
    HEMISPHERE  (light.cpp:53-98): radiance
    """

    kind: torch.Tensor       # int32 [L]
    radiance: torch.Tensor   # f32 [L,3]
    position: torch.Tensor   # f32 [L,3]
    direction: torch.Tensor  # f32 [L,3]
    dim_x: torch.Tensor      # f32 [L,3]
    dim_y: torch.Tensor      # f32 [L,3]
    area: torch.Tensor       # f32 [L]

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Camera(NamedTuple):
    """Pinhole (+thin lens) camera; camera.h:18-126.

    c2w columns are (right, up, back): the view direction is c2w @ (0,0,-1).
    hfov/vfov are in degrees (post aspect correction, camera.cpp:29-47).
    """

    c2w: torch.Tensor      # f32 [3,3]
    pos: torch.Tensor      # f32 [3]
    hfov: torch.Tensor     # f32 [] degrees
    vfov: torch.Tensor     # f32 [] degrees
    nclip: torch.Tensor    # f32 []
    fclip: torch.Tensor    # f32 []
    lens_radius: torch.Tensor     # f32 []
    focal_distance: torch.Tensor  # f32 []


class BVHArrays(NamedTuple):
    """Flattened BVH in pre-order with escape links (stackless traversal);
    a copy of the JAX package's scene/types.py BVHArrays (:129-143).

    Built host-side with the reference algorithm (spatial-midpoint split on
    the largest-extent centroid axis, leaves <= max_leaf_size; bvh.cpp:51-129)
    then linearised: node i's subtree occupies [i, escape[i]).
    """

    bounds_lo: torch.Tensor   # f32 [N,3]
    bounds_hi: torch.Tensor   # f32 [N,3]
    is_leaf: torch.Tensor     # bool [N]
    prim_start: torch.Tensor  # int32 [N]  index into prim_order
    prim_count: torch.Tensor  # int32 [N]
    escape: torch.Tensor      # int32 [N]  next pre-order node when skipping
    prim_order: torch.Tensor  # int32 [P]  global prim ids in leaf order


class Envmap(NamedTuple):
    """HDR environment map with 2-stage CDF importance sampling
    (environment_light.cpp:18-62); built by ops/envlight.py build_envmap."""

    data: torch.Tensor             # f32 [H,W,3]
    pdf: torch.Tensor              # f32 [H,W]  solid-angle-marginalised pdf
    marginal_cdf: torch.Tensor     # f32 [H]
    conditional_cdf: torch.Tensor  # f32 [H,W]


class Scene(NamedTuple):
    geometry: Geometry
    materials: Materials
    lights: Lights
    camera: Camera
    bvh: Optional[object] = None
    envmap: Optional[object] = None
    clusters: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.geometry.tri_p.device


def tensors(x):
    """Every tensor of a (nested) NamedTuple such as a Scene."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from tensors(v)


def needs_grad(scene: Scene) -> bool:
    """Whether autograd records a pass over the scene: grad mode is on and
    a scene tensor requires grad (utils/step_graph.py route,
    takes_kernels)."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors(scene))


def takes_kernels(scene: Scene, device) -> bool:
    """Whether a BDPT pass over the scene on `device` takes the integrator's
    hand-written kernels (ops/walk.py, ops/connect.py route): on CUDA, with
    nothing needing a gradient; else their op chains, the CPU's and
    autograd's path."""
    return torch.device(device).type == "cuda" and not needs_grad(scene)


_PARTS = (("geometry", Geometry), ("materials", Materials),
          ("lights", Lights), ("camera", Camera))


def to_numpy(scene: Scene) -> dict[str, np.ndarray]:
    """Flatten a Scene to {"geometry.tri_p": array, ...} (host copies),
    with "clusters.<field>" leaves when cluster tables are attached and
    "envmap.<field>" leaves when an envmap is."""
    parts = list(_PARTS)
    if scene.clusters is not None:
        parts.append(("clusters", type(scene.clusters)))
    if scene.envmap is not None:
        parts.append(("envmap", Envmap))
    out = {}
    for part, cls in parts:
        sub = getattr(scene, part)
        for f in cls._fields:
            out[f"{part}.{f}"] = getattr(sub, f).detach().cpu().numpy()
    return out


def from_numpy(arrays: dict[str, np.ndarray], device) -> Scene:
    """Build a Scene from {"<part>.<field>": ndarray} leaves.

    The keys are those of to_numpy; a JAX Scene converts to the same dict
    with np.asarray leaf by leaf.  Values keep their dtypes (f32 / int32 /
    bool).  "clusters.*" leaves of the flat layout become ClusteredTris; a
    JAX table's `tris` [C, 16, 128] is cut to its 9 vertex rows (rows
    9..15 are TPU DMA padding).  The paired layout (a "clusters.sub_marker"
    leaf) is not ported and raises.  "envmap.*" leaves become an Envmap.
    A BVH is not read.
    """
    from bidirectional_pathtracing_tpu_torch.scene.clusters import (
        ClusteredTris)
    dev = torch.device(device)

    def conv(a):
        return torch.from_numpy(np.array(a)).to(dev)

    parts = {}
    for part, cls in _PARTS:
        parts[part] = cls(**{f: conv(arrays[f"{part}.{f}"])
                             for f in cls._fields})
    if "clusters.sub_marker" in arrays:
        raise ValueError("the paired cluster layout is not ported; build "
                         "the JAX tables with paired=False")
    if "clusters.tris" in arrays:
        leaves = {f: arrays[f"clusters.{f}"] for f in ClusteredTris._fields}
        leaves["tris"] = np.asarray(leaves["tris"])[:, :9]
        parts["clusters"] = ClusteredTris(**{f: conv(a)
                                             for f, a in leaves.items()})
    if "envmap.data" in arrays:
        parts["envmap"] = Envmap(**{f: conv(arrays[f"envmap.{f}"])
                                    for f in Envmap._fields})
    return Scene(**parts)


def _pad_to(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def make_geometry(tri_p, tri_n, tri_mat, sph_c=None, sph_r=None, sph_mat=None,
                  min_tris: int = 1, min_spheres: int = 1,
                  device="cuda") -> Geometry:
    """Build padded Geometry from numpy arrays (copy of the JAX package's
    scene/types.py make_geometry, :175-210)."""
    tri_p = np.asarray(tri_p, np.float32).reshape(-1, 3, 3)
    tri_n = np.asarray(tri_n, np.float32).reshape(-1, 3, 3)
    tri_mat = np.asarray(tri_mat, np.int32).reshape(-1)
    t = tri_p.shape[0]
    tp = max(t, min_tris)
    tri_valid = np.arange(tp) < t
    if sph_c is None:
        sph_c = np.zeros((0, 3), np.float32)
        sph_r = np.zeros((0,), np.float32)
        sph_mat = np.zeros((0,), np.int32)
    sph_c = np.asarray(sph_c, np.float32).reshape(-1, 3)
    sph_r = np.asarray(sph_r, np.float32).reshape(-1)
    sph_mat = np.asarray(sph_mat, np.int32).reshape(-1)
    q = sph_c.shape[0]
    qp = max(q, min_spheres)
    sph_valid = np.arange(qp) < q

    def conv(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Geometry(
        tri_p=conv(_pad_to(tri_p, tp)),
        tri_n=conv(_pad_to(tri_n, tp)),
        tri_mat=conv(_pad_to(tri_mat, tp)),
        tri_valid=conv(tri_valid),
        sph_c=conv(_pad_to(sph_c, qp)),
        sph_r=conv(_pad_to(sph_r, qp, fill=-1.0)),
        sph_mat=conv(_pad_to(sph_mat, qp)),
        sph_valid=conv(sph_valid),
    )


def _table(records, rows: int, name: str, dim: int, default, device):
    out = np.full((rows, dim) if dim > 1 else (rows,), default, np.float32)
    for i, r in enumerate(records):
        if name in r:
            out[i] = r[name]
    return torch.from_numpy(out).to(device)


def make_materials(records, device="cuda") -> Materials:
    """records: list of dicts with keys kind + per-kind params (copy of
    scene/types.py make_materials, :213-237)."""
    m = max(len(records), 1)
    kind = np.zeros((m,), np.int32)
    for i, r in enumerate(records):
        kind[i] = r["kind"]

    def field(name, dim, default):
        return _table(records, m, name, dim, default, device)

    return Materials(
        kind=torch.from_numpy(kind).to(device),
        albedo=field("albedo", 3, 0.0),
        emission=field("emission", 3, 0.0),
        reflectance=field("reflectance", 3, 0.0),
        transmittance=field("transmittance", 3, 0.0),
        ior=field("ior", 1, 1.45),
        roughness=field("roughness", 1, 0.1),
        eta=field("eta", 3, 1.0),
        k=field("k", 3, 0.0),
    )


def make_lights(records, device="cuda") -> Lights:
    """Light table (copy of scene/types.py make_lights, :240-263).  No
    padding: a scene with zero lights gets zero-length tensors."""
    ell = len(records)
    kind = np.full((ell,), -1, np.int32)
    for i, r in enumerate(records):
        kind[i] = r["kind"]

    def field(name, dim, default):
        return _table(records, ell, name, dim, default, device)

    return Lights(
        kind=torch.from_numpy(kind).to(device),
        radiance=field("radiance", 3, 0.0),
        position=field("position", 3, 0.0),
        direction=field("direction", 3, 0.0),
        dim_x=field("dim_x", 3, 0.0),
        dim_y=field("dim_y", 3, 0.0),
        area=field("area", 1, 1.0),
    )
