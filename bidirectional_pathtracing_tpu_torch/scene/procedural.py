"""Procedural test scenes (no .dae required).

make_cornell_box is a copy of bidirectional_pathtracing_tpu/scene/
procedural.py make_cornell_box (:26-101), building the same arrays leaf by
leaf and bit for bit, as torch tensors on `device`.  make_mesh_cornell_box
is the same box with icosphere meshes in place of the spheres, the port's
large-scene configuration; mesh_cornell_box_arrays gives its raw arrays.
synthetic_sky and make_open_env_scene are copies of the JAX package's
examples/inverse_rendering.py `_env_image` fallback (:49-58) and
`_open_scene` (:61-95): the environment-lit scene both packages can build
(the repository's .exr files are git-lfs stubs).

Every builder puts its tensors on the card unless the caller names another
device.
"""

from __future__ import annotations

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.scene.types import (
    Camera, Scene, LIGHT_AREA, MAT_DIFFUSE, MAT_EMISSION, MAT_GLASS,
    MAT_MICROFACET, MAT_MIRROR, make_geometry, make_lights, make_materials,
)


def _quad(p0, p1, p2, p3, n):
    """Two triangles for a quad with a shared normal."""
    tris = [[p0, p1, p2], [p0, p2, p3]]
    norms = [[n, n, n], [n, n, n]]
    return tris, norms


def _box_records():
    """The Cornell box's walls, light quad, materials, light and camera
    values, shared by make_cornell_box and the mesh box (JAX package
    scene/procedural.py:29-99)."""
    tris, norms, mats = [], [], []

    def add_quad(p0, p1, p2, p3, n, mid):
        t, nn = _quad(np.array(p0, np.float64), np.array(p1, np.float64),
                      np.array(p2, np.float64), np.array(p3, np.float64),
                      np.array(n, np.float64))
        tris.extend(t)
        norms.extend(nn)
        mats.extend([mid, mid])

    materials = [
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.6, 0.6, 0.6])},   # 0 gray
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.6, 0.2, 0.2])},   # 1 red
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.2, 0.2, 0.6])},   # 2 blue
        {"kind": MAT_EMISSION, "emission": np.array([10.0, 10.0, 10.0])},  # 3
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.8, 0.8, 0.8])},   # 4
        {"kind": MAT_MIRROR, "reflectance": np.array([0.9, 0.9, 0.9])},  # 5
        {"kind": MAT_GLASS, "transmittance": np.array([0.9, 0.9, 0.9]),
         "reflectance": np.array([0.9, 0.9, 0.9]), "ior": 1.45},      # 6
        {"kind": MAT_MICROFACET, "roughness": 0.3,                    # 7 Al
         "eta": np.array([1.345, 0.965, 0.617]),
         "k": np.array([7.47, 6.40, 5.30])},
    ]

    # floor (y=0, normal +y), ceiling (y=1.5, -y), back (z=-1, +z),
    # left (x=-1, +x, red), right (x=1, -x, blue)
    add_quad([-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1], [0, 1, 0], 0)
    add_quad([-1, 1.5, -1], [-1, 1.5, 1], [1, 1.5, 1], [1, 1.5, -1],
             [0, -1, 0], 0)
    add_quad([-1, 0, -1], [-1, 1.5, -1], [1, 1.5, -1], [1, 0, -1],
             [0, 0, 1], 0)
    add_quad([-1, 0, -1], [-1, 0, 1], [-1, 1.5, 1], [-1, 1.5, -1],
             [1, 0, 0], 1)
    add_quad([1, 0, -1], [1, 1.5, -1], [1, 1.5, 1], [1, 0, 1],
             [-1, 0, 0], 2)
    # light quad just below the ceiling
    add_quad([-0.4, 1.49, -0.3], [0.4, 1.49, -0.3], [0.4, 1.49, 0.3],
             [-0.4, 1.49, 0.3], [0, -1, 0], 3)

    lights = [{
        "kind": LIGHT_AREA,
        "radiance": np.array([10.0, 10.0, 10.0]),
        "position": np.array([0.0, 1.49, 0.0]),
        "direction": np.array([0.0, -1.0, 0.0]),
        "dim_x": np.array([0.8, 0.0, 0.0]),
        "dim_y": np.array([0.0, 0.0, 0.6]),
        "area": 0.48,
    }]
    # camera on the +z axis looking -z, like the reference placement
    camera = {k: np.asarray(v, np.float32) for k, v in (
        ("c2w", np.eye(3)), ("pos", [0.0, 0.75, 4.0]), ("hfov", 35.0),
        ("vfov", 27.0), ("nclip", 0.01), ("fclip", 100.0),
        ("lens_radius", 0.0), ("focal_distance", 4.0))}
    return tris, norms, mats, materials, lights, camera


_MAT_NAME_TO_ID = {"diffuse": 4, "mirror": 5, "glass": 6, "microfacet": 7}
_SPH_C = [[-0.4, 0.3, -0.3], [0.4, 0.3, 0.3]]
_SPH_R = [0.3, 0.3]


def _camera(values: dict, device) -> Camera:
    return Camera(**{k: torch.from_numpy(v.copy()).to(device)
                     for k, v in values.items()})


def make_cornell_box(width: int = 120, height: int = 90,
                     sphere_materials=("diffuse", "diffuse"),
                     device="cuda") -> Scene:
    """A 2x1.5x2 Cornell box, open front (+z), two spheres, ceiling light.

    width/height are accepted for signature parity; the camera's field of
    view is fixed, as in the JAX package."""
    tris, norms, mats, materials, lights, camera = _box_records()
    sph_mat = [_MAT_NAME_TO_ID[m] for m in sphere_materials]
    geometry = make_geometry(np.array(tris), np.array(norms),
                             np.array(mats, np.int32),
                             np.array(_SPH_C), np.array(_SPH_R),
                             np.array(sph_mat, np.int32), device=device)
    return Scene(geometry=geometry,
                 materials=make_materials(materials, device=device),
                 lights=make_lights(lights, device=device),
                 camera=_camera(camera, device))


def icosphere(level: int):
    """Unit icosphere: (vertices [V,3] f64 on the unit sphere, faces [F,3]
    int64 wound counter-clockwise seen from outside), F = 20 * 4**level.
    Each level splits every face into four at the normalised edge
    midpoints."""
    g = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, g, 0), (1, g, 0), (-1, -g, 0), (1, -g, 0),
             (0, -1, g), (0, 1, g), (0, -1, -g), (0, 1, -g),
             (g, 0, -1), (g, 0, 1), (-g, 0, -1), (-g, 0, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        mids = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    return np.array(verts), np.array(faces, np.int64)


def mesh_cornell_box_arrays(sphere_level: int,
                            sphere_materials=("mirror", "glass")) -> dict:
    """The raw arrays of the mesh-sphere Cornell box (see
    make_mesh_cornell_box): tri_p / tri_n [T,3,3] f32, tri_mat [T] int32,
    the material and light records, and the camera values as f32 arrays,
    so that both packages' builders can be fed the very same numbers."""
    tris, norms, mats, materials, lights, camera = _box_records()
    unit, faces = icosphere(sphere_level)
    p = [np.array(tris)]
    n = [np.array(norms)]
    m = [np.array(mats, np.int32)]
    for c, r, name in zip(_SPH_C, _SPH_R, sphere_materials):
        dirs = unit[faces]                              # [F,3,3] unit
        p.append(np.asarray(c, np.float64) + r * dirs)
        n.append(dirs)
        m.append(np.full(faces.shape[0], _MAT_NAME_TO_ID[name], np.int32))
    return {"tri_p": np.concatenate(p).astype(np.float32),
            "tri_n": np.concatenate(n).astype(np.float32),
            "tri_mat": np.concatenate(m),
            "materials": materials, "lights": lights, "camera": camera}


def make_mesh_cornell_box(sphere_level: int = 6,
                          sphere_materials=("mirror", "glass"),
                          device="cuda") -> Scene:
    """The Cornell box of make_cornell_box with its two analytic spheres
    replaced by icosphere meshes: the same centres, radii and materials,
    smooth normals (the unit vertex directions), 20 * 4**sphere_level
    triangles per sphere and no analytic sphere (make_geometry pads one
    invalid sphere).  Level 6 gives 12 + 2 * 81,920 = 163,852 triangles,
    level 4 gives 10,252.

    It stands in for the large .dae scenes of the JAX package's bench
    (CBbunny, 28.5k triangles; the CBlucy stand-in, 457k) until their
    files are in the repository: the same Cornell-box walls around a dense
    closed mesh.  No accelerator is attached (scene/build.py
    attach_accelerator does that)."""
    a = mesh_cornell_box_arrays(sphere_level, sphere_materials)
    return Scene(
        geometry=make_geometry(a["tri_p"], a["tri_n"], a["tri_mat"],
                               device=device),
        materials=make_materials(a["materials"], device=device),
        lights=make_lights(a["lights"], device=device),
        camera=_camera(a["camera"], device))


def synthetic_sky() -> np.ndarray:
    """The 32x64 HDR sky of examples/inverse_rendering.py:49-58 (f32
    [32,64,3]): a blue-to-warm gradient over theta and a sun blob of
    radiance 30 at (x, y) = (16, 8)."""
    hh, ww = 32, 64
    y, x = np.mgrid[0:hh, 0:ww]
    theta = (y + 0.5) / hh * np.pi
    img = np.zeros((hh, ww, 3), np.float32)
    img[..., 2] = 0.5 + 0.4 * np.cos(theta)
    img[..., 1] = 0.35 + 0.2 * np.cos(theta)
    img[..., 0] = 0.25 + 0.1 * np.sin(theta)
    blob = np.exp(-(((x - ww / 4) / 2.5) ** 2 + ((y - hh / 4) / 2.5) ** 2))
    img += 30.0 * blob[..., None] * np.array([1.0, 0.95, 0.8], np.float32)
    return img


def make_open_env_scene(device="cuda") -> Scene:
    """An open scene lit only by an environment map: an 8x8 ground quad
    and two diffuse spheres, no lights (examples/inverse_rendering.py
    :61-95), with synthetic_sky() attached as its envmap."""
    from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
    s = 4.0
    tri_p, tri_n = _quad(np.array([-s, 0, s]), np.array([s, 0, s]),
                         np.array([s, 0, -s]), np.array([-s, 0, -s]),
                         np.array([0.0, 1.0, 0.0]))
    geometry = make_geometry(
        np.asarray(tri_p), np.asarray(tri_n), np.zeros(len(tri_p), np.int32),
        sph_c=np.array([[-0.8, 0.6, 0.0], [0.9, 0.45, 0.6]]),
        sph_r=np.array([0.6, 0.45]), sph_mat=np.array([1, 2], np.int32),
        device=device)
    materials = make_materials([
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.55, 0.5, 0.45])},
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.7, 0.25, 0.2])},
        {"kind": MAT_DIFFUSE, "albedo": np.array([0.2, 0.35, 0.7])},
    ], device=device)
    pos = np.array([0.0, 1.6, 5.0])
    back = pos - np.array([0.0, 0.7, 0.0])
    back = back / np.linalg.norm(back)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    camera = {k: np.asarray(v, np.float32) for k, v in (
        ("c2w", np.stack([right, up, back], axis=1)), ("pos", pos),
        ("hfov", 50.0), ("vfov", 38.0), ("nclip", 0.1), ("fclip", 100.0),
        ("lens_radius", 0.0), ("focal_distance", 4.7))}
    return Scene(geometry=geometry, materials=materials,
                 lights=make_lights([], device=device),
                 camera=_camera(camera, device),
                 envmap=build_envmap(synthetic_sky(), device=device))
