"""Procedural test scenes (no .dae required).

make_cornell_box is a copy of bidirectional_pathtracing_tpu/scene/
procedural.py make_cornell_box (:26-101), building the same arrays leaf by
leaf and bit for bit, as torch tensors on `device`.
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


def make_cornell_box(width: int = 120, height: int = 90,
                     sphere_materials=("diffuse", "diffuse"),
                     device="cpu") -> Scene:
    """A 2x1.5x2 Cornell box, open front (+z), two spheres, ceiling light.

    width/height are accepted for signature parity; the camera's field of
    view is fixed, as in the JAX package."""
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

    mat_name_to_id = {"diffuse": 4, "mirror": 5, "glass": 6,
                      "microfacet": 7}
    sph_c = [[-0.4, 0.3, -0.3], [0.4, 0.3, 0.3]]
    sph_r = [0.3, 0.3]
    sph_mat = [mat_name_to_id[m] for m in sphere_materials]

    geometry = make_geometry(np.array(tris), np.array(norms),
                             np.array(mats, np.int32),
                             np.array(sph_c), np.array(sph_r),
                             np.array(sph_mat, np.int32), device=device)
    lights = make_lights([{
        "kind": LIGHT_AREA,
        "radiance": np.array([10.0, 10.0, 10.0]),
        "position": np.array([0.0, 1.49, 0.0]),
        "direction": np.array([0.0, -1.0, 0.0]),
        "dim_x": np.array([0.8, 0.0, 0.0]),
        "dim_y": np.array([0.0, 0.0, 0.6]),
        "area": 0.48,
    }], device=device)

    # camera on the +z axis looking -z, like the reference placement
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    camera = Camera(
        c2w=f32(np.eye(3)),
        pos=f32([0.0, 0.75, 4.0]),
        hfov=f32(35.0),
        vfov=f32(27.0),
        nclip=f32(0.01),
        fclip=f32(100.0),
        lens_radius=f32(0.0),
        focal_distance=f32(4.0),
    )
    return Scene(geometry=geometry,
                 materials=make_materials(materials, device=device),
                 lights=lights, camera=camera)
