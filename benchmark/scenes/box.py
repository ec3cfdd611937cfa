"""The Cornell box's records and the icosphere, frozen for the benchmark.

Copies of bidirectional_pathtracing_tpu_torch/scene/procedural.py
`_quad`, `_box_records` and `icosphere` (the JAX package's
scene/procedural.py:29-99), with the material and light kinds written as
the numbers of scene/types.py (diffuse 0, emission 1, mirror 2, glass 4,
microfacet 5; area light 0).  The benchmark builds every scene from these
numpy arrays and hands the same arrays to the program's constructors and
to the reference's.
"""

from __future__ import annotations

import numpy as np


def _quad(p0, p1, p2, p3, n):
    """Two triangles for a quad with a shared normal."""
    tris = [[p0, p1, p2], [p0, p2, p3]]
    norms = [[n, n, n], [n, n, n]]
    return tris, norms


def box_records():
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
        {"kind": 0, "albedo": np.array([0.6, 0.6, 0.6])},   # 0 gray
        {"kind": 0, "albedo": np.array([0.6, 0.2, 0.2])},   # 1 red
        {"kind": 0, "albedo": np.array([0.2, 0.2, 0.6])},   # 2 blue
        {"kind": 1, "emission": np.array([10.0, 10.0, 10.0])},  # 3
        {"kind": 0, "albedo": np.array([0.8, 0.8, 0.8])},   # 4
        {"kind": 2, "reflectance": np.array([0.9, 0.9, 0.9])},  # 5
        {"kind": 4, "transmittance": np.array([0.9, 0.9, 0.9]),
         "reflectance": np.array([0.9, 0.9, 0.9]), "ior": 1.45},      # 6
        {"kind": 5, "roughness": 0.3,                    # 7 Al
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
        "kind": 0,
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


MAT_NAME_TO_ID = {"diffuse": 4, "mirror": 5, "glass": 6, "microfacet": 7}
SPH_C = [[-0.4, 0.3, -0.3], [0.4, 0.3, 0.3]]
SPH_R = [0.3, 0.3]


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
