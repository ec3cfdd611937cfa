"""The Cornell box with its two spheres as geodesic sphere meshes of any
frequency: each of the icosahedron's 20 faces cut into n x n triangles,
their corners pushed out to the unit sphere (n = 2^level gives as many
triangles as the icosphere of that level).  The walls, light, camera,
materials and sphere placement are box.py's, as in mesh_box.py.

arrays(config) reads config["sphere_frequency"] (n, the same for both
spheres) and config["sphere_materials"]; the scene has 12 + 2 x 20 n^2
triangles, smooth normals and no analytic sphere.

A corner is the normalised a A + b B + c C of its face's corners A, B, C
with whole weights a + b + c = n, summed in the same order on every face,
so a point on an edge shared by two faces is the same float64 on both
and the mesh has no cracks.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenes.box import (
    MAT_NAME_TO_ID, SPH_C, SPH_R, box_records, icosphere)


def _weights(n: int) -> np.ndarray:
    """[n*n, 3, 3] whole weights (of A, B, C) of each triangle's corners,
    wound as A, B, C are."""
    up, down = [], []
    for i in range(n):
        for j in range(n - i):
            up.append([(n - i - j, i, j), (n - i - j - 1, i + 1, j),
                       (n - i - j - 1, i, j + 1)])
            if i + j <= n - 2:
                down.append([(n - i - j - 1, i + 1, j),
                             (n - i - j - 2, i + 1, j + 1),
                             (n - i - j - 1, i, j + 1)])
    return np.array(up + down, np.float64)


def geodesic_sphere(n: int) -> np.ndarray:
    """[20 n^2, 3, 3] corners of the unit geodesic sphere of frequency n."""
    verts, faces = icosphere(0)
    corners = verts[faces]                              # [20, 3, 3]
    w = _weights(n)                                     # [T, 3, 3]
    a, b, c = corners[:, 0], corners[:, 1], corners[:, 2]
    p = (w[None, :, :, 0, None] * a[:, None, None, :]
         + w[None, :, :, 1, None] * b[:, None, None, :]
         + w[None, :, :, 2, None] * c[:, None, None, :])
    p = p / np.sqrt((p * p).sum(-1, keepdims=True))
    return p.reshape(-1, 3, 3)


def arrays(config: dict) -> dict:
    tris, norms, mats, materials, lights, camera = box_records()
    dirs = geodesic_sphere(config["sphere_frequency"])
    p = [np.array(tris)]
    n = [np.array(norms)]
    m = [np.array(mats, np.int32)]
    for c, r, name in zip(SPH_C, SPH_R, config["sphere_materials"]):
        p.append(np.asarray(c, np.float64) + r * dirs)
        n.append(dirs)
        m.append(np.full(dirs.shape[0], MAT_NAME_TO_ID[name], np.int32))
    return {"tri_p": np.concatenate(p).astype(np.float32),
            "tri_n": np.concatenate(n).astype(np.float32),
            "tri_mat": np.concatenate(m),
            "materials": materials, "lights": lights, "camera": camera}
