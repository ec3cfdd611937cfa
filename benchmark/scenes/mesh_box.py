"""The Cornell box with its two spheres as icosphere meshes: the arrays of
the port's mesh_cornell_box_arrays, frozen.  Level 6 gives 12 + 2 x 81,920
= 163,852 triangles and no analytic sphere.

arrays(config) reads config["sphere_level"] and
config["sphere_materials"]."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.box import (
    MAT_NAME_TO_ID, SPH_C, SPH_R, box_records, icosphere)


def arrays(config: dict) -> dict:
    tris, norms, mats, materials, lights, camera = box_records()
    unit, faces = icosphere(config["sphere_level"])
    p = [np.array(tris)]
    n = [np.array(norms)]
    m = [np.array(mats, np.int32)]
    for c, r, name in zip(SPH_C, SPH_R, config["sphere_materials"]):
        dirs = unit[faces]                              # [F,3,3] unit
        p.append(np.asarray(c, np.float64) + r * dirs)
        n.append(dirs)
        m.append(np.full(faces.shape[0], MAT_NAME_TO_ID[name], np.int32))
    return {"tri_p": np.concatenate(p).astype(np.float32),
            "tri_n": np.concatenate(n).astype(np.float32),
            "tri_mat": np.concatenate(m),
            "materials": materials, "lights": lights, "camera": camera}
