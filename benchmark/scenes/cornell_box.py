"""The Cornell box with two analytic spheres (12 triangles, 2 spheres, one
area light): the arrays of the port's make_cornell_box, frozen.

arrays(config) reads config["sphere_materials"] (two names of
box.MAT_NAME_TO_ID)."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.box import MAT_NAME_TO_ID, SPH_C, SPH_R, box_records


def arrays(config: dict) -> dict:
    tris, norms, mats, materials, lights, camera = box_records()
    return {"tri_p": np.array(tris, np.float32),
            "tri_n": np.array(norms, np.float32),
            "tri_mat": np.array(mats, np.int32),
            "sph_c": np.array(SPH_C, np.float32),
            "sph_r": np.array(SPH_R, np.float32),
            "sph_mat": np.array([MAT_NAME_TO_ID[m]
                                 for m in config["sphere_materials"]],
                                np.int32),
            "materials": materials, "lights": lights, "camera": camera}
