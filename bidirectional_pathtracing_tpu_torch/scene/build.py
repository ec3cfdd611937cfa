"""Acceleration structures for a built scene.

attach_accelerator is a port of bidirectional_pathtracing_tpu/scene/
build.py attach_accelerator (:74-106), with the same rule.  The COLLADA
loader around it (load_scene / build_scene, scene/collada.py) is not
ported yet (ROADMAP A1): the port's scenes are procedural.
"""

from __future__ import annotations

from bidirectional_pathtracing_tpu_torch.scene.clusters import build_clusters
from bidirectional_pathtracing_tpu_torch.scene.types import Scene


def attach_accelerator(scene: Scene, accel: str = "auto",
                       brute_force_max_tris: int = 2048) -> Scene:
    """Attach the cluster tables when the scene is big enough to beat
    brute force (accel: "auto" | "brute" | "bvh", RenderConfig.accelerator;
    "auto" attaches above brute_force_max_tris primitives).

    The JAX package attaches two structures built from the reference BVH
    algorithm: BVHArrays (its CPU path's escape-link walk) and the cluster
    tables.  The port attaches the flat cluster tables only; `bvh` stays
    None (and the BVH's leaf size is no argument) until BVHArrays is
    ported.  The tables are built on the host and placed on the scene's
    device.
    """
    if accel not in ("auto", "brute", "bvh"):
        raise ValueError(f"unknown accelerator {accel!r}")
    g = scene.geometry
    want = accel == "bvh" or (accel == "auto" and
                              g.num_tris + g.num_spheres > brute_force_max_tris)
    if not want or scene.clusters is not None:
        return scene
    return scene._replace(clusters=build_clusters(g, device=scene.device))
