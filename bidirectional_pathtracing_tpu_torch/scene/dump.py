"""Export a parsed scene to a plain-text dump (world space).

A copy of bidirectional_pathtracing_tpu/scene/dump.py on the port's
scene/collada.py and scene/build.py helpers: the same text, byte for byte.
The dump is what the reference oracle harness reads for golden
comparisons, and handy for debugging scene conversion.  Geometry is exported as
world-space polygon soup (positions + polygons, pre-triangulation) so a
consumer can rebuild connectivity-based vertex normals itself.
"""

from __future__ import annotations

import numpy as np

from bidirectional_pathtracing_tpu_torch.scene import collada as C
from bidirectional_pathtracing_tpu_torch.scene.build import (
    _build_light, _xform_point, _xform_point_nodiv)
from bidirectional_pathtracing_tpu_torch.scene.types import (
    MAT_DIFFUSE, MAT_EMISSION, MAT_GLASS, MAT_MICROFACET, MAT_MIRROR,
    MAT_REFRACTION,
)


def _fmt(v):
    return " ".join(f"{float(x):.9g}" for x in np.atleast_1d(v))


def dump_scene_text(scene_info: C.SceneInfo) -> str:
    lines = []
    materials = []

    def add_material(mat):
        if mat is None:
            mat = C.MaterialInfo(kind=MAT_DIFFUSE,
                                 params={"albedo": np.array([0.5, 0.5, 0.5])})
        materials.append(mat)
        return len(materials) - 1

    body = []
    cam = None
    cam_dir = np.array([0.0, 0.0, -1.0])
    for node in scene_info.nodes:
        T = node.transform
        inst = node.instance
        if isinstance(inst, C.CameraInfo):
            cam = inst
            d = _xform_point_nodiv(T, inst.view_dir)
            n = np.linalg.norm(d)
            cam_dir = d / n if n > 0 else cam_dir
        elif isinstance(inst, C.LightInfo):
            rec = _build_light(inst, T)
            if rec["kind"] == 0:
                body.append("light area " + _fmt(rec["radiance"]) + " "
                            + _fmt(rec["position"]) + " " + _fmt(rec["direction"])
                            + " " + _fmt(rec["dim_x"]) + " " + _fmt(rec["dim_y"]))
            elif rec["kind"] == 1:
                body.append("light point " + _fmt(rec["radiance"]) + " "
                            + _fmt(rec["position"]))
        elif isinstance(inst, C.SphereInfo):
            pos = _xform_point(T, np.zeros(3))
            scale = np.linalg.norm((T @ np.array([1.0, 0, 0, 0]))[:3])
            mid = add_material(inst.material)
            body.append(f"sphere {mid} " + _fmt(pos) + f" {inst.radius * scale:.9g}")
        elif isinstance(inst, C.PolymeshInfo):
            verts = np.stack([_xform_point(T, v) for v in inst.vertices])
            mid = add_material(inst.material)
            body.append(f"mesh {mid} {len(verts)} {len(inst.polygons)}")
            for v in verts:
                body.append(_fmt(v))
            for p in inst.polygons:
                body.append(f"{len(p)} " + " ".join(str(int(i)) for i in p))

    if cam is None:
        cam = C.CameraInfo()
    lines.append(f"camera {cam.hfov:.9g} {cam.vfov:.9g} {cam.nclip:.9g} "
                 f"{cam.fclip:.9g} " + _fmt(cam_dir))
    for m in materials:
        p = m.params
        if m.kind == MAT_DIFFUSE:
            lines.append("material diffuse " + _fmt(p["albedo"]))
        elif m.kind == MAT_EMISSION:
            lines.append("material emission " + _fmt(p["emission"]))
        elif m.kind == MAT_MIRROR:
            lines.append("material mirror " + _fmt(p["reflectance"]))
        elif m.kind == MAT_REFRACTION:
            lines.append("material refraction " + _fmt(p["transmittance"])
                         + f" {p['ior']:.9g}")
        elif m.kind == MAT_GLASS:
            lines.append("material glass " + _fmt(p["transmittance"]) + " "
                         + _fmt(p["reflectance"]) + f" {p['ior']:.9g}")
        elif m.kind == MAT_MICROFACET:
            lines.append("material microfacet " + _fmt(p["eta"]) + " "
                         + _fmt(p["k"]) + f" {p['roughness']:.9g}")
    lines.extend(body)
    return "\n".join(lines) + "\n"


def dump_scene(path_dae: str, path_out: str) -> None:
    info = C.load_dae(path_dae)
    with open(path_out, "w") as f:
        f.write(dump_scene_text(info))
