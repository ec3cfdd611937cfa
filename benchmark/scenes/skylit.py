"""An open scene lit only by an HDR sky: a diffuse ground quad (the port's
make_open_env_scene ground, 2 triangles) with two geodesic spheres of any
frequency standing on it (geodesic_box.py geodesic_sphere), no light but
a procedural latitude-longitude sky of any size.

arrays(config) reads sphere_frequency, sphere_materials (names of
box.py's materials), sphere_centers, sphere_radii, camera_pos,
camera_target, hfov, vfov, envmap_width, envmap_height and the sky's keys
(sky): the scene has 2 + 2 x 20 n^2 triangles, smooth normals on the
spheres, and the sky under "envmap", [H, W, 3] float32, for build_envmap.

The sky (sky_map) is a function of the direction of each texel, so every
size draws the same sky: over the upper hemisphere a gradient from the
horizon's radiance to the zenith's, linear in cos(theta); below the
horizon the dim ground's; and a sun disk of sun_diameter_deg whose
radiance is sun_to_zenith times the zenith's luminance in every channel.
A texel near the sun takes the sun's radiance by the share of the texel
that the disk covers, found on a grid of sub-texel directions fine enough
to resolve the disk at any map size, so the sun's power is the same at
every size.  The map's directions follow ops/envlight.py: row j is
theta = pi (j + 0.5) / H from +y, column i is phi = 2 pi (i + 0.5) / W,
the direction (cos(phi - pi) sin theta, cos theta, -sin(phi - pi) sin
theta).
"""

from __future__ import annotations

import numpy as np

from benchmark.scenes.box import MAT_NAME_TO_ID, box_records
from benchmark.scenes.geodesic_box import geodesic_sphere

LUMA = np.array([0.2126, 0.7152, 0.0722])
GROUND_HALF = 4.0          # the ground quad spans [-4, 4] in x and z
SUN_WINDOW = 3             # texels on each side of the sun's that it may touch
SUB_PER_RADIUS = 8         # sub-texel directions across the sun's radius


def _dirs(theta, phi):
    """Unit directions [..., 3] of the map's (theta, phi)."""
    st = np.sin(theta)
    return np.stack([np.cos(phi - np.pi) * st, np.cos(theta),
                     -np.sin(phi - np.pi) * st], axis=-1)


def _angles(d):
    """(theta, phi) of unit directions d [..., 3], as the map stores them."""
    theta = np.arccos(np.clip(d[..., 1], -1.0, 1.0))
    phi = np.arctan2(-d[..., 2], d[..., 0]) + np.pi
    return theta, phi


def _sky_rgb(d, sky):
    """The sky without its sun along unit directions d [..., 3]."""
    zen = np.asarray(sky["zenith"], np.float64)
    hor = np.asarray(sky["horizon"], np.float64)
    gnd = np.asarray(sky["ground"], np.float64)
    up = np.clip(d[..., 1:2], 0.0, 1.0)
    return np.where(d[..., 1:2] > 0.0, hor + (zen - hor) * up, gnd)


def sky_map(width: int, height: int, sky: dict) -> np.ndarray:
    """[height, width, 3] float32: the sky (see the module's docstring)."""
    j = (np.arange(height) + 0.5) * np.pi / height
    i = (np.arange(width) + 0.5) * 2.0 * np.pi / width
    theta, phi = np.meshgrid(j, i, indexing="ij")
    rgb = _sky_rgb(_dirs(theta, phi), sky)

    s = np.asarray(sky["sun_direction"], np.float64)
    s = s / np.linalg.norm(s)
    radius = np.radians(sky["sun_diameter_deg"]) / 2.0
    sun = (sky["sun_to_zenith"] * float(np.asarray(sky["zenith"]) @ LUMA)
           * np.ones(3))
    st, sp = _angles(s)
    j0 = int(st / np.pi * height)
    i0 = int(sp / (2.0 * np.pi) * width)
    # sub-texel directions: at least SUB_PER_RADIUS across the sun's radius
    texel = max(np.pi / height, 2.0 * np.pi / width)
    n = max(4, int(np.ceil(texel / radius * SUB_PER_RADIUS)))
    u = (np.arange(n) + 0.5) / n
    cos_r = np.cos(radius)
    for jj in range(max(j0 - SUN_WINDOW, 0),
                    min(j0 + SUN_WINDOW + 1, height)):
        th = (jj + u) * np.pi / height
        for di in range(-SUN_WINDOW, SUN_WINDOW + 1):
            ii = (i0 + di) % width
            ph = (ii + u) * 2.0 * np.pi / width
            tt, pp = np.meshgrid(th, ph, indexing="ij")
            # each sub-direction weighted by its solid angle (sin theta)
            w = np.sin(tt)
            covered = (_dirs(tt, pp) @ s) >= cos_r
            share = float((w * covered).sum() / w.sum())
            if share > 0.0:
                rgb[jj, ii] = rgb[jj, ii] * (1.0 - share) + sun * share
    return rgb.astype(np.float32)


def _camera(config):
    pos = np.asarray(config["camera_pos"], np.float64)
    back = pos - np.asarray(config["camera_target"], np.float64)
    back = back / np.linalg.norm(back)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    return {k: np.asarray(v, np.float32) for k, v in (
        ("c2w", np.stack([right, up, back], axis=1)), ("pos", pos),
        ("hfov", config["hfov"]), ("vfov", config["vfov"]),
        ("nclip", 0.1), ("fclip", 100.0), ("lens_radius", 0.0),
        ("focal_distance", float(np.linalg.norm(
            pos - np.asarray(config["camera_target"], np.float64)))))}


def arrays(config: dict) -> dict:
    _, _, _, box_materials, _, _ = box_records()
    g = GROUND_HALF
    ground = [[[-g, 0, g], [g, 0, g], [g, 0, -g]],
              [[-g, 0, g], [g, 0, -g], [-g, 0, -g]]]
    materials = [{"kind": 0, "albedo": np.array([0.55, 0.5, 0.45])}]
    p = [np.array(ground, np.float64)]
    n = [np.tile(np.array([0.0, 1.0, 0.0]), (2, 3, 1))]
    m = [np.zeros(2, np.int32)]
    dirs = geodesic_sphere(config["sphere_frequency"])
    for c, r, name in zip(config["sphere_centers"], config["sphere_radii"],
                          config["sphere_materials"]):
        materials.append(box_materials[MAT_NAME_TO_ID[name]])
        p.append(np.asarray(c, np.float64) + r * dirs)
        n.append(dirs)
        m.append(np.full(dirs.shape[0], len(materials) - 1, np.int32))
    return {"tri_p": np.concatenate(p).astype(np.float32),
            "tri_n": np.concatenate(n).astype(np.float32),
            "tri_mat": np.concatenate(m),
            "materials": materials, "lights": [],
            "camera": _camera(config),
            "envmap": sky_map(config["envmap_width"],
                              config["envmap_height"], config["sky"])}
