"""Headless BVH visualizer — the reference's VISUALIZE mode as an image.

A port of bidirectional_pathtracing_tpu/utils/bvh_vis.py: BVHVisualizer
(navigation, subtree_prims, render), orbit_view, save_visualization and
collect_ray_log, with the primary rays made by the port's
ops/camera_ops.py and their hits from ops/intersect.py scene_intersect,
so on the card they go through the scene's kernel (K1, K2 or the walk
kernel, by kernel_route); the compositing is the same host numpy.

The reference draws the BVH interactively in OpenGL
(RaytracedRenderer::visualize_accel, raytraced_renderer.cpp:376-467): all
node AABBs as gray wireframes, the selected node orange, its children
white, the selected subtree's primitives filled (left child light blue,
right child lighter), and optionally the logged rays (yellow = hit,
red = miss, every 500th; raytraced_renderer.cpp:439-463).  Arrow keys walk
the tree (raytraced_renderer.cpp:560-574).

Here it is headless: one batched `scene_intersect` launch produces the
primitive-id and depth maps (replacing the GL depth-buffered triangle
pass), and the AABB wireframes are composited over them host-side with a
vectorized line rasterizer.  `BVHVisualizer` keeps the same
selection-stack navigation (to_left/to_right/up == LEFT/RIGHT/UP arrow
keys)."""

from __future__ import annotations

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.scene.bvh import _host as _np
from bidirectional_pathtracing_tpu_torch.scene.bvh import build_bvh

# colors from raytraced_renderer.cpp:384-391
_C_NODE = (0.5, 0.5, 0.5)
_A_NODE = 0.25
_C_SEL = (1.0, 0.25, 0.0)
_A_SEL = 0.6
_C_CHILD = (1.0, 1.0, 1.0)
_A_CHILD = 0.6
_C_LEFT = (0.6, 0.6, 1.0)
_C_RIGHT = (0.8, 0.8, 1.0)
_C_RAY_HIT = (1.0, 1.0, 0.0)
_C_RAY_MISS = (1.0, 0.0, 0.0)
_A_RAY = 0.35
_VERY_LONG = 1e4  # raytraced_renderer.cpp:447


def _w2c(cam):
    R = _np(cam.c2w).astype(np.float64)
    pos = _np(cam.pos).astype(np.float64)
    return R.T, pos


def _to_cam(cam, pts):
    RT, pos = _w2c(cam)
    return (pts - pos) @ RT.T


def _project(cam, p_cam, w, h):
    """Camera-space points -> float pixel coords (origin bottom-left,
    matching the sample buffers) + positive view depth."""
    depth = -p_cam[..., 2]
    th = np.tan(np.radians(float(cam.hfov)) / 2.0)
    tv = np.tan(np.radians(float(cam.vfov)) / 2.0)
    x = (p_cam[..., 0] / np.maximum(depth, 1e-9) / th + 1.0) * 0.5 * w
    y = (p_cam[..., 1] / np.maximum(depth, 1e-9) / tv + 1.0) * 0.5 * h
    return x, y, depth


_BOX_EDGES = np.array(
    [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
     (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)], np.int32)


def _box_segments(lo, hi):
    """[N,3]x2 -> segment endpoints [N*12, 2, 3]."""
    n = lo.shape[0]
    bits = ((np.arange(8)[:, None] >> np.arange(3)[None, :]) & 1)
    corners = np.where(bits[None], hi[:, None, :], lo[:, None, :])  # [N,8,3]
    segs = corners[:, _BOX_EDGES, :]                                # [N,12,2,3]
    return segs.reshape(n * 12, 2, 3)


def _draw_segments(img, depth_map, cam, segs, color, alpha,
                   depth_test=True, thick=1):
    """Rasterize world-space segments [S,2,3] with alpha blending.

    Depth testing compares against the scene depth map (the reference keeps
    GL_DEPTH_TEST on but depth-writes off for boxes,
    raytraced_renderer.cpp:411-413) with a small bias so boxes touching
    geometry stay visible."""
    if segs.shape[0] == 0:
        return
    h, w = img.shape[:2]
    a = _to_cam(cam, segs[:, 0])
    b = _to_cam(cam, segs[:, 1])
    near = max(float(cam.nclip), 1e-4)
    da, db = -a[:, 2], -b[:, 2]
    keep = (da > near) | (db > near)
    a, b, da, db = a[keep], b[keep], da[keep], db[keep]
    if a.shape[0] == 0:
        return
    # clip at the near plane
    t = np.clip((near - da) / np.where(db != da, db - da, 1.0), 0.0, 1.0)
    a = np.where((da <= near)[:, None], a + t[:, None] * (b - a), a)
    t2 = np.clip((near - db) / np.where(da != db, da - db, 1.0), 0.0, 1.0)
    b = np.where((db <= near)[:, None], b + t2[:, None] * (a - b), b)

    x0, y0, z0 = _project(cam, a, w, h)
    x1, y1, z1 = _project(cam, b, w, h)
    # clip the parametric range to the viewport (Liang–Barsky) so segments
    # reaching far off-screen don't eat the per-segment sample budget
    dx, dy = x1 - x0, y1 - y0
    t_lo = np.zeros_like(x0)
    t_hi = np.ones_like(x0)
    for p, q0, q1 in ((dx, -x0, w - x0), (dy, -y0, h - y0)):
        with np.errstate(divide="ignore", invalid="ignore"):
            r0 = np.where(p != 0, q0 / np.where(p != 0, p, 1.0), -np.inf)
            r1 = np.where(p != 0, q1 / np.where(p != 0, p, 1.0), np.inf)
        lo = np.minimum(r0, r1)
        hi = np.maximum(r0, r1)
        inside = (p != 0) | ((q0 <= 0) & (q1 >= 0))
        t_lo = np.where(inside, np.maximum(t_lo, lo), 1.0)
        t_hi = np.where(inside, np.minimum(t_hi, hi), 0.0)
    vis_m = t_lo < t_hi
    x0c = x0 + t_lo * dx
    y0c = y0 + t_lo * dy
    x1c = x0 + t_hi * dx
    y1c = y0 + t_hi * dy
    x0, y0, x1, y1 = x0c[vis_m], y0c[vis_m], x1c[vis_m], y1c[vis_m]
    iz0 = 1.0 / z0 + t_lo * (1.0 / z1 - 1.0 / z0)
    iz1 = 1.0 / z0 + t_hi * (1.0 / z1 - 1.0 / z0)
    iz0, iz1 = iz0[vis_m], iz1[vis_m]
    if x0.shape[0] == 0:
        return
    # per-segment sample counts (ragged -> flat)
    n = np.ceil(np.maximum(np.abs(x1 - x0), np.abs(y1 - y0))).astype(int) + 1
    n = np.clip(n, 2, 4 * max(w, h))
    total = int(n.sum())
    seg = np.repeat(np.arange(n.shape[0]), n)
    start = np.concatenate([[0], np.cumsum(n)[:-1]])
    tt = (np.arange(total) - start[seg]) / (n[seg] - 1)
    px = x0[seg] + tt * (x1 - x0)[seg]
    py = y0[seg] + tt * (y1 - y0)[seg]
    # perspective-correct depth along the segment
    iz = iz0[seg] + tt * (iz1 - iz0)[seg]
    pz = 1.0 / np.maximum(iz, 1e-12)

    xi = np.round(px).astype(int)
    yi = np.round(py).astype(int)
    offs = [(0, 0)] if thick <= 1 else [(0, 0), (1, 0), (0, 1), (1, 1)]
    for ox, oy in offs:
        xs, ys = xi + ox, yi + oy
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        if depth_test:
            ok = ok & (pz <= depth_map[np.clip(ys, 0, h - 1),
                                       np.clip(xs, 0, w - 1)] * 1.005 + 1e-3)
        xs, ys = xs[ok], ys[ok]
        img[ys, xs] = (1 - alpha) * img[ys, xs] + alpha * np.asarray(color)


class BVHVisualizer:
    """Selection-stack navigation + image rendering of the BVH.

    Mirrors the reference key bindings (raytraced_renderer.cpp:560-574):
    to_left()/to_right() descend into children, up() pops; current() is the
    selected node id.  render() returns an HDR float image [H,W,3] in
    [0,1], rows bottom-up like the sample buffers (use
    utils.image.save_image to write a PNG)."""

    def __init__(self, scene):
        if scene.bvh is None:
            scene = scene._replace(bvh=build_bvh(scene.geometry))
        self.scene = scene
        self.bvh = _np_bvh(scene.bvh)
        self.stack = [0]

    # --- navigation (raytraced_renderer.cpp:560-574) ---
    def current(self) -> int:
        return self.stack[-1]

    def is_leaf(self, node=None) -> bool:
        return bool(self.bvh["is_leaf"][self.current() if node is None
                                        else node])

    def children(self, node: int):
        """(left, right) child ids of an internal node (pre-order layout:
        left = node+1, right = escape of the left subtree)."""
        left = node + 1
        right = int(self.bvh["escape"][left])
        return left, right

    def to_left(self):
        if not self.is_leaf():
            self.stack.append(self.children(self.current())[0])

    def to_right(self):
        if not self.is_leaf():
            self.stack.append(self.children(self.current())[1])

    def up(self):
        if len(self.stack) > 1:
            self.stack.pop()

    def navigate(self, path: str):
        """Apply a navigation string: 'l'=left, 'r'=right, 'u'=up."""
        bad = set(path) - set("lru")
        if bad:
            raise ValueError(
                f"invalid BVH navigation {path!r}: unknown step(s) "
                f"{''.join(sorted(bad))!r} (use l/r/u)")
        for c in path:
            {"l": self.to_left, "r": self.to_right, "u": self.up}[c]()

    # --- subtree queries ---
    def subtree_prims(self, node: int) -> np.ndarray:
        """Global primitive ids under `node` (leaves of [node, escape))."""
        esc = int(self.bvh["escape"][node])
        ids = []
        for i in range(node, esc):
            if self.bvh["is_leaf"][i]:
                s = int(self.bvh["prim_start"][i])
                c = int(self.bvh["prim_count"][i])
                ids.append(self.bvh["prim_order"][s:s + c])
        return (np.concatenate(ids) if ids
                else np.zeros((0,), np.int64))

    # --- rendering ---
    def render(self, width: int, height: int, ray_log=None,
               ray_stride: int = 500, camera=None) -> np.ndarray:
        """camera: optional Camera override — the reference GUI lets you
        orbit the view while visualizing; primary rays drawn from the
        render camera itself collapse to points, so pass a side view to
        see them as lines."""
        scene = self.scene
        cam = scene.camera if camera is None else camera
        w, h = width, height
        ids = np.arange(w * h)
        o, d, hit = primary_hits(scene, cam, ids % w, ids // w, w, h)
        prim = hit["prim"].reshape(h, w)
        valid = hit["valid"].reshape(h, w)
        t = hit["t"].reshape(h, w)
        o = o.reshape(h, w, 3)
        d = d.reshape(h, w, 3)
        hit_p = o + t[..., None] * d
        depth_map = np.where(valid, -_to_cam(cam, hit_p)[..., 2], np.inf)
        nrm = hit["n"].reshape(h, w, 3)
        shade = np.abs(np.sum(nrm * d, -1))

        sel = self.current()
        n_prims = (scene.geometry.num_tris + scene.geometry.num_spheres)
        in_left = np.zeros((n_prims + 1,), bool)
        in_right = np.zeros((n_prims + 1,), bool)
        if self.is_leaf(sel):
            in_left[self.subtree_prims(sel)] = True
        else:
            l, r = self.children(sel)
            in_left[self.subtree_prims(l)] = True
            in_right[self.subtree_prims(r)] = True

        img = np.zeros((h, w, 3))
        pid = np.where(valid, prim, n_prims)
        img[valid] = (0.15 * shade[valid])[:, None]  # faint scene context
        img[in_left[pid]] = np.asarray(_C_LEFT) * shade[in_left[pid]][:, None]
        img[in_right[pid]] = (np.asarray(_C_RIGHT)
                              * shade[in_right[pid]][:, None])

        lo = self.bvh["bounds_lo"]
        hi = self.bvh["bounds_hi"]
        real = self.bvh["escape"] > np.arange(lo.shape[0])  # skip padding
        _draw_segments(img, depth_map, cam,
                       _box_segments(lo[real], hi[real]), _C_NODE, _A_NODE)
        if not self.is_leaf(sel):
            l, r = self.children(sel)
            _draw_segments(img, depth_map, cam,
                           _box_segments(lo[[l, r]], hi[[l, r]]),
                           _C_CHILD, _A_CHILD)
        _draw_segments(img, depth_map, cam,
                       _box_segments(lo[[sel]], hi[[sel]]),
                       _C_SEL, _A_SEL, thick=2)

        if ray_log is not None:
            ro, rd, rt = (np.asarray(a, np.float64) for a in ray_log)
            idx = np.arange(0, ro.shape[0], max(ray_stride, 1))
            ro, rd, rt = ro[idx], rd[idx], rt[idx]
            hit_m = np.isfinite(rt) & (rt >= 0) & (rt < _VERY_LONG)
            end = ro + np.where(hit_m, rt, _VERY_LONG)[:, None] * rd
            segs = np.stack([ro, end], axis=1)
            _draw_segments(img, depth_map, cam, segs[hit_m],
                           _C_RAY_HIT, _A_RAY, depth_test=False)
            _draw_segments(img, depth_map, cam, segs[~hit_m],
                           _C_RAY_MISS, _A_RAY, depth_test=False)
        return img


def primary_hits(scene, cam, px, py, w, h):
    """Pinhole rays through the centres of pixels (px, py) of a w x h frame
    (rows bottom-up) and their closest hits through scene_intersect on the
    scene's device: (o, d, {t, valid, n, prim}) as host numpy."""
    from bidirectional_pathtracing_tpu_torch.ops import camera_ops
    from bidirectional_pathtracing_tpu_torch.ops.intersect import (
        scene_intersect)
    dev = scene.device
    nx = torch.as_tensor((px + 0.5) / w, dtype=torch.float32, device=dev)
    ny = torch.as_tensor((py + 0.5) / h, dtype=torch.float32, device=dev)
    o, d = camera_ops.generate_ray(cam, nx, ny)
    hit = scene_intersect(scene, o, d, cam.nclip, cam.fclip)
    return _np(o), _np(d), {k: _np(getattr(hit, k))
                            for k in ("t", "valid", "n", "prim")}


def _np_bvh(bvh):
    return {k: _np(getattr(bvh, k)) for k in
            ("bounds_lo", "bounds_hi", "is_leaf", "prim_start",
             "prim_count", "escape", "prim_order")}


def orbit_view(scene, yaw_deg: float = 30.0, pitch_deg: float = 15.0):
    """A side view for visualization: keeps the render camera's FOV and
    distance but orbits around the geometry center — the headless stand-in
    for the GUI's mouse orbit (camera.cpp:53-147)."""
    geom = scene.geometry
    tv = _np(geom.tri_valid)
    tp = _np(geom.tri_p)[tv]
    lo = tp.min(axis=(0, 1)) if tp.size else np.zeros(3)
    hi = tp.max(axis=(0, 1)) if tp.size else np.zeros(3)
    sv = _np(geom.sph_valid)
    if sv.any():
        c = _np(geom.sph_c)[sv]
        r = _np(geom.sph_r)[sv][:, None]
        lo = np.minimum(lo, (c - r).min(axis=0))
        hi = np.maximum(hi, (c + r).max(axis=0))
    target = (lo + hi) / 2.0
    cam = scene.camera
    off = _np(cam.pos).astype(np.float64) - target
    dist = np.linalg.norm(off)
    yaw = np.radians(yaw_deg)
    pitch = np.radians(pitch_deg)
    u = off / max(dist, 1e-9)
    base_yaw = np.arctan2(u[0], u[2])
    base_pitch = np.arcsin(np.clip(u[1], -1.0, 1.0))
    ny, npi = base_yaw + yaw, np.clip(base_pitch + pitch, -1.4, 1.4)
    nu = np.array([np.cos(npi) * np.sin(ny), np.sin(npi),
                   np.cos(npi) * np.cos(ny)])
    pos = target + dist * nu
    back = nu
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= max(np.linalg.norm(right), 1e-9)
    up = np.cross(back, right)
    dev = cam.pos.device
    c2w = torch.tensor(np.stack([right, up, back], axis=1),
                       dtype=torch.float32, device=dev)
    return cam._replace(c2w=c2w, pos=torch.tensor(pos, dtype=torch.float32,
                                                  device=dev))


def save_visualization(path: str, img: np.ndarray) -> None:
    """Write the visualizer image (already display-ready colors, rows
    bottom-up) as a PNG with the renderer's vertical flip."""
    from bidirectional_pathtracing_tpu_torch.utils.png import write_png
    write_png(path, (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)[::-1])


def collect_ray_log(scene, width: int, height: int, stride: int = 500):
    """The LoggedRay equivalent (ray.h:74-82): primary rays through every
    `stride`-th pixel with their hit distance (-1 on miss, like the
    reference's rayLog miss marker)."""
    ids = np.arange(0, width * height, max(stride, 1))
    o, d, hit = primary_hits(scene, scene.camera, ids % width,
                              ids // width, width, height)
    t = np.where(hit["valid"], hit["t"], -1.0)
    return o, d, t
