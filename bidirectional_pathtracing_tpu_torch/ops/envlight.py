"""HDR environment light with 2-stage CDF importance sampling (PyTorch port
of bidirectional_pathtracing_tpu/ops/envlight.py, :33-182).

Mirrors reference src/scene/environment_light.cpp:
  - build_envmap: pixel pdf = luminance * sin(pi (j+.5)/h), marginal CDF
    over rows, conditional CDF over columns (environment_light.cpp:18-62),
    on the host in float64, then float32, so the tables equal the JAX
    package's bit for bit;
  - sample_dir: equirectangular lookup with the reference's wrap-aware
    bilerp (environment_light.cpp:114-180); direction convention
    theta = acos(y), phi = atan2(-z, x) + pi (environment_light.cpp:100-112);
  - sample_L: 2-stage CDF inversion with the Jacobian pdf
    p(w) = p(x,y) * (w*h) / (2 pi^2 sin(theta)) (environment_light.cpp:138-169);
  - pdf_dir: that pdf at an arbitrary direction;
  - sample_Le: emission rays from the env (the BDPT env subpath family).

The CDF inversions are binary searches with numpy's side="right" rule,
log2(W) gather steps over the lanes' own rows: a per-lane row gather
(conditional_cdf[y], [S, W]) would be 700 MB at 172,800 lanes and a
1,024-wide map.  Gathers clamp their indices into the table, as XLA's do;
that changes nothing for finite directions.

Not ported: save_probability_debug (it needs the PNG writer; ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from bidirectional_pathtracing_tpu_torch.core.math import (
    INF_D, PI, make_coord_space, normalize)
from bidirectional_pathtracing_tpu_torch.scene.types import Envmap

_LUMA = np.array([0.2126, 0.7152, 0.0722])


def build_envmap(data, device="cuda") -> Envmap:
    """data: [H,W,3] float.  Precomputes the pdf and CDF tables on the host
    in float64 and returns them as float32 tensors on `device`."""
    data = np.asarray(data, np.float64)
    h, w = data.shape[:2]
    lum = data @ _LUMA
    pdf = lum * np.sin(PI * (np.arange(h)[:, None] + 0.5) / h)
    pdf = pdf / pdf.sum()
    row_p = pdf.sum(axis=1)
    marginal_cdf = np.cumsum(row_p)
    conds = np.cumsum(pdf / np.maximum(row_p[:, None], 1e-30), axis=1)

    def conv(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    return Envmap(data=conv(data), pdf=conv(pdf),
                  marginal_cdf=conv(marginal_cdf),
                  conditional_cdf=conv(conds))


def searchsorted_right(table, row, q):
    """For each lane, the number of entries of table[row] (ascending) that
    are <= q: numpy's searchsorted(side="right") over the lane's own row.
    table [N, W]; row [S] int64; q [S].  A binary search of log2(W) steps,
    each one gather of [S]."""
    n_w = table.shape[1]
    flat = table.reshape(-1)
    base = row * n_w
    pos = torch.zeros_like(row)
    step = 1 << (n_w.bit_length() - 1)
    while step >= 1:
        cand = pos + step
        idx = base + torch.clamp(cand, max=n_w) - 1
        pos = torch.where((cand <= n_w) & (flat[idx] <= q), cand, pos)
        step >>= 1
    return pos


def _dir_to_xy(d, w: int, h: int):
    """dir -> continuous (x, y) pixel coords (environment_light.cpp:84-105)."""
    u = normalize(d)
    theta = torch.arccos(torch.clamp(u[..., 1], -1.0, 1.0))
    phi = torch.atan2(-u[..., 2], u[..., 0]) + PI
    return phi / (2.0 * PI) * w, theta / PI * h


def _bilerp(env: Envmap, x, y):
    """The reference's wrap-aware bilerp (environment_light.cpp:119-135)."""
    h, w = env.data.shape[:2]
    right = torch.round(x).to(torch.int64)
    v = torch.round(y).to(torch.int64)
    u1 = right.to(torch.float32) - x + 0.5
    wrap = (right == 0) | (right == w)
    left = torch.where(wrap, w - 1, right - 1).clamp(0, w - 1)
    right = torch.where(wrap, 0, right).clamp(0, w - 1)
    v1 = torch.where(v == 0, 1.0,
                     torch.where(v == h, 0.0, v.to(torch.float32) - y + 0.5))
    v = torch.clamp(torch.where(v == 0, 1, torch.where(v == h, h - 1, v)),
                    1, h - 1)
    top = v - 1
    u0 = 1.0 - u1
    d = env.data
    return ((d[top, left] * u1[..., None] + d[top, right] * u0[..., None])
            * v1[..., None]
            + (d[v, left] * u1[..., None] + d[v, right] * u0[..., None])
            * (1.0 - v1)[..., None])


def sample_dir(env: Envmap, d):
    """Radiance along direction d (primary-miss shading;
    environment_light.cpp:171-180)."""
    h, w = env.data.shape[:2]
    x, y = _dir_to_xy(d, w, h)
    return _bilerp(env, x, y)


def pdf_dir(env: Envmap, d):
    """Solid-angle pdf with which sample_L / sample_Le produce direction d:
    sample_L's p(w) formula evaluated at d's pixel (the env light's MIS pdf
    for BDPT strategy (d), the walk-miss pickup)."""
    h, w = env.data.shape[:2]
    x, y = _dir_to_xy(d, w, h)
    xi = torch.clamp(x.to(torch.int64), 0, w - 1)
    yi = torch.clamp(y.to(torch.int64), 0, h - 1)
    u = normalize(d)
    sin_t = torch.sqrt(torch.clamp_min(
        1.0 - torch.clamp(u[..., 1], -1.0, 1.0) ** 2, 0.0))
    return env.pdf[yi, xi] * (w * h) / (2.0 * PI * PI
                                        * torch.clamp_min(sin_t, 1e-6))


def sample_L(env: Envmap, p, u4):
    """NEE sample toward the env light: returns (radiance, wi, dist, pdf).

    u4: uniforms [S,4] — (column CDF, row CDF, x jitter, y jitter), the
    reference's uv sample and jitters (environment_light.cpp:149-160).
    p is unused (an infinite light), kept for the light interface."""
    del p
    h, w = env.data.shape[:2]
    zero = torch.zeros(u4.shape[:-1], dtype=torch.int64, device=u4.device)
    y = torch.clamp(searchsorted_right(env.marginal_cdf[None], zero,
                                       u4[..., 1]), 0, h - 1)
    x = torch.clamp(searchsorted_right(env.conditional_cdf, y, u4[..., 0]),
                    0, w - 1)
    xf = x.to(torch.float32) + u4[..., 2]
    yf = y.to(torch.float32) + u4[..., 3]
    theta = yf / h * PI
    phi = xf / w * 2.0 * PI
    wi = torch.stack([
        torch.cos(phi - PI) * torch.sin(theta),
        torch.cos(theta),
        -torch.sin(phi - PI) * torch.sin(theta)], dim=-1)
    pdf = env.pdf[y, x] * (w * h) / (2.0 * PI * PI * torch.clamp_min(
        torch.sin(theta), 1e-6))
    rad = _bilerp(env, xf, yf)
    dist = torch.full(pdf.shape, INF_D, device=pdf.device)
    return rad, wi, dist, pdf


def sample_Le(env: Envmap, center, radius, u4, u2):
    """Emit a light ray FROM the environment (pbrt-style infinite-light
    emission; the JAX package's extension of the reference, whose
    EnvironmentLight asserts on every BDPT method,
    environment_light.cpp:182-208).

    direction: a sample_L direction w (pointing TOWARD the env); the ray
    travels d = -w into the scene.  origin: a uniform point on the disk of
    the scene's bounding sphere (`center` [S,3], `radius` a 0-d tensor)
    perpendicular to w, pushed out by 2 * radius.
    Returns (radiance, o, d, point_pdf, dir_pdf): point_pdf = 1/(pi r^2)
    (area measure on the disk), dir_pdf the CDF pdf (solid angle)."""
    rad, w_dir, _dist, dir_pdf = sample_L(env, center, u4)
    frame = make_coord_space(w_dir)
    r_sq = torch.sqrt(u2[..., 0])
    phi = 2.0 * PI * u2[..., 1]
    ox = radius * r_sq * torch.cos(phi)
    oy = radius * r_sq * torch.sin(phi)
    o = (center + w_dir * (2.0 * radius)
         + frame[..., :, 0] * ox[..., None] + frame[..., :, 1] * oy[..., None])
    point_pdf = torch.full_like(dir_pdf, 1.0) / (PI * radius * radius)
    return rad, o, -w_dir, point_pdf, dir_pdf
