"""Vectorized geometry helpers shared by all integrators (PyTorch port of
bidirectional_pathtracing_tpu/core/math.py).

Numerical semantics follow the reference CGL library:
  - make_coord_space: reference src/pathtracer/bsdf.cpp:21-41
  - reflect/refract:  reference src/pathtracer/advanced_bsdf.cpp:272-303
  - luminance:        reference CGL/include/CGL/vector3D.h:231 (illum())
All functions are batched: vectors have shape [..., 3] and operate
elementwise over leading dims.
"""

from __future__ import annotations

import math

import torch

PI = math.pi
EPS_F = 1e-5          # reference CGL/include/CGL/misc.h (EPS_F = 1e-5 float)
INF_D = 1e30          # miss sentinel (finite, like the JAX package)

# Rec.709 luma weights used by Vector3D::illum() in the reference.
_LUMA = (0.2126, 0.7152, 0.0722)

# const()'s tensors, by (values, dtype, device)
_CONSTS: dict = {}


def const(values: tuple, dtype, device) -> torch.Tensor:
    """The tensor of the nested tuple `values` on `device`, made on first
    use and kept.  Making it uploads from the host and waits for the
    device, which a CUDA graph cannot capture (utils/step_graph.py): a
    pass's warm-up makes its constants, its capture reads them.  Never
    modify the returned tensor in place."""
    key = (values, dtype, str(torch.device(device)))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 0.0))


def norm2(v):
    return torch.sum(v * v, dim=-1)


def normalize(v, eps: float = 1e-20):
    return v / torch.clamp_min(norm(v), eps)[..., None]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def luminance(c):
    """Vector3D::illum(): 0.2126 r + 0.7152 g + 0.0722 b."""
    w = const(_LUMA, c.dtype, c.device)
    return torch.sum(c * w, dim=-1)


def make_coord_space(n):
    """Orthonormal frame with +z == n; o2w [..., 3, 3] with columns
    (x, y, z=n) so that ``world = o2w @ local`` (bsdf.cpp:21-41): h = n with
    its smallest-|component| set to 1, y = normalize(h x z),
    x = normalize(z x y).  x wins ties against y and z; y against z."""
    z = normalize(n)
    an = torch.abs(n)
    ax, ay, az = an[..., 0], an[..., 1], an[..., 2]
    pick_x = (ax <= ay) & (ax <= az)
    pick_y = (~pick_x) & (ay <= az)
    h = torch.stack([
        torch.where(pick_x, 1.0, n[..., 0]),
        torch.where(pick_y, 1.0, n[..., 1]),
        torch.where(~(pick_x | pick_y), 1.0, n[..., 2]),
    ], dim=-1)
    y = normalize(cross(h, z))
    x = normalize(cross(z, y))
    return torch.stack([x, y, z], dim=-1)


def to_local(o2w, v_world):
    """w2o = o2w^T applied to v: local = o2w^T v."""
    return torch.sum(o2w * v_world[..., :, None], dim=-2)


def to_world(o2w, v_local):
    return torch.sum(o2w * v_local[..., None, :], dim=-1)


def reflect_local(wo):
    """Mirror reflection about local normal (0,0,1); advanced_bsdf.cpp:272-278."""
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def refract_local(wo, ior):
    """Snell refraction in the local frame; advanced_bsdf.cpp:280-303.

    Returns (wi, ok) where ok=False marks total internal reflection.
    ``ior`` broadcasts against wo's leading dims.
    """
    enter = wo[..., 2] > 0
    eta = torch.where(enter, 1.0 / ior, ior)
    z_sq = 1.0 - eta * eta * (1.0 - wo[..., 2] * wo[..., 2])
    ok = z_sq >= 0
    sgn = torch.where(enter, -1.0, 1.0)
    z = sgn * torch.sqrt(torch.clamp_min(z_sq, 0.0))
    wi = torch.stack([-eta * wo[..., 0], -eta * wo[..., 1], z], dim=-1)
    return wi, ok
