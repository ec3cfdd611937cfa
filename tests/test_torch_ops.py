"""Port ops/ (camera, BSDF, lights) against the JAX package, per lane on
shared inputs, rtol 1e-5 and atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.ops import bsdf as jb
from bidirectional_pathtracing_tpu.ops import camera_ops as jc
from bidirectional_pathtracing_tpu.ops import lights as jl
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu.scene import types as jtypes
from bidirectional_pathtracing_tpu_torch.ops import bsdf as tb
from bidirectional_pathtracing_tpu_torch.ops import camera_ops as tc
from bidirectional_pathtracing_tpu_torch.ops import lights as tl
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
from tests.test_torch_scene import port_scene

RTOL, ATOL = 1e-5, 1e-6
N = 400


def _close(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = np.asarray(x)
        y = y.numpy()
        x = np.broadcast_to(x, np.broadcast_shapes(x.shape, y.shape))
        y = np.broadcast_to(y, x.shape)
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


# --- camera -----------------------------------------------------------------

def test_generate_ray_matches_jax():
    js = jproc.make_cornell_box()
    ts = port_scene(js)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    (jx, jy), (tx, ty) = _both(xy[:, 0], xy[:, 1])
    _close(jc.generate_ray(js.camera, jx, jy),
           tc.generate_ray(ts.camera, tx, ty))


@pytest.mark.parametrize("size", [(480, 360), (16, 12), (1, 1)])
def test_sample_ray_pdf_matches_jax(size):
    js = jproc.make_cornell_box()
    ts = port_scene(js)
    rng = np.random.default_rng(1)
    p = rng.uniform([-1.5, -0.5, -1.5], [1.5, 2.0, 4.5], (N, 3)) \
        .astype(np.float32)
    (jp,), (tp,) = _both(p)
    a = jc.sample_ray_pdf(js.camera, jp, *size)
    b = tc.sample_ray_pdf(ts.camera, tp, *size)
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f))


# --- BSDF -------------------------------------------------------------------

MATERIALS = [
    {"kind": 0, "albedo": np.array([0.6, 0.5, 0.4])},                 # diffuse
    {"kind": 1, "emission": np.array([10.0, 9.0, 8.0])},              # emission
    {"kind": 2, "reflectance": np.array([0.9, 0.8, 0.7])},            # mirror
    {"kind": 3, "transmittance": np.array([0.9, 0.9, 0.8]), "ior": 1.5},
    {"kind": 4, "transmittance": np.array([0.9, 0.9, 0.9]),          # glass
     "reflectance": np.array([0.9, 0.9, 0.9]), "ior": 1.45},
    {"kind": 5, "roughness": 0.3, "eta": np.array([1.345, 0.965, 0.617]),
     "k": np.array([7.47, 6.40, 5.30])},                               # Al
]
KINDS = ["diffuse", "emission", "mirror", "refraction", "glass", "microfacet"]


def _bsdf_inputs(kind_id, seed):
    rng = np.random.default_rng(seed)
    wo = rng.normal(size=(N, 3))
    wi = rng.normal(size=(N, 3))
    wo[: N // 2, 2] = np.abs(wo[: N // 2, 2])    # half above the surface
    wi[: N // 4, 2] = np.abs(wi[: N // 4, 2])
    wo = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(np.float32)
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    u = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    mid = np.full((N,), kind_id, np.int32)
    mid[-5:] = -1                                 # invalid lanes
    return mid, wo, wi, u


@pytest.mark.parametrize("kind", KINDS)
def test_bsdf_matches_jax(kind):
    kid = KINDS.index(kind)
    jm, tm = jtypes.make_materials(MATERIALS), ttypes.make_materials(MATERIALS)
    mid, wo, wi, u = _bsdf_inputs(kid, kid)
    (jmid, jwo, jwi, ju), (tmid, two, twi, tu) = _both(mid, wo, wi, u)
    _close(jb.eval_f(jm, jmid, jwo, jwi), tb.eval_f(tm, tmid, two, twi))
    _close(jb.sample_pdf(jm, jmid, jwo, jwi),
           tb.sample_pdf(tm, tmid, two, twi))
    _close(jb.mis_pdf(jm, jmid, jwo, jwi), tb.mis_pdf(tm, tmid, two, twi))
    _close(jb.is_delta(jm, jmid), tb.is_delta(tm, tmid))
    _close(jb.emission(jm, jmid), tb.emission(tm, tmid))
    for adjoint in (False, True):
        a = jb.sample(jm, jmid, jwo, ju, adjoint=adjoint)
        b = tb.sample(tm, tmid, two, tu, adjoint=adjoint)
        for f in a._fields:
            _close(getattr(a, f), getattr(b, f))


# --- lights -----------------------------------------------------------------

LIGHTS = [
    {"kind": 0, "radiance": np.array([10.0, 10.0, 10.0]),
     "position": np.array([0.0, 1.49, 0.0]),
     "direction": np.array([0.0, -1.0, 0.0]),
     "dim_x": np.array([0.8, 0.0, 0.0]), "dim_y": np.array([0.0, 0.0, 0.6]),
     "area": 0.48},
    {"kind": 1, "radiance": np.array([3.0, 2.0, 1.0]),
     "position": np.array([0.3, 1.0, -0.2])},
    {"kind": 2, "radiance": np.array([1.0, 1.0, 1.0]),
     "direction": np.array([0.2, 1.0, 0.1])},
    {"kind": 3, "radiance": np.array([0.5, 0.5, 0.5])},
]


def _light_inputs(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(LIGHTS), N).astype(np.int32)
    p = rng.uniform([-1, 0, -1], [1, 1.4, 1], (N, 3)).astype(np.float32)
    u2 = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    u2b = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    return idx, p, u2, u2b


@pytest.mark.parametrize("quirks", [True, False])
def test_sample_L_matches_jax(quirks):
    jlt, tlt = jtypes.make_lights(LIGHTS), ttypes.make_lights(LIGHTS)
    idx, p, u2, _ = _light_inputs(0)
    (ji, jp, ju), (ti, tp, tu) = _both(idx, p, u2)
    a = jl.sample_L(jlt, ji, jp, ju, reference_quirks=quirks)
    b = tl.sample_L(tlt, ti, tp, tu, reference_quirks=quirks)
    for f in a._fields:
        _close(getattr(a, f), getattr(b, f))


def test_light_bdpt_interface_matches_jax():
    jlt, tlt = jtypes.make_lights(LIGHTS), ttypes.make_lights(LIGHTS)
    assert tl.num_lights(tlt) == jl.num_lights(jlt) == len(LIGHTS)
    idx, p, u2, u2b = _light_inputs(1)
    (ji, jp, ju, jv), (ti, tp, tu, tv) = _both(idx, p, u2, u2b)
    for a, b in ((jl.sample_Le(jlt, ji, ju, jv), tl.sample_Le(tlt, ti, tu, tv)),
                 (jl.sample_Le_point(jlt, ji, jp, ju),
                  tl.sample_Le_point(tlt, ti, tp, tu))):
        for f in a._fields:
            _close(getattr(a, f), getattr(b, f))
    # points on the area light (contained) and off it, toward-light dirs
    on = p.copy()
    on[: N // 2, 1] = 1.49
    on[: N // 2, 0] = np.clip(on[: N // 2, 0], -0.4, 0.4)
    on[: N // 4] = [0.3, 1.0, -0.2]                 # the point light
    wi = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    (jo, jw), (to, tw) = _both(on, wi)
    _close(jl.contain_point(jlt, ji, jo), tl.contain_point(tlt, ti, to))
    _close(jl.sample_pdf(jlt, ji, jo, jw), tl.sample_pdf(tlt, ti, to, tw))
