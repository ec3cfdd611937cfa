"""Port scene schema against the JAX package: the Cornell box leaf by leaf,
the from_numpy bridge, the host builders and RenderConfig.

Also holds the helpers the other test_torch_* files share."""

import dataclasses

import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu import config as jcfg
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu.scene import types as jtypes
from bidirectional_pathtracing_tpu_torch import config as tcfg
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes

PARTS = ("geometry", "materials", "lights", "camera")
SPHERE_SETS = [("diffuse", "diffuse"), ("mirror", "glass"),
               ("microfacet", "diffuse")]


def jax_scene_arrays(scene) -> dict:
    """A JAX Scene as {"<part>.<field>": ndarray}, leaf by leaf."""
    return {f"{part}.{f}": np.asarray(getattr(getattr(scene, part), f))
            for part in PARTS for f in getattr(scene, part)._fields}


def port_scene(jax_scene, device="cpu"):
    """The port's Scene built from a JAX Scene's leaves."""
    return ttypes.from_numpy(jax_scene_arrays(jax_scene), device)


def assert_leaves_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("spheres", SPHERE_SETS)
def test_cornell_box_matches_jax_bitwise(spheres):
    ref = jax_scene_arrays(jproc.make_cornell_box(sphere_materials=spheres))
    mine = ttypes.to_numpy(tproc.make_cornell_box(sphere_materials=spheres))
    assert_leaves_equal(ref, mine)


def test_from_numpy_round_trip():
    arrays = jax_scene_arrays(
        jproc.make_cornell_box(sphere_materials=("mirror", "glass")))
    scene = ttypes.from_numpy(arrays, "cpu")
    assert scene.device == torch.device("cpu")
    assert scene.geometry.tri_valid.dtype == torch.bool
    assert scene.materials.kind.dtype == torch.int32
    assert scene.bvh is None and scene.envmap is None
    assert_leaves_equal(arrays, ttypes.to_numpy(scene))


def test_host_builders_match_jax():
    rng = np.random.default_rng(0)
    tri_p = rng.normal(size=(5, 3, 3)).astype(np.float32)
    tri_n = rng.normal(size=(5, 3, 3)).astype(np.float32)
    cases = [dict(), dict(sph_c=[[0, 1, 2]], sph_r=[0.5], sph_mat=[1]),
             dict(min_tris=8, min_spheres=3)]
    for kw in cases:
        g_j = jtypes.make_geometry(tri_p, tri_n, [0, 1, 2, 3, 4],
                                   to_device=False, **kw)
        g_t = ttypes.make_geometry(tri_p, tri_n, [0, 1, 2, 3, 4], **kw)
        for f in g_j._fields:
            a, b = np.asarray(getattr(g_j, f)), getattr(g_t, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    mats = [{"kind": 0, "albedo": [0.1, 0.2, 0.3]},
            {"kind": 5, "roughness": 0.2, "eta": [1, 2, 3]}]
    lights = [{"kind": 0, "radiance": [1, 2, 3], "area": 0.5},
              {"kind": 1, "position": [0, 1, 0]}]
    for jf, tf, rec in ((jtypes.make_materials, ttypes.make_materials, mats),
                        (jtypes.make_lights, ttypes.make_lights, lights),
                        (jtypes.make_lights, ttypes.make_lights, [])):
        a, b = jf(rec), tf(rec)
        for f in a._fields:
            x, y = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_render_config_fields_and_defaults_match_jax():
    ja = {f.name: f.default for f in dataclasses.fields(jcfg.RenderConfig)}
    to = {f.name: f.default for f in dataclasses.fields(tcfg.RenderConfig)}
    assert list(ja) == list(to)
    assert ja == to
    with pytest.raises(ValueError):
        tcfg.RenderConfig(integrator="nope")
