"""Port models/pathtracer.py and the thin-lens camera against the JAX
package.

One PT pass at 16x12 (sample_camera_rays, then trace_radiance, on the same
pass key and lane keys) per case, held per lane at rtol 1e-4: diffuse d3,
mirror/glass d5, the open env scene lit by the synthetic sky, hemisphere
direct sampling, a thin lens, pt_mis in the mirror/glass box under the sky
(area and env MIS), and Russian roulette.  The measured rays must be equal.

The JAX side runs op by op (jax.disable_jit), as torch does.  Under jit
XLA fuses and contracts the float ops, which moves last bits: a jitted
pass disagrees with its own eager run on a few lanes of the mirror/glass
box and on the ray count (1,009 against 1,011 in the diffuse d3 case), so
the jitted pass would hold the port to a looser bound than eager JAX does.
The diffuse cases are held on >= 99 % of lanes; where a sphere can flip a
branch (mirror/glass, the open scene's spheres under the sky), on >= 98 %
(tests/test_torch_bdpt.py says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
from bidirectional_pathtracing_tpu.core import rng as jrng
from bidirectional_pathtracing_tpu.models import pathtracer as jpt
from bidirectional_pathtracing_tpu.ops import camera_ops as jc
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu_torch.config import RenderConfig as TConfig
from bidirectional_pathtracing_tpu_torch.core import rng as trng
from bidirectional_pathtracing_tpu_torch.models import pathtracer as tpt
from bidirectional_pathtracing_tpu_torch.ops import camera_ops as tc
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
from tests.test_torch_bdpt import agreement
from tests.test_torch_env_bdpt import env_scene_arrays, jax_env_scene
from tests.test_torch_scene import jax_scene_arrays

W, H = 16, 12
LENS = dict(lens_radius=0.05, focal_distance=4.0)


def jax_scene(name):
    """The JAX package's scene of a per-lane case."""
    if name == "cornell":
        return jproc.make_cornell_box()
    if name == "cornell_mg":
        return jproc.make_cornell_box(sphere_materials=("mirror", "glass"))
    if name == "cornell_lens":
        js = jproc.make_cornell_box()
        return js._replace(camera=js.camera._replace(
            **{k: jnp.float32(v) for k, v in LENS.items()}))
    return jax_env_scene(name)          # "open", "cornell_mg_sky"


def to_port(js):
    arrays = (env_scene_arrays(js) if js.envmap is not None
              else jax_scene_arrays(js))
    return ttypes.from_numpy(arrays, "cpu")


def pt_pass(pkg, scene, cfg, pass_index=0):
    """(L [S,3] as numpy, measured rays) of one PT pass through `pkg`."""
    pix = np.arange(W * H, dtype=np.int32)
    if pkg == "jax":
        with jax.disable_jit():
            keys = jrng.lane_keys(
                jax.random.fold_in(jax.random.key(0), pass_index),
                jnp.asarray(pix))
            o, d = jpt.sample_camera_rays(scene, keys, W, H,
                                          jnp.asarray(pix), cfg)
            L, st = jpt.trace_radiance(scene, o, d, keys, cfg,
                                       return_stats=True)
        return np.asarray(L), int(float(st["rays"]))
    keys = trng.lane_keys(trng.fold_in(trng.key(0), pass_index),
                          torch.from_numpy(pix))
    o, d = tpt.sample_camera_rays(scene, keys, W, H, torch.from_numpy(pix),
                                  cfg)
    L, st = tpt.trace_radiance(scene, o, d, keys, cfg, return_stats=True)
    return L.numpy(), int(st["rays"])


@pytest.mark.parametrize("scene,settings,min_lanes", [
    ("cornell", dict(max_ray_depth=3), 0.99),
    ("cornell_mg", dict(max_ray_depth=5), 0.98),
    ("open", dict(max_ray_depth=3), 0.98),
    ("cornell", dict(max_ray_depth=3, direct_hemisphere_sample=True), 0.99),
    ("cornell_lens", dict(max_ray_depth=3), 0.99),
    ("cornell_mg_sky", dict(max_ray_depth=4, pt_mis=True), 0.98),
    ("cornell", dict(max_ray_depth=0, rr_depth_cap=4), 0.99)],
    ids=["diffuse_d3", "mirror_glass_d5", "sky", "hemisphere", "thin_lens",
         "pt_mis_sky", "russian_roulette"])
def test_trace_radiance_matches_jax(scene, settings, min_lanes):
    js = jax_scene(scene)
    cfg = dict(spp=1, width=W, height=H, integrator="pt", **settings)
    ref, ref_rays = pt_pass("jax", js, JConfig(**cfg))
    got, rays = pt_pass("torch", to_port(js), TConfig(**cfg))
    assert got.shape == ref.shape == (W * H, 3)
    assert np.isfinite(got).all()
    assert ref.mean() > 0
    lanes, mean_agree, mean_frame = agreement(ref, got)
    assert lanes >= min_lanes, lanes
    assert mean_agree <= 1e-4, mean_agree
    assert mean_frame <= 0.01, mean_frame
    assert rays == ref_rays


@pytest.mark.parametrize("scene", ["cornell", "open"])
def test_thin_lens_rays_match_jax(scene):
    """generate_ray_thin_lens on each scene's camera with a 0.05 lens
    focused at 4.0: elementwise rtol 1e-6 against the JAX package; with
    lens_radius 0, generate_ray bit for bit."""
    js = jax_scene(scene)
    ts = to_port(js)
    rng = np.random.default_rng(3)
    x, y, r = rng.uniform(size=(3, 500)).astype(np.float32)
    th = (rng.uniform(size=500) * 2 * np.pi).astype(np.float32)
    jcam = js.camera._replace(**{k: jnp.float32(v) for k, v in LENS.items()})
    tcam = ts.camera._replace(**{k: torch.tensor(v) for k, v in LENS.items()})
    jo, jd = jc.generate_ray_thin_lens(jcam, *map(jnp.asarray, (x, y, r, th)))
    to, td = tc.generate_ray_thin_lens(tcam,
                                       *map(torch.from_numpy, (x, y, r, th)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    assert float(torch.linalg.vector_norm(to - ts.camera.pos, dim=-1).max()) \
        <= LENS["lens_radius"] * (1 + 1e-6)
    pin = ts.camera._replace(lens_radius=torch.tensor(0.0))
    po, pd = tc.generate_ray(pin, torch.from_numpy(x), torch.from_numpy(y))
    lo, ld = tc.generate_ray_thin_lens(pin, *map(torch.from_numpy,
                                                 (x, y, r, th)))
    assert torch.equal(lo, po) and torch.equal(ld, pd)
