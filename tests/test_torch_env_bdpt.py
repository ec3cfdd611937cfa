"""The port's environment-light BDPT against the JAX package's.

Three env scenes, each built by the JAX package and converted leaf by leaf
(envmap included), at 16x12, depth 3:

  - the open env scene (examples/inverse_rendering.py `_open_scene` with
    the synthetic sky): env light only, families (a)-(d);
  - the Cornell box with diffuse spheres plus the sky: mixed env and area
    light;
  - the Cornell box with mirror and glass spheres plus the sky: the delta
    chains of family (d).

One sample_pass per scene is held per lane as tests/test_torch_bdpt.py
holds the env-free pass (rtol 1e-4 on the eye and light images, means over
agreeing lanes, frame means within 1 %, measured rays within 1 %).  The
open scene agrees on >= 99 % of lanes.  Both Cornell boxes are held to
>= 98 %: besides the walk's known sphere self-hit flips, env NEE casts a
shadow ray from every diffuse vertex, and from a vertex on a sphere that
ray can find the sphere again at t within float32 noise of EPS_F in one
package and not the other (one such lane of 192 in the diffuse box, where
the sun of the sky sits behind it).

render() of the open scene at 2 spp is held against the JAX render; the
port's CPU render against the JAX golden is in tests/test_torch_golden.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.config import RenderConfig as JConfig
from bidirectional_pathtracing_tpu.models import bdpt as jb
from bidirectional_pathtracing_tpu.ops import envlight as jenv
from bidirectional_pathtracing_tpu.scene import procedural as jproc
from bidirectional_pathtracing_tpu.utils.render import render as jrender
from bidirectional_pathtracing_tpu_torch.config import RenderConfig as TConfig
from bidirectional_pathtracing_tpu_torch.core import rng as trng
from bidirectional_pathtracing_tpu_torch.models import bdpt as tb
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene import types as ttypes
from bidirectional_pathtracing_tpu_torch.utils import render as trender
from tests.test_torch_bdpt import _JAX_PASS, agreement
from tests.test_torch_render import _check_render
from tests.test_torch_scene import assert_leaves_equal, jax_scene_arrays

W, H, DEPTH = 16, 12, 3


def jax_env_scene(name):
    """The JAX package's env scene `name` with the port's synthetic sky."""
    from examples.inverse_rendering import _open_scene
    base = {"open": _open_scene,
            "cornell_sky": jproc.make_cornell_box,
            "cornell_mg_sky": lambda: jproc.make_cornell_box(
                sphere_materials=("mirror", "glass"))}[name]()
    return base._replace(envmap=jenv.build_envmap(tproc.synthetic_sky()))


def env_scene_arrays(js) -> dict:
    """jax_scene_arrays plus the "envmap.<field>" leaves."""
    arrays = jax_scene_arrays(js)
    arrays.update({f"envmap.{f}": np.asarray(getattr(js.envmap, f))
                   for f in js.envmap._fields})
    return arrays


def test_open_env_scene_and_envmap_leaves_match_jax():
    """make_open_env_scene equals the JAX package's open scene with the sky
    attached, leaf by leaf and bit for bit, and the envmap leaves survive
    to_numpy / from_numpy."""
    from examples.inverse_rendering import _env_image
    img = _env_image()
    if img.shape == (32, 64, 3):        # the fallback sky, not a real .exr
        np.testing.assert_array_equal(tproc.synthetic_sky(), img)
    ref = env_scene_arrays(jax_env_scene("open"))
    mine = tproc.make_open_env_scene(device="cpu")
    assert_leaves_equal(ref, ttypes.to_numpy(mine))
    again = ttypes.from_numpy(ttypes.to_numpy(mine), "cpu")
    assert isinstance(again.envmap, ttypes.Envmap)
    assert_leaves_equal(ref, ttypes.to_numpy(again))


@pytest.mark.parametrize("name,min_lanes,mean_tol", [
    ("open", 0.99, 1e-4),
    ("cornell_sky", 0.98, 1e-4),
    ("cornell_mg_sky", 0.98, 1e-3)])
def test_env_sample_pass_matches_jax(name, min_lanes, mean_tol):
    js = jax_env_scene(name)
    ts = ttypes.from_numpy(env_scene_arrays(js), "cpu")
    pix = np.arange(W * H, dtype=np.int32)
    ref = _JAX_PASS(js, jax.random.fold_in(jax.random.key(0), 0), width=W,
                    height=H, pixel_ids=jnp.asarray(pix),
                    cfg=JConfig(spp=1, max_ray_depth=DEPTH, width=W,
                                height=H),
                    return_stats=True)
    got = tb.sample_pass(ts, trng.fold_in(trng.key(0), 0), W, H,
                         torch.from_numpy(pix),
                         TConfig(spp=1, max_ray_depth=DEPTH, width=W,
                                 height=H), return_stats=True)
    for k in (0, 1):    # eye_L, light image (env splats included)
        assert float(np.asarray(ref[k]).sum()) > 0
        lanes, mean_agree, mean_frame = agreement(ref[k], got[k].numpy())
        assert lanes >= min_lanes, (k, lanes)
        assert mean_agree <= mean_tol, (k, mean_agree)
        assert mean_frame <= 0.01, (k, mean_frame)
    assert abs(int(got[2]["rays"]) - float(ref[2]["rays"])) \
        <= 0.01 * float(ref[2]["rays"])
    # without the envmap the same scene renders none of the env families
    dark = tb.sample_pass(ts._replace(envmap=None),
                          trng.fold_in(trng.key(0), 0), W, H,
                          torch.from_numpy(pix),
                          TConfig(spp=1, max_ray_depth=DEPTH, width=W,
                                  height=H), return_stats=True)
    assert int(dark[2]["rays"]) < int(got[2]["rays"])
    if name == "open":
        assert float(dark[0].abs().max()) == 0.0
        assert float(dark[1].abs().max()) == 0.0


def test_env_render_matches_jax():
    settings = dict(spp=2, max_ray_depth=DEPTH, width=W, height=H, seed=0)
    js = jax_env_scene("open")
    ref = jrender(js, JConfig(**settings))
    got = trender.render(ttypes.from_numpy(env_scene_arrays(js), "cpu"),
                         TConfig(**settings))
    _check_render(ref, got, 0.98, 1e-4)
    assert got.light.sum() > 0


def test_scene_builders_default_to_the_card():
    """A scene built without a device lies on the card; where there is
    none, building it raises (no fallback to the CPU)."""
    if torch.cuda.is_available():
        assert tproc.make_cornell_box().device.type == "cuda"
        assert tproc.make_open_env_scene().envmap.data.is_cuda
        return
    for build in (tproc.make_cornell_box, tproc.make_open_env_scene,
                  lambda: tproc.make_mesh_cornell_box(1),
                  lambda: ttypes.make_lights([{"kind": 0}])):
        with pytest.raises((AssertionError, RuntimeError)):
            build()
