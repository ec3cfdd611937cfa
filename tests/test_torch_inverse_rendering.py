"""The port's inverse-rendering example (bidirectional_pathtracing_tpu_torch/
examples/inverse_rendering.py) converges, as tests/test_inverse_rendering.py
holds the JAX example, and renders the JAX example's targets.

At 150 steps, lr 0.03, 40x30 on the CPU the envlight mode's albedo and
|log env scale| errors fall from 0.300 and 0.916 to 0.001 and 0.001, step
for step within 1e-4 of the JAX example's printed errors.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu_torch.examples import inverse_rendering


def _args(**kw):
    base = dict(steps=150, lr=0.03, size=[40, 30], mode="envlight",
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_envlight_inverse_recovers_albedo_and_scale():
    # run_envlight asserts that both errors halve
    hist = inverse_rendering.run_envlight(_args())
    assert hist["albedo_err"][-1] < 0.01 and hist["log_scale_err"][-1] < 0.01


def test_envlight_targets_match_jax():
    """The port's four targets equal the JAX example's render_once
    (jitted, as the example runs it) within 1e-5 on at least 98 % of the
    lanes, and in the frame mean within 1 %.  The other lanes are the
    sphere self-hits of ROADMAP C3: a grazing ray leaving a sphere finds it
    again at a t within float32 noise of the EPS_F window and the two
    packages round it apart (14-19 of 1,200 lanes per target, jitted or
    op by op; tests/test_torch_bdpt.py)."""
    from bidirectional_pathtracing_tpu.config import RenderConfig
    from bidirectional_pathtracing_tpu.core import rng
    from bidirectional_pathtracing_tpu.models import pathtracer as pt
    from bidirectional_pathtracing_tpu.ops import envlight as envops
    from examples.inverse_rendering import _env_image, _open_scene
    w, h = 40, 30
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=w, height=h,
                       integrator="pt", light_samples=1)
    base = _open_scene()
    env = envops.build_envmap(_env_image())
    pix = jnp.arange(w * h, dtype=jnp.int32)

    @jax.jit
    def render_once(albedo, log_scale, key):
        s = base._replace(materials=base.materials._replace(albedo=albedo),
                          envmap=env._replace(
                              data=env.data * jnp.exp(log_scale)))
        keys = rng.lane_keys(key, pix)
        o, d = pt.sample_camera_rays(s, keys, w, h, pix, cfg)
        return pt.trace_radiance(s, o, d, keys, cfg)

    key0 = jax.random.key(7)
    mine, scene = inverse_rendering.envlight_problem(w, h, "cpu")
    zero = torch.zeros(())
    for i, key in enumerate(inverse_rendering.target_keys(7)):
        ref = np.asarray(render_once(base.materials.albedo, jnp.float32(0.0),
                                     jax.random.fold_in(key0, i)))
        with torch.no_grad():
            got = mine(scene.materials.albedo, zero, key).numpy()
        assert got.shape == ref.shape == (w * h, 3)
        close = (np.abs(got - ref) <= 1e-5).all(-1)
        assert close.mean() >= 0.98, (i, int((~close).sum()))
        assert abs(got.mean() - ref.mean()) <= 0.01 * ref.mean(), i


@pytest.mark.slow
def test_box_inverse_recovers_albedo():
    # the example's defaults (60 steps at 48x36, BDPT), as the JAX twin
    inverse_rendering.main(["--device", "cpu"])
