"""The port's render on the CPU against a golden written by the JAX package.

tests/golden/torch_port/cornell_mg_bdpt_48x36_d5_8spp_seed0.npz holds the
eye and light images of the JAX package's BDPT render of the Cornell box
with mirror and glass spheres at 48x36, depth 5, 8 spp, seed 0, on the CPU.
chip_smoke.py holds the port's render on the card against the same file.

Regenerate it (CPU, about a minute) with

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port",
                      "cornell_mg_bdpt_48x36_d5_8spp_seed0.npz")
SETTINGS = dict(spp=8, max_ray_depth=5, width=48, height=36, seed=0)
SPHERES = ("mirror", "glass")


def block_err(ref, mine, nb=8, floor=0.05):
    """Relative error of nb x nb block means (tests/test_bdpt.py idiom)."""
    def blocks(img):
        bh, bw = img.shape[0] // nb, img.shape[1] // nb
        return img[:bh * nb, :bw * nb].reshape(nb, bh, nb, bw, -1).mean((1, 3))
    a, b = blocks(ref), blocks(mine)
    return np.abs(a - b) / (np.abs(a) + floor)


def write_golden():
    """Render with the JAX package on the CPU and write the golden."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    from bidirectional_pathtracing_tpu.config import RenderConfig
    from bidirectional_pathtracing_tpu.scene.procedural import make_cornell_box
    from bidirectional_pathtracing_tpu.utils.render import render
    scene = make_cornell_box(sphere_materials=SPHERES)
    res = render(scene, RenderConfig(integrator="bdpt", **SETTINGS))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, eye=res.eye.astype(np.float32),
                        light=res.light.astype(np.float32),
                        rays=np.float64(res.stats["rays"]))
    print(f"wrote {GOLDEN}: eye mean {res.eye.mean():.6f}, "
          f"light mean {res.light.mean():.6f}")


def test_port_cpu_render_matches_jax_golden():
    """Same seed, same sample streams: the port on the CPU reproduces the
    JAX render up to the lanes where a last-bit difference flips a sampled
    branch (mirror/glass), so the bounds are the card's (chip_smoke.py
    phase 3b): frame mean within 0.5 %, 8x8-block error at most 2 %."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_cornell_box)
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    ref = np.load(GOLDEN)
    scene = make_cornell_box(sphere_materials=SPHERES)
    res = render(scene, RenderConfig(integrator="bdpt", **SETTINGS))
    ref_c = ref["eye"] + ref["light"]
    rel = abs(res.combined.mean() - ref_c.mean()) / ref_c.mean()
    assert rel <= 5e-3, rel
    err = block_err(ref_c, res.combined)
    assert err.mean() <= 0.02, (err.mean(), err.max())
    assert abs(res.stats["rays"] - float(ref["rays"])) \
        <= 1e-3 * float(ref["rays"]), (res.stats["rays"], ref["rays"])


if __name__ == "__main__":
    write_golden()
