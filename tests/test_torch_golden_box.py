"""The port's BDPT render of the Cornell box on the CPU against the JAX
package's golden (tests/golden/torch_port/cornell_mg_bdpt_48x36_d5_8spp_
seed0.npz).  The other goldens' tests, their sanity check and the golden
writer are in tests/test_torch_golden.py; this render is the longest of
them, so it has a file of its own and a worker of its own under
`pytest -n --dist loadfile`.
"""

import numpy as np

from tests.test_torch_golden import GOLDEN, SETTINGS, SPHERES, block_err


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
    scene = make_cornell_box(sphere_materials=SPHERES, device="cpu")
    res = render(scene, RenderConfig(integrator="bdpt", **SETTINGS))
    ref_c = ref["eye"] + ref["light"]
    rel = abs(res.combined.mean() - ref_c.mean()) / ref_c.mean()
    assert rel <= 5e-3, rel
    err = block_err(ref_c, res.combined)
    assert err.mean() <= 0.02, (err.mean(), err.max())
    assert abs(res.stats["rays"] - float(ref["rays"])) \
        <= 1e-3 * float(ref["rays"]), (res.stats["rays"], ref["rays"])
