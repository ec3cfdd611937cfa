"""The brute-force CUDA kernel against its plain torch version, on the card.

Jax-free, so it runs where the card is (that machine has no jax; the
repo's conftest imports it, so pass --noconftest):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Here, without a card, every test skips.
"""

import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu_torch.core.math import EPS_F, INF_D
from bidirectional_pathtracing_tpu_torch.ops import intersect_brute as ib
from bidirectional_pathtracing_tpu_torch.ops.intersect import PLAIN
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box)
from bidirectional_pathtracing_tpu_torch.scene.types import make_geometry

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _soup(device, n_tris=1000, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform([-1.0, 0.0, -1.0], [1.0, 1.5, 1.0], (n_tris, 1, 3))
    p = (c + rng.uniform(-0.1, 0.1, (n_tris, 3, 3))).astype(np.float32)
    box = make_cornell_box(device=device)
    g = box.geometry
    return box._replace(geometry=make_geometry(
        p, np.zeros_like(p) + [0, 1, 0], np.zeros(n_tris, np.int32),
        g.sph_c.cpu().numpy(), g.sph_r.cpu().numpy(),
        g.sph_mat.cpu().numpy(), device=device))


@pytest.mark.parametrize("scene", ["cornell", "soup"])
def test_kernel_matches_plain(cuda, scene):
    sc = make_cornell_box(device=cuda) if scene == "cornell" else _soup(cuda)
    g = sc.geometry
    rng = np.random.default_rng(1)
    n = 50_001                       # a ragged last block
    o = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                         .astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    hi = torch.from_numpy(rng.uniform(0.1, 3.0, n).astype(np.float32)).to(cuda)
    for lo, mx in ((EPS_F, INF_D), (EPS_F, hi)):
        before = ib.brute_hit.launches
        t, prim = ib.brute_hit(g, o, d, lo, mx)
        assert ib.brute_hit.launches == before + 1
        assert prim.dtype == torch.int32 and t.dtype == torch.float32
        rt, rp = ib.brute_hit_plain(g, o, d, lo, mx)
        torch.cuda.synchronize()
        bad = ((t < INF_D) != (rt < INF_D)) | (prim != rp)
        assert int(bad.sum()) <= n // 10_000, int(bad.sum())
        ok = ~bad & (rt < INF_D)
        tri = ok & (rp < g.num_tris)
        torch.testing.assert_close(t[tri], rt[tri], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(t[ok & ~tri], rt[ok & ~tri], rtol=1e-4,
                                   atol=0.0)


def test_kernel_rejects_wrong_input(cuda):
    g = make_cornell_box(device=cuda).geometry
    o = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        ib.brute_hit(g, o, o, 0.0, 1.0)
    with pytest.raises(ValueError):
        ib.brute_hit(g, o.float()[:, :2], o.float()[:, :2], 0.0, 1.0)


def test_render_through_kernel_matches_plain(cuda):
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    box = make_cornell_box(sphere_materials=("mirror", "glass"), device=cuda)
    cfg = RenderConfig(spp=2, max_ray_depth=4, width=64, height=48)
    before = ib.brute_hit.launches
    a = render(box, cfg)
    assert ib.brute_hit.launches - before == 2 * (4 + 4 + 1)
    b = render(box, cfg, isect=PLAIN)
    assert ib.brute_hit.launches - before == 2 * (4 + 4 + 1)
    np.testing.assert_allclose(a.combined.mean(), b.combined.mean(),
                               rtol=1e-3)
