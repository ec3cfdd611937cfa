"""benchmark/roofline.py, the frozen roofline counts, against the
functions it copies (chip_smoke.py bound_ms, ray_bytes, brute_work,
clustered_work) on the Cornell box and the level-2 mesh box with a few
thousand rays, and exactly on a case counted by hand."""

import os
import sys

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.scenes import cornell_box, mesh_box

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPHERES = ["mirror", "glass"]


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    return cs


def _rays(scene, n, seed):
    g = torch.Generator().manual_seed(seed)
    o = scene.camera.pos + 0.01 * torch.randn((n, 3), generator=g)
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    return o.contiguous(), d.contiguous()


def _scene(a):
    from benchmark.scene import program_scene
    return program_scene(a, torch.device("cpu"))


def test_constants_and_bound_match_chip_smoke(chip_smoke):
    assert (roofline.HBM_BPS, roofline.FP32_FLOPS) == (
        chip_smoke.HBM_BPS, chip_smoke.FP32_FLOPS)
    assert (roofline.MT_FLOPS, roofline.SPHERE_FLOPS, roofline.SLAB_FLOPS) \
        == (chip_smoke.MT_FLOPS, chip_smoke.SPHERE_FLOPS,
            chip_smoke.SLAB_FLOPS)
    for b, o in ((1e9, 1e9), (1e6, 1e12), (0, 0)):
        assert roofline.bound_ms(b, o) == chip_smoke.bound_ms(b, o)


def test_brute_work_matches_chip_smoke_on_the_cornell_box(chip_smoke):
    scene = _scene(cornell_box.arrays({"sphere_materials": SPHERES}))
    o, _ = _rays(scene, 3000, 1)
    hi = torch.full((3000,), 50.0)
    for lo, h in ((0.01, 100.0), (torch.zeros(3000), hi)):
        assert roofline.brute_work(scene.geometry, lo, h, 3000) == \
            chip_smoke.brute_work(scene.geometry, lo, h, 3000)
        assert roofline.ray_bytes(3000, lo, h) == \
            chip_smoke.ray_bytes(3000, lo, h)


def test_clustered_work_matches_chip_smoke_on_the_l2_mesh_box(chip_smoke):
    from bidirectional_pathtracing_tpu_torch.scene.clusters import (
        build_clusters)
    scene = _scene(mesh_box.arrays({"sphere_level": 2,
                                    "sphere_materials": SPHERES}))
    cl = build_clusters(scene.geometry, device="cpu")
    n = 4000
    o, d = _rays(scene, n, 2)
    lo = torch.full((n,), 0.01)
    g = torch.Generator().manual_seed(3)
    hi = 0.5 + 5.0 * torch.rand((n,), generator=g)
    occ = torch.rand((n,), generator=g) < 0.3
    nb = roofline.ray_bytes(n, lo, hi)
    ours = roofline.clustered_work(cl, o, d, lo, hi, occ, nb)
    theirs = chip_smoke.clustered_work(cl, o, d, lo, hi, occ, nb)
    assert ours == theirs[:2]
    assert ours[1] > 0


def test_counts_by_hand():
    """Two rays against one triangle and one sphere slot with a scalar
    window, and against a hand-made K2 table of one block, one cluster of
    two filled slots, with per-ray windows."""
    from types import SimpleNamespace
    geom = SimpleNamespace(tri_valid=torch.tensor([True]),
                           sph_valid=torch.tensor([True]),
                           num_tris=1, num_spheres=1)
    n_bytes, ops = roofline.brute_work(geom, 0.0, 1.0, 2)
    assert n_bytes == 32 * 2 + 36 + 20
    assert ops == 2 * (55 + 30)
    # one block and one cluster, both the box [0, 1]^3, two filled slots
    # of a 128-slot cluster
    box = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0, 0.0])
    p2g = torch.full((128,), -1, dtype=torch.int32)
    p2g[:2] = torch.tensor([0, 1], dtype=torch.int32)
    cl = SimpleNamespace(n_clusters=1, n_blocks=1, pad2global=p2g,
                         block_b=box[None, :], cluster_b=box[:, None],
                         tris=torch.zeros((1, 9, 128)))
    o = torch.tensor([[-1.0, 0.5, 0.5], [-1.0, 5.0, 5.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    lo = torch.tensor([0.0, 0.0])
    hi = torch.tensor([10.0, 10.0])
    nb = roofline.ray_bytes(2, lo, hi)
    assert nb == 2 * 40
    # ray 0 crosses block and cluster: 1 block slab test, then the block's
    # one member cluster slab test and 2 triangle tests; ray 1 misses
    # both and pays its block slab test
    n_bytes, ops = roofline.clustered_work(cl, o, d, lo, hi,
                                           torch.tensor([False, False]), nb)
    assert ops == 2 * 27 + 27 + 2 * 55
    assert n_bytes == nb + 4 * (9 * 128 + 128 + 8 + 8)
    # occluded: one triangle test
    n_bytes, ops = roofline.clustered_work(cl, o, d, lo, hi,
                                           torch.tensor([True, False]), nb)
    assert ops == 55 + 27
    assert np.isclose(roofline.bound_ms(3.35e9, 0)[0], 1.0)
