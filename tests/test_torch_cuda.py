"""The CUDA kernels against their plain torch versions, on the card: the
brute-force kernel (csrc/brute_hit.cu), the clustered kernel
(csrc/clustered_hit.cu) and the K3 microbenchmark kernels
(csrc/mt_bench.cu); and env-lit renders through K1 and K2 against the
plain version.

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
from bidirectional_pathtracing_tpu_torch.ops import intersect_clustered as icl
from bidirectional_pathtracing_tpu_torch.ops.intersect import PLAIN
from bidirectional_pathtracing_tpu_torch.scene.build import attach_accelerator
from bidirectional_pathtracing_tpu_torch.scene.procedural import (
    make_cornell_box, make_mesh_cornell_box)
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


def _clustered_scene(name, device):
    if name == "meshbox":
        return attach_accelerator(make_mesh_cornell_box(3, device=device))
    return attach_accelerator(_soup(device, n_tris=3000, seed=2))


@pytest.mark.parametrize("scene", ["meshbox", "soup"])
def test_clustered_kernel_matches_plain(cuda, scene):
    """K2 against clustered_hit_plain: valid/slot equal on all but 0.01 % of
    rays (a graze of a zero-thickness cluster box may cull a hit), t rtol
    1e-6 where they agree; any hit against the plain closest hit's
    slot >= 0, dead windows (max_t = -1) included."""
    sc = _clustered_scene(scene, cuda)
    cl = sc.clusters
    rng = np.random.default_rng(3)
    n = 20_001                       # a ragged last block
    o = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                         .astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    hi = rng.uniform(0.1, 3.0, n).astype(np.float32)
    hi[rng.uniform(size=n) < 0.2] = -1.0
    hi = torch.from_numpy(hi).to(cuda)
    lo = torch.full((n,), EPS_F, device=cuda)
    for mx in (torch.full((n,), INF_D, device=cuda), hi):
        before = icl.clustered_hit.launches
        t, slot = icl.clustered_hit(cl, o, d, lo, mx)
        _, any_slot = icl.clustered_hit(cl, o, d, lo, mx, any_hit=True)
        assert icl.clustered_hit.launches == before + 2
        assert slot.dtype == torch.int32 and t.dtype == torch.float32
        rt, rs = icl.clustered_hit_plain(cl, o, d, lo, mx)
        torch.cuda.synchronize()
        bad = (slot != rs)
        assert int(bad.sum()) <= n // 10_000, int(bad.sum())
        ok = ~bad & (rs >= 0)
        assert int(ok.sum()) > n // 10
        torch.testing.assert_close(t[ok], rt[ok], rtol=1e-6, atol=0.0)
        assert bool((t[slot < 0] == INF_D).all())
        assert int(((any_slot >= 0) != (rs >= 0)).sum()) <= n // 10_000
        assert not bool((any_slot[mx < lo] >= 0).any())


def test_clustered_kernel_edge_cases(cuda):
    cl = _clustered_scene("soup", cuda).clusters
    z = torch.zeros((0, 3), device=cuda)
    t, slot = icl.clustered_hit(cl, z, z, 0.0, 1.0)
    assert t.shape == slot.shape == (0,)
    o = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        icl.clustered_hit(cl, o, o, 0.0, 1.0)
    with pytest.raises(ValueError):
        icl.clustered_hit(cl, o.float()[:, :2], o.float()[:, :2], 0.0, 1.0)
    with pytest.raises(ValueError):
        icl.clustered_hit(cl._replace(tris=cl.tris.cpu()), o.float(),
                          o.float(), 0.0, 1.0)


def test_sorted_clustered_launches_match_unsorted(cuda):
    """K2 on rays sorted by the JAX package's keys (ops/intersect.py
    SORTED), un-permuted, equals K2 on the rays as they come, bitwise:
    closest hit on the L4 mesh box with a Morton sort, any hit on segments
    (a fifth with dead windows) with the first-crossed-cluster sort.  The
    sorts really reorder, so a result that depended on a ray's warp
    neighbours would show here."""
    from bidirectional_pathtracing_tpu_torch.ops import intersect as ti
    sc = attach_accelerator(make_mesh_cornell_box(4, device=cuda))
    g, cl = sc.geometry, sc.clusters
    rng = np.random.default_rng(4)
    n = 3 * ti._SORT_MIN_RAYS + 17
    a = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                         .astype(np.float32)).to(cuda)
    d = b - a
    dist = torch.linalg.vector_norm(d, dim=-1)
    d = d / dist[:, None]
    lo = torch.full((n,), EPS_F, device=cuda)
    hi = torch.where(torch.from_numpy(rng.uniform(size=n) < 0.2).to(cuda),
                     -1.0, dist * (1.0 - 2e-4) - EPS_F)
    inf = torch.full((n,), INF_D, device=cuda)

    key = ti._morton_key(cl, a, d)
    assert len(torch.unique(key)) > 100
    perm, (a_s, d_s, lo_s, inf_s) = ti._sorted(key, a, d, lo, inf)
    t_u, s_u = icl.clustered_hit(cl, a, d, lo, inf)
    t_s, s_s = icl.clustered_hit(cl, a_s, d_s, lo_s, inf_s)
    assert torch.equal(ti._unsort(perm, t_s), t_u)
    assert torch.equal(ti._unsort(perm, s_s), s_u)
    assert int((s_u >= 0).sum()) > n // 2
    before = icl.clustered_hit.launches
    got = ti._sorted_clustered_intersect(sc, a, d, lo, inf)
    assert icl.clustered_hit.launches == before + 1
    ref = icl.intersect_clustered(g, cl, a, d, lo, inf)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)

    key = ti._ray_sort_perm_key(cl, a, d, lo, hi)
    assert len(torch.unique(key)) > 20
    perm, (a_s, d_s, lo_s, hi_s) = ti._sorted(key, a, d, lo, hi)
    t_u, s_u = icl.clustered_hit(cl, a, d, lo, hi, any_hit=True)
    t_s, s_s = icl.clustered_hit(cl, a_s, d_s, lo_s, hi_s, any_hit=True)
    assert torch.equal(ti._unsort(perm, t_s), t_u)
    assert torch.equal(ti._unsort(perm, s_s), s_u)
    assert 0 < int((s_u >= 0).sum()) < n
    got = ti._sorted_clustered_occluded(sc, a, d, lo, hi)
    assert torch.equal(got, icl.occluded_clustered(g, cl, a, d, lo, hi))


def test_render_through_clustered_kernel_matches_plain(cuda):
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    box = attach_accelerator(make_mesh_cornell_box(4, device=cuda))
    cfg = RenderConfig(spp=2, max_ray_depth=4, width=64, height=48)
    before = icl.clustered_hit.launches
    a = render(box, cfg)
    assert icl.clustered_hit.launches - before == 2 * (4 + 4 + 1)
    b = render(box, cfg, isect=PLAIN)
    assert icl.clustered_hit.launches - before == 2 * (4 + 4 + 1)
    np.testing.assert_allclose(a.combined.mean(), b.combined.mean(),
                               rtol=1e-3)


@pytest.mark.parametrize("form", ["vpu", "linear"])
def test_mt_bench_kernels_match_plain_bitwise(cuda, form):
    """K3 at 4,096 rays (and a ragged 1,001), both `late` settings:
    -fmad=false and the plain versions' summation order make t and the
    index bitwise equal."""
    from bidirectional_pathtracing_tpu_torch.ops import mt_bench as mb
    fn, plain, k = ((mb.mt_vpu, mb.mt_vpu_plain, 1) if form == "vpu"
                    else (mb.mt_linear, mb.mt_linear_plain, 2))
    for r, iters in ((4096, 16), (1001, 9)):
        arrays = [torch.from_numpy(a).to(cuda) for a in mb.make_inputs(r)]
        rays, table = arrays[0], arrays[k]
        for late in (False, True):
            before = fn.launches
            got = fn(rays, table, iters, late)
            assert fn.launches == before + 1
            ref = plain(rays, table, iters, late)
            torch.cuda.synchronize()
            assert got.shape == (2, r) and got.dtype == torch.float32
            assert torch.equal(got, ref)
            assert int((got[1] >= 0).sum()) > r // 10


def _env_render_pair(scene, counter):
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    cfg = RenderConfig(spp=2, max_ray_depth=4, width=64, height=48)
    before = counter.launches
    a = render(scene, cfg)
    launched = counter.launches - before
    b = render(scene, cfg, isect=PLAIN)
    assert counter.launches - before == launched > 0
    assert np.isfinite(a.combined).all() and a.light.sum() > 0
    np.testing.assert_allclose(a.combined.mean(), b.combined.mean(),
                               rtol=1e-3)


def test_env_render_through_kernel_matches_plain(cuda):
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_open_env_scene)
    _env_render_pair(make_open_env_scene(device=cuda), ib.brute_hit)


def test_env_mesh_render_through_clustered_kernel_matches_plain(cuda):
    from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        synthetic_sky)
    box = attach_accelerator(make_mesh_cornell_box(4, device=cuda))
    box = box._replace(envmap=build_envmap(synthetic_sky(), device=cuda))
    _env_render_pair(box, icl.clustered_hit)
