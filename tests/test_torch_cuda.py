"""The CUDA kernels against their plain torch versions, on the card: the
brute-force kernel (csrc/brute_hit.cu; bitwise), the clustered kernel
(csrc/clustered_hit.cu) and the K3 microbenchmark kernels
(csrc/mt_bench.cu; mt_vpu bitwise, mt_linear by the tolerance gate
ops/mt_bench.py linear_gate); env-lit renders through K1 and K2 against
the plain version; the two sources of utils/timing.py device_ms; PT
renders through K1 and K2 against the plain version, with their launch
counts; bitwise-reproducible BDPT renders and light-image splats; and
resume, cell mode, adaptive sampling and autofocus on the card; the CLI
on a .dae file through K1; gradients through K1 against the plain
version, the wrappers' refusal of rays that require grad, the
inverse-rendering example at its defaults, and a two-process render
(parallel/launch.py) on one card.

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
    if name == "meshbox5":     # 40,972 triangles, several blocks
        return attach_accelerator(make_mesh_cornell_box(5, device=device))
    return attach_accelerator(_soup(device, n_tris=3000, seed=2))


def _random_rays(n, device, seed, dead=0.0):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                         .astype(np.float32)).to(device)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    hi = rng.uniform(0.1, 3.0, n).astype(np.float32)
    hi[rng.uniform(size=n) < dead] = -1.0
    return o, d, torch.full((n,), EPS_F, device=device), \
        torch.from_numpy(hi).to(device)


def _hold(cl, o, d, lo, hi):
    """K2 against the plain version: closest-hit slot equal on all but
    0.01 % of rays (a graze of a zero-thickness cluster box may cull a
    hit), t rtol 1e-6 where they agree; any hit equal to the plain closest
    hit's slot >= 0 on as many, with t = -1e30 where it hit and 1e30
    elsewhere.  Returns the plain slots."""
    n = o.shape[0]
    t, slot = icl.clustered_hit(cl, o, d, lo, hi)
    at, aslot = icl.clustered_hit(cl, o, d, lo, hi, any_hit=True)
    assert slot.dtype == torch.int32 and t.dtype == torch.float32
    rt, rs = icl.clustered_hit_plain(cl, o, d, lo, hi)
    torch.cuda.synchronize()
    bad = slot != rs
    assert int(bad.sum()) <= n // 10_000, int(bad.sum())
    torch.testing.assert_close(t[~bad], rt[~bad], rtol=1e-6, atol=0.0)
    assert bool((t[slot < 0] == INF_D).all())
    assert int(((aslot >= 0) != (rs >= 0)).sum()) <= n // 10_000
    assert not bool((aslot[hi < lo] >= 0).any())
    assert torch.equal(at, torch.where(aslot >= 0, -INF_D, INF_D))
    return rs


@pytest.mark.parametrize("scene", ["meshbox", "soup"])
def test_clustered_kernel_matches_plain(cuda, scene):
    """K2 against clustered_hit_plain (_hold), open windows and segments
    with dead windows (max_t = -1), 20,001 rays (a ragged last block)."""
    cl = _clustered_scene(scene, cuda).clusters
    n = 20_001
    o, d, lo, hi = _random_rays(n, cuda, seed=3, dead=0.2)
    for mx in (torch.full((n,), INF_D, device=cuda), hi):
        before = icl.clustered_hit.launches
        rs = _hold(cl, o, d, lo, mx)
        assert icl.clustered_hit.launches == before + 2
        assert int((rs >= 0).sum()) > n // 10


TIE_COPIES = {   # (cluster, lane) of each copy of the one hit triangle
    "cluster": [(0, 7), (0, 3)],       # twice in one cluster
    "block": [(2, 0), (1, 9)],         # in two clusters of one block
    "blocks": [(129, 0), (5, 50)],     # in two blocks
}


def tie_tables(case):
    """Flat cluster tables (numpy block_b, cluster_b, tris [C, 9, 128],
    pad2global) over 130 clusters (two blocks) in which one triangle, the
    only one the rays can hit, is stored at each (cluster, lane) of
    TIE_COPIES[case]; every other filled slot holds a small triangle far to
    the side.  Every copy gives the same t, so the lowest padded slot must
    win.  Returns (tables, (o, d, min_t, max_t) numpy, expected slot [R]):
    the rays point at the triangle from z = -1, the last two away from it
    (expected -1)."""
    from bidirectional_pathtracing_tpu_torch.scene.clusters import (
        BLOCK_SIZE, CLUSTER_SIZE)
    n_c = 130
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    copies = TIE_COPIES[case]
    tris = np.zeros((n_c, 9, CLUSTER_SIZE), np.float32)
    p2g = np.full(n_c * CLUSTER_SIZE, -1, np.int32)
    cb = np.zeros((8, 2 * BLOCK_SIZE), np.float32)
    cb[0:3], cb[3:6] = np.inf, -np.inf
    for c in range(n_c):
        n = max([lane + 1 for cc, lane in copies if cc == c], default=1)
        for lane in range(n):
            if (c, lane) in copies:
                p = tri
            else:
                base = np.array([3 + 1e-3 * lane, 3 + 1e-3 * c, 0.5],
                                np.float32)
                p = base + np.array([[0, 0, 0], [0.01, 0, 0], [0, 0.01, 0]],
                                    np.float32)
            tris[c, :, lane] = p.reshape(9)
            p2g[c * CLUSTER_SIZE + lane] = c * CLUSTER_SIZE + lane
        v = tris[c, :, :n].reshape(3, 3, n)
        cb[0:3, c] = v.min(axis=(0, 2))
        cb[3:6, c] = v.max(axis=(0, 2))
    bb = np.zeros((8, 8), np.float32)
    bb[:, 0:3], bb[:, 3:6] = np.inf, -np.inf
    for b in range(2):
        s = slice(b * BLOCK_SIZE, min((b + 1) * BLOCK_SIZE, n_c))
        bb[b, 0:3] = cb[0:3, s].min(axis=1)
        bb[b, 3:6] = cb[3:6, s].max(axis=1)
    n_rays = 64
    rng = np.random.default_rng(0)
    o = np.concatenate([rng.uniform(-0.2, 0.2, (n_rays, 2)),
                        np.full((n_rays, 1), -1.0)], axis=1)
    d = np.concatenate([rng.uniform(-0.05, 0.05, (n_rays, 2)),
                        np.ones((n_rays, 1))], axis=1)
    d[-2:, 2] = -1.0                              # away from the triangle
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.full(n_rays, min(c * CLUSTER_SIZE + lane for c, lane in copies),
                   np.int32)
    want[-2:] = -1
    rays = (o.astype(np.float32), d.astype(np.float32),
            np.full(n_rays, EPS_F, np.float32),
            np.full(n_rays, INF_D, np.float32))
    return (bb, cb, tris, p2g), rays, want


def _tables_on(tables, device):
    from bidirectional_pathtracing_tpu_torch.scene.clusters import (
        ClusteredTris)
    return ClusteredTris(*(torch.from_numpy(x).to(device) for x in tables))


@pytest.mark.parametrize("case", sorted(TIE_COPIES))
def test_clustered_kernel_tie_rule(cuda, case):
    """K2 on tables that store the hit triangle twice: the lowest padded
    slot wins, as in the plain version, closest hit and any hit."""
    tables, rays, want = tie_tables(case)
    cl = _tables_on(tables, cuda)
    o, d, lo, hi = (torch.from_numpy(x).to(cuda) for x in rays)
    t, slot = icl.clustered_hit(cl, o, d, lo, hi)
    rt, rs = icl.clustered_hit_plain(cl, o, d, lo, hi)
    _, any_slot = icl.clustered_hit(cl, o, d, lo, hi, any_hit=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(slot.cpu().numpy(), want)
    assert torch.equal(slot, rs) and torch.equal(t, rt)
    assert torch.equal(any_slot >= 0, rs >= 0)


@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 20_001])
def test_clustered_kernel_ragged_warps(cuda, n):
    """K2 at ray counts that end inside a warp or a CUDA block: lanes past
    the end take part in the warp's votes and write nothing."""
    cl = _clustered_scene("meshbox", cuda).clusters
    o, d, lo, hi = _random_rays(n, cuda, seed=n, dead=0.1)
    for mx in (torch.full((n,), INF_D, device=cuda), hi):
        _hold(cl, o, d, lo, mx)


def test_clustered_kernel_dead_lanes(cuda):
    """A warp whose rays are all dead (max_t < min_t), a warp with one
    live lane, a warp of live rays: every ray as in the plain version, the
    dead ones missing."""
    cl = _clustered_scene("meshbox5", cuda).clusters
    o, d, lo, _ = _random_rays(96, cuda, seed=7)
    hi = torch.full((96,), INF_D, device=cuda)
    hi[:64] = -1.0
    hi[40] = INF_D
    rs = _hold(cl, o, d, lo, hi)
    assert bool((rs[hi < lo] < 0).all())
    assert int(rs[40]) >= 0 and int((rs[64:] >= 0).sum()) > 16


def test_clustered_kernel_any_hit_mixed(cuda):
    """Any hit over warps in which segments occluded early alternate with
    unoccluded ones that need the whole traversal: a ray that stops must
    not stop its neighbours, and one that goes on must not lose its
    result."""
    cl = _clustered_scene("meshbox5", cuda).clusters
    n = 40_000
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.uniform([-1, 0, -1], [1, 1.5, 1], (n, 3))
                         .astype(np.float32)).to(cuda)
    dist = torch.linalg.vector_norm(b - a, dim=-1)
    d = (b - a) / dist[:, None]
    lo = torch.full((n,), EPS_F, device=cuda)
    hi = dist * (1.0 - 2e-4) - EPS_F
    _, rs = icl.clustered_hit_plain(cl, a, d, lo, hi)
    occ = torch.nonzero(rs >= 0).reshape(-1)
    free = torch.nonzero(rs < 0).reshape(-1)
    m = min(len(occ), len(free)) // 32 * 32
    assert m >= 1024
    order = torch.stack([occ[:m], free[:m]], dim=1).reshape(-1)
    rs = _hold(cl, a[order], d[order], lo[order], hi[order])
    assert bool((rs[0::2] >= 0).all()) and not bool((rs[1::2] >= 0).any())


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
    """K3 at 4,096 rays (and a ragged 1,001), both `late` settings against
    the plain versions: mt_vpu bitwise (-fmad=false and the plain version's
    summation order), mt_linear, which sums on the tensor cores, by the
    shared tolerance gate ops/mt_bench.py linear_gate."""
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
            if form == "vpu":
                assert torch.equal(got, ref)
            else:
                rec = mb.linear_gate(got, ref, rays, table, iters)
                assert rec["ok"], rec
            assert int((got[1] >= 0).sum()) > r // 10


@pytest.mark.parametrize("n", [1, 31, 33, 129, 1001, 20_001])
def test_mt_vpu_ragged_rays_bitwise(cuda, n):
    """mt_vpu at ray counts that end inside a thread's ray set, a warp or
    a block, both `late` settings: bitwise equal to the plain version."""
    from bidirectional_pathtracing_tpu_torch.ops import mt_bench as mb
    rays, tris, _ = (torch.from_numpy(a).to(cuda) for a in mb.make_inputs(n))
    for late in (False, True):
        assert torch.equal(mb.mt_vpu(rays, tris, 9, late),
                           mb.mt_vpu_plain(rays, tris, 9, late))


@pytest.mark.parametrize("iters", [0, 1, 9])
def test_mt_linear_gate_ragged(cuda, iters):
    """mt_linear by linear_gate at ray counts that are not a multiple of a
    warp's ray tile (16) or a block's (256), 0, 1 and 9 visits, both
    `late` settings; no visit leaves every ray a miss."""
    from bidirectional_pathtracing_tpu_torch.ops import mt_bench as mb
    for n in (5, 4099):
        rays, _, amat = (torch.from_numpy(a).to(cuda)
                         for a in mb.make_inputs(n, seed=n))
        for late in (False, True):
            got = mb.mt_linear(rays, amat, iters, late)
            ref = mb.mt_linear_plain(rays, amat, iters, late)
            rec = mb.linear_gate(got, ref, rays, amat, iters)
            assert rec["ok"], rec
            if iters == 0:
                assert bool((got[0] == mb.INF).all() and (got[1] == -1).all())


def _brute_bitwise(g, o, d, lo, hi):
    t, prim = ib.brute_hit(g, o, d, lo, hi)
    rt, rp = ib.brute_hit_plain(g, o, d, lo, hi)
    torch.cuda.synchronize()
    assert torch.equal(t, rt) and torch.equal(prim, rp)
    return rp


@pytest.mark.parametrize("n", [1, 31, 33, 129, 20_001])
def test_kernel_ragged_rays_bitwise(cuda, n):
    """K1 on the Cornell box (a parameter table) at ray counts that end
    inside a thread's ray set, a warp or a block: t and prim bitwise equal
    to the plain version, open windows and segments."""
    g = make_cornell_box(sphere_materials=("mirror", "glass"),
                         device=cuda).geometry
    o, d, lo, hi = _random_rays(n, cuda, seed=n)
    for mx in (torch.full((n,), INF_D, device=cuda), hi):
        _brute_bitwise(g, o, d, lo, mx)


@pytest.mark.parametrize("size", ["cap", "cap+1", "8192"])
def test_kernel_table_sizes_bitwise(cuda, size):
    """K1 with a soup at the parameter table's cap (by value), one
    triangle above it and at 8,192 triangles (both through shared memory):
    bitwise equal to the plain version."""
    cap = ib.param_caps()[0]
    n_tris = {"cap": cap, "cap+1": cap + 1, "8192": 8192}[size]
    g = _soup(cuda, n_tris=n_tris, seed=5).geometry
    o, d, lo, hi = _random_rays(20_001, cuda, seed=6)
    for mx in (torch.full((20_001,), INF_D, device=cuda), hi):
        rp = _brute_bitwise(g, o, d, lo, mx)
        assert int((rp >= 0).sum()) > 2_000


def test_kernel_tie_rules(cuda):
    """Exact ties on K1's two paths: the same triangle stored twice (the
    lower index wins), a triangle at exactly a sphere's t (the triangle
    wins), the same sphere twice (the lower sphere wins)."""
    tri = np.array([[-1, -1, -1], [1, -1, -1], [0, 1, -1]], np.float32)
    far = tri + np.float32(5.0)
    n = 64
    rng = np.random.default_rng(9)
    o = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)),
                        np.full((n, 1), -5.0)], 1).astype(np.float32)
    o[0, :2] = 0.0             # this ray meets triangle and sphere at t = 4
    d = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    args = [torch.from_numpy(x).to(cuda) for x in (o, d)]
    for tris, want in (([far, tri, tri], 1), ([tri, far], 0)):
        p = np.stack(tris)
        g = make_geometry(p, np.zeros_like(p) + [0, 0, -1],
                          np.zeros(len(p), np.int32),
                          np.zeros((2, 3), np.float32),
                          np.ones(2, np.float32), np.zeros(2, np.int32),
                          device=cuda)
        rp = _brute_bitwise(g, *args, EPS_F, INF_D)
        assert int(rp[0]) == want and bool((rp == want).all())
    g = make_geometry(far[None], np.zeros((1, 3, 3), np.float32) + [0, 0, -1],
                      np.zeros(1, np.int32), np.zeros((2, 3), np.float32),
                      np.ones(2, np.float32), np.zeros(2, np.int32),
                      device=cuda)
    rp = _brute_bitwise(g, *args, EPS_F, INF_D)
    assert bool((rp == 1).all())           # sphere 0, prim_base 1


def test_device_time_sources_agree(cuda):
    """utils/timing.py: the profiler's kernel time and a CUDA graph's agree
    on a kernel of about a millisecond."""
    from bidirectional_pathtracing_tpu_torch.ops import mt_bench as mb
    from bidirectional_pathtracing_tpu_torch.utils.timing import (
        device_ms, graph_ms, profiler_ms)
    rays, tris, _ = (torch.from_numpy(a).to(cuda)
                     for a in mb.make_inputs(65536))

    def call():
        return mb.mt_vpu(rays, tris, 32)
    prof = profiler_ms(call, "mt_vpu", 5)
    graph = graph_ms(call, 5)
    assert prof is not None and 0.2 < prof < 10
    assert abs(graph - prof) <= 0.2 * prof
    ms, src = device_ms(call, "mt_vpu", 5)
    assert src == "profiler" and abs(ms - prof) <= 0.2 * prof


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


# --- the unidirectional PT and the render driver on the card ---------------

def _sky_mesh(device, level=4):
    from bidirectional_pathtracing_tpu_torch.ops.envlight import build_envmap
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        synthetic_sky)
    box = attach_accelerator(make_mesh_cornell_box(level, device=device))
    return box._replace(envmap=build_envmap(synthetic_sky(), device=device))


def _pt_scene(name, device):
    from bidirectional_pathtracing_tpu_torch.scene.procedural import (
        make_open_env_scene)
    if name == "cornell":
        return make_cornell_box(sphere_materials=("mirror", "glass"),
                                device=device), ib.brute_hit
    if name == "open_env":
        return make_open_env_scene(device=device), ib.brute_hit
    return _sky_mesh(device), icl.clustered_hit


@pytest.mark.parametrize("name", ["cornell", "open_env", "meshbox_sky"])
def test_pt_render_through_kernel_matches_plain(cuda, name):
    """The PT through K1 (Cornell box, open env scene) or K2 (L4 mesh box
    with the sky) against the plain version: one closest hit per depth
    step and one any hit per light and env sample at each of the d NEE
    vertices, every one through the kernel."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    scene, counter = _pt_scene(name, cuda)
    cfg = RenderConfig(integrator="pt", spp=2, max_ray_depth=4, width=64,
                       height=48, pt_mis=scene.envmap is not None)
    shadow = scene.lights.kind.shape[0] + (scene.envmap is not None)
    before = counter.launches
    a = render(scene, cfg)
    assert counter.launches - before == 2 * 4 * (1 + shadow)
    b = render(scene, cfg, isect=PLAIN)
    assert counter.launches - before == 2 * 4 * (1 + shadow)
    assert a.eye is None and np.isfinite(a.combined).all()
    assert a.combined.mean() > 0
    np.testing.assert_allclose(a.combined.mean(), b.combined.mean(),
                               rtol=1e-3)


@pytest.mark.parametrize("name", ["cornell", "meshbox_sky"])
def test_bdpt_render_is_bitwise_reproducible(cuda, name):
    """Two BDPT renders of one seed are bitwise equal, the light image's
    splats included (models/bdpt.py _splat)."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    scene = _sky_mesh(cuda) if name == "meshbox_sky" else make_cornell_box(
        sphere_materials=("mirror", "glass"), device=cuda)
    cfg = RenderConfig(spp=2, max_ray_depth=4, width=160, height=120)
    a, b = render(scene, cfg), render(scene, cfg)
    assert a.light.sum() > 0
    np.testing.assert_array_equal(a.eye, b.eye)
    np.testing.assert_array_equal(a.light, b.light)


def test_splat_sums_in_lane_order(cuda):
    """_splat on the card: the same bits on every call, and those of the
    sequential CPU scatter (each pixel's splats summed in lane order),
    with heavy collisions (a quarter of the splats on one pixel), values
    over six decades, where another order changes the sum, and half the
    splats zero and piled on another pixel, as masked splats are."""
    from bidirectional_pathtracing_tpu_torch.models.bdpt import _splat
    rng = np.random.default_rng(5)
    n, p = 200_003, 1000
    flat = rng.integers(0, p, n)
    flat[rng.uniform(size=n) < 0.25] = 7
    vals = (rng.uniform(size=(n, 3))
            * 10.0 ** rng.uniform(-3, 3, (n, 1))).astype(np.float32)
    masked = rng.uniform(size=n) < 0.5     # zero splats piled on one pixel
    vals[masked] = 0.0
    flat[masked] = 3
    f, v = torch.from_numpy(flat), torch.from_numpy(vals)
    ref = _splat(torch.zeros((p, 3)), f, v)
    fc, vc = f.to(cuda), v.to(cuda)
    one = _splat(torch.zeros((p, 3), device=cuda), fc, vc)
    two = _splat(torch.zeros((p, 3), device=cuda), fc, vc)
    assert torch.equal(one, two)
    assert torch.equal(one.cpu(), ref)
    reordered = torch.zeros((p, 3)).index_add_(0, f.flip(0), v.flip(0))
    assert not torch.equal(reordered, ref)      # the order is visible


def test_checkpoint_resume_is_bitwise_on_card(cuda, tmp_path):
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    box = make_cornell_box(device=cuda)
    cfg = RenderConfig(spp=4, max_ray_depth=3, width=64, height=48)
    full = render(box, cfg)
    path = str(tmp_path / "state.npz")
    render(box, cfg, checkpoint_path=path, checkpoint_every=1)
    resumed = render(box, cfg, checkpoint_path=path)
    np.testing.assert_array_equal(resumed.eye, full.eye)
    np.testing.assert_array_equal(resumed.light, full.light)


def test_cell_adaptive_and_autofocus_on_card(cuda):
    """Cell mode renders only the rect; adaptive sampling stops some
    pixels early; autofocus through K1 gives the plain version's
    distance."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import (
        autofocus, render)
    box = make_cornell_box(device=cuda)
    for integrator in ("pt", "bdpt"):
        res = render(box, RenderConfig(integrator=integrator, spp=2,
                                       max_ray_depth=3, width=64, height=48,
                                       cell=(8, 6, 24, 18)))
        img = res.eye if integrator == "bdpt" else res.combined
        mask = np.zeros((48, 64), bool)
        mask[6:24, 8:32] = True
        assert img[mask].mean() > 0.01 and img[~mask].max() == 0.0
        assert (res.sample_counts[mask] == 2).all()
    res = render(box, RenderConfig(integrator="pt", spp=24, max_ray_depth=2,
                                   width=64, height=48,
                                   adaptive_sampling=True,
                                   samples_per_batch=4, max_tolerance=0.3))
    c = res.sample_counts
    assert c.min() >= 4 and c.max() <= 24 and c.min() < c.max()
    before = ib.brute_hit.launches
    fd = autofocus(box, 32.0, 24.0, 64, 48)
    assert ib.brute_hit.launches == before + 1
    ref = autofocus(make_cornell_box(device="cpu"), 32.0, 24.0, 64, 48)
    assert 0.1 < fd < 100.0 and abs(fd - ref) <= 1e-6 * ref


def test_cli_renders_dae_on_card(cuda, tmp_path):
    """The CLI with its default device on tests/golden/torch_port/
    cbox_spheres.dae: every hit goes through K1 (12 triangles, 2 spheres),
    the files are written, and the image is within 1 LSB mean of the same
    command's CPU render (the plain versions)."""
    import json
    import os
    from bidirectional_pathtracing_tpu_torch import cli
    from bidirectional_pathtracing_tpu_torch.utils.png import read_png
    scene = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "golden", "torch_port", "cbox_spheres.dae")
    argv = [scene, "-r", "48", "36", "-m", "5", "-s", "8"]
    ib.brute_hit.launches = icl.clustered_hit.launches = 0
    cli.main(argv + ["-f", str(tmp_path / "card.png"), "--stats-json",
                     str(tmp_path / "card.json")])
    assert ib.brute_hit.launches > 0 and icl.clustered_hit.launches == 0
    cli.main(argv + ["-f", str(tmp_path / "cpu.png"), "--device", "cpu"])
    assert {"card.png", "card_rate.png", "cpu.png"} <= set(
        os.listdir(tmp_path))
    st = json.loads((tmp_path / "card.json").read_text())
    assert st["device"] == "cuda:0" and st["camera_samples"] == 48 * 36 * 8
    a = read_png(str(tmp_path / "card.png")).astype(int)
    b = read_png(str(tmp_path / "cpu.png")).astype(int)
    assert a.shape == (36, 48, 4) and a[..., :3].mean() > 10
    assert np.abs(a - b).mean() <= 1.0, np.abs(a - b).mean()


@pytest.mark.parametrize("integrator,names", [
    ("bdpt", ("albedo", "radiance")), ("pt", ("albedo", "emission"))])
def test_gradients_through_kernel_match_plain(cuda, integrator, names):
    """One backward through K1 against the same backward through the plain
    version (utils/gradcheck.py): within 1e-4 of max|g|.  Not bitwise:
    the backward of a gather adds with atomics on the card."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.core import rng
    from bidirectional_pathtracing_tpu_torch.utils import gradcheck as gc
    box = make_cornell_box(64, 48, device=cuda)
    cfg = RenderConfig(spp=1, max_ray_depth=3, width=64, height=48,
                       integrator=integrator)
    before = ib.brute_hit.launches
    loss_k, g_k, _ = gc.gradients(box, cfg, rng.key(0), names)
    assert ib.brute_hit.launches > before
    loss_p, g_p, _ = gc.gradients(box, cfg, rng.key(0), names, isect=PLAIN)
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    for n in names:
        scale = float(g_p[n].abs().max())
        assert scale > 0 and torch.isfinite(g_k[n]).all()
        assert float((g_k[n] - g_p[n]).abs().max()) <= 1e-4 * scale, n


def test_kernel_wrappers_refuse_rays_that_require_grad(cuda):
    """K1 and K2 have no backward: their wrappers raise on card rays or
    windows that require grad instead of returning a detached t."""
    box = make_cornell_box(device=cuda)
    mesh = attach_accelerator(make_mesh_cornell_box(2, device=cuda))
    o = torch.tensor([[0.0, 0.8, 3.0]], device=cuda).repeat(64, 1)
    d = torch.tensor([[0.0, -0.1, -1.0]], device=cuda).repeat(64, 1)
    lo = torch.full((64,), EPS_F, device=cuda)
    hi = torch.full((64,), INF_D, device=cuda)
    for name in ("o", "d", "min_t", "max_t"):
        args = dict(o=o, d=d, min_t=lo, max_t=hi)
        args[name] = args[name].clone().requires_grad_(True)
        before = (ib.brute_hit.launches, icl.clustered_hit.launches)
        with pytest.raises(RuntimeError, match="requires grad"):
            ib.brute_hit(box.geometry, **args)
        with pytest.raises(RuntimeError, match="requires grad"):
            icl.clustered_hit(mesh.clusters, **args)
        assert (ib.brute_hit.launches, icl.clustered_hit.launches) == before
    t, prim = ib.brute_hit(box.geometry, o, d, lo, hi)
    assert not t.requires_grad and bool((prim >= 0).all())


def test_inverse_rendering_box_example_on_card(cuda):
    """The example's defaults (BDPT, 60 steps at 48x36) on the card, every
    hit through K1: the diffuse albedo error halves (its own assert)."""
    from bidirectional_pathtracing_tpu_torch.examples import (
        inverse_rendering)
    before = ib.brute_hit.launches
    hist = inverse_rendering.main([])
    assert ib.brute_hit.launches > before
    assert hist["albedo_err"][-1] < 0.5 * hist["albedo_err"][0]


def test_two_rank_gloo_render_on_one_card(cuda, tmp_path):
    """parallel/launch.py main as 2 processes on cuda:0 (gloo on the host
    copies), dp2 x sp1 on cbox_spheres.dae: process 0's PNG is byte for
    byte the one-process render_frame_sharded frame's, rendered here."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.parallel.render import (
        render_frame_sharded)
    from bidirectional_pathtracing_tpu_torch.scene.build import load_scene
    from bidirectional_pathtracing_tpu_torch.utils.image import save_image
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dae = os.path.join(repo, "tests", "golden", "torch_port",
                       "cbox_spheres.dae")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    png, stats = str(tmp_path / "mp.png"), str(tmp_path / "mp.json")
    argv = [sys.executable, "-m",
            "bidirectional_pathtracing_tpu_torch.parallel.launch", dae,
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "-r", "160", "120", "-s", "4", "-m", "5", "-f", png,
            "--stats-json", stats]
    env = dict(os.environ, PYTHONPATH=repo)
    procs = [subprocess.Popen(argv + ["--process-id", str(i)], cwd=repo,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    st = json.loads(open(stats).read())
    assert st["rank_devices"] == ["cuda:0", "cuda:0"] and st["devices"] == 1
    scene, _ = load_scene(dae, 160, 120, device=cuda)
    cfg = RenderConfig(spp=4, max_ray_depth=5, width=160, height=120)
    one = str(tmp_path / "one.png")
    save_image(one, render_frame_sharded(scene, cfg, dp=2, sp=1)[2])
    with open(png, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()


# --- the BVH walk kernel, the viewer and the visualizer ---------------------

def _walk_rays(sc, n, seed):
    """Random rays from inside the box (half of them from camera-ray hits)
    and random windows, on the scene's device."""
    from bidirectional_pathtracing_tpu_torch.tools.rays import (
        ray_populations)
    (_, o_c, d_c, _, _), (_, o_b, d_b, _, _), _ = ray_populations(sc, n, seed)
    o = torch.cat([o_c[: n // 2], o_b[n // 2:]])
    d = torch.cat([d_c[: n // 2], d_b[n // 2:]])
    rng = np.random.default_rng(seed)
    hi = torch.from_numpy(rng.uniform(0.05, 3.0, n).astype(np.float32)).to(
        o.device)
    return o.contiguous(), d.contiguous(), hi


@pytest.mark.parametrize("scene,leaf", [("cornell", 4), ("meshbox_L4", 4),
                                        ("meshbox_L4", 8)])
def test_bvh_walk_matches_plain_bitwise(cuda, scene, leaf):
    from bidirectional_pathtracing_tpu_torch.ops import intersect as ti
    from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as ibv
    from bidirectional_pathtracing_tpu_torch.scene.bvh import build_bvh
    sc = (make_cornell_box(sphere_materials=("mirror", "glass"), device=cuda)
          if scene == "cornell" else make_mesh_cornell_box(4, device=cuda))
    g = sc.geometry
    bvh = build_bvh(g, max_leaf_size=leaf)
    o, d, hi = _walk_rays(sc, 20_001, 3)
    for lo, mx in ((EPS_F, INF_D), (EPS_F, hi)):
        before = ibv.bvh_walk.launches
        got = ibv.bvh_walk(g, bvh, o, d, lo, mx)
        occ = ibv.bvh_walk(g, bvh, o, d, lo, mx, any_hit=True)
        assert ibv.bvh_walk.launches == before + 2
        ref = ti.intersect_bvh(g, bvh, o, d, lo, mx)
        ref_occ = ti.intersect_bvh(g, bvh, o, d, lo, mx, any_hit=True)
        torch.cuda.synchronize()
        assert int(ref.valid.sum()) > 1000
        for f in ("t", "valid", "mat", "prim"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        torch.testing.assert_close(got.n, ref.n, rtol=0, atol=1e-6)
        assert torch.equal(occ, ref_occ)
        # against brute force (K1 reads the same triangles)
        t_b, p_b = ib.brute_hit(g, o, d, lo, mx)
        assert int((p_b != got.prim).sum()) <= 2


def test_bvh_walk_wrapper_checks(cuda):
    from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as ibv
    from bidirectional_pathtracing_tpu_torch.scene.bvh import build_bvh
    sc = make_cornell_box(device=cuda)
    g = sc.geometry
    bvh = build_bvh(g)
    o, d, _ = _walk_rays(sc, 129, 4)
    with pytest.raises(RuntimeError, match="requires grad"):
        ibv.bvh_walk(g, bvh, o.requires_grad_(), d, EPS_F, INF_D)
    with pytest.raises(TypeError):
        ibv.bvh_walk(g, bvh, o.detach().double(), d.double(), EPS_F, INF_D)
    with pytest.raises(ValueError, match="is on"):
        ibv.bvh_walk(g, build_bvh(g, device="cpu"), o.detach(), d, EPS_F,
                     INF_D)


def test_bvh_route_render_matches_plain(cuda, monkeypatch):
    """The clusterless route through the walk kernel (the brute-force cap
    lowered to the Cornell box's size): 11 launches a d5 BDPT pass, and the
    frame against the same render through the plain version."""
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.ops import intersect as ti
    from bidirectional_pathtracing_tpu_torch.ops import intersect_bvh as ibv
    from bidirectional_pathtracing_tpu_torch.scene.bvh import build_bvh
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    monkeypatch.setattr(ti, "_BRUTE_MAX_TRIS", 8)
    sc = make_cornell_box(sphere_materials=("mirror", "glass"), device=cuda)
    sc = sc._replace(bvh=build_bvh(sc.geometry))
    assert ti.kernel_route(sc) == "bvh"
    cfg = RenderConfig(spp=2, max_ray_depth=5, width=48, height=36)
    before = ibv.bvh_walk.launches
    got = render(sc, cfg)
    assert ibv.bvh_walk.launches - before == 2 * 11
    ref = render(sc, cfg, isect=PLAIN)
    rel = abs(got.combined.mean() - ref.combined.mean()) / ref.combined.mean()
    assert rel <= 1e-3


def test_viewer_tick_on_card(cuda, tmp_path):
    from bidirectional_pathtracing_tpu_torch.config import RenderConfig
    from bidirectional_pathtracing_tpu_torch.utils.render import render
    from bidirectional_pathtracing_tpu_torch.viewer import Viewer
    cfg = RenderConfig(spp=2, max_ray_depth=3, width=48, height=36)
    sc = make_cornell_box(sphere_materials=("mirror", "glass"), device=cuda)
    v = Viewer(sc, cfg, output=str(tmp_path / "v.png"))
    before = ib.brute_hit.launches
    assert v.tick() and v.tick() and not v.tick()
    assert ib.brute_hit.launches - before == 2 * (3 + 3 + 1)
    ref = render(sc, cfg)
    np.testing.assert_allclose(v.frame(), ref.combined, rtol=1e-5, atol=1e-6)
    assert v.frame_png()[:8] == b"\x89PNG\r\n\x1a\n"


def test_visualizer_image_on_card(cuda):
    from bidirectional_pathtracing_tpu_torch.utils import bvh_vis
    vis_k = bvh_vis.BVHVisualizer(make_cornell_box(device=cuda))
    vis_p = bvh_vis.BVHVisualizer(make_cornell_box(device="cpu"))
    for v in (vis_k, vis_p):
        v.navigate("lr")
    before = ib.brute_hit.launches
    a = vis_k.render(64, 48)
    assert ib.brute_hit.launches == before + 1
    b = vis_p.render(64, 48)
    assert (np.abs(a - b) <= 1.0 / 255).all(-1).mean() >= 0.999
