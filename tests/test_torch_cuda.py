"""The CUDA kernels against their plain torch versions, on the card: the
brute-force kernel (csrc/brute_hit.cu; bitwise), the clustered kernel
(csrc/clustered_hit.cu) and the K3 microbenchmark kernels
(csrc/mt_bench.cu; mt_vpu bitwise, mt_linear by the tolerance gate
ops/mt_bench.py linear_gate); env-lit renders through K1 and K2 against
the plain version; and the two sources of utils/timing.py device_ms.

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
