"""Port K3 (ops/mt_bench.py, tools/mxu_mt_bench.py) against the JAX
package's microbenchmark tools/profiling/mxu_mt_bench.py.

The plain versions of mt_vpu and mt_linear, both `late` settings, against
the Pallas bodies `_vpu_kernel` / `_mxu_kernel` run through pl.pallas_call
in interpret mode with VMEM BlockSpecs, on the same inputs (1,024 rays,
16 visits):

  - the winner's in-cluster index equal on >= 99.9 % of rays, misses
    (t = 3e38, index -1) equal;
  - t within rtol 1e-5 plus atol 1e-6: t's numerator is a difference of
    O(1) products (vertices in [-1, 1], origins in [-2, 2]), and XLA and
    torch round and order those sums differently, so near-zero t carries an
    absolute error of a few 1e-7 (measured at most 2.4e-7 here);
  - amat_from_tris bitwise.

The tensor-core form's pieces that the CPU reaches: mma_table's row
permutation and A-fragment layout (undone exactly), tf32_split, and
mt_linear_tf32_plain, the plain emulation of its three-product numerators,
held by linear_gate against mt_linear_plain and against the JAX
`_mxu_kernel` in interpret mode; the gate rejects corrupted results and a
single TF32 pass.  Why the gate is not a bare rtol 1e-5: evaluations of the
linear form that differ only in rounding (another FP32 order, float64)
already exceed it on some hits (rtol_witness), and the gate passes them.

On the card mt_vpu is held against its plain version bitwise and
mt_linear by linear_gate (tests/test_torch_cuda.py, chip_smoke.py phase 6).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bidirectional_pathtracing_tpu_torch.ops import mt_bench as tm
from bidirectional_pathtracing_tpu_torch.tools import mxu_mt_bench as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, ITERS = 1024, 16


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_mxu_mt_bench",
        os.path.join(REPO, "tools", "profiling", "mxu_mt_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_run(mb, kernel, rays, data, late):
    f = pl.pallas_call(
        functools.partial(kernel, iters=ITERS, r=rays.shape[1], late=late,
                          chunk=mb.TC),
        out_shape=jax.ShapeDtypeStruct((2, rays.shape[1]), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)
    return np.asarray(f(rays, data))


def test_constants_and_amat_match_jax():
    mb = _jax_tool()
    assert (tm.TC, tm.NSLOT, tm.INF) == (mb.TC, mb.NSLOT, mb.INF)
    _, tris, amat = tm.make_inputs(64)
    ref = mb.amat_from_tris(tris)
    assert amat.dtype == ref.dtype and amat.shape == ref.shape
    np.testing.assert_array_equal(amat, ref)


@pytest.mark.parametrize("variant", ["vpu", "vpu-late", "mxu", "mxu-late"])
def test_plain_matches_jax_interpret(variant):
    mb = _jax_tool()
    rays, tris, amat = tm.make_inputs(R)
    late = variant.endswith("late")
    if variant.startswith("vpu"):
        ref = _jax_run(mb, mb._vpu_kernel, rays, tris, late)
        got = tm.mt_vpu(torch.from_numpy(rays), torch.from_numpy(tris),
                        ITERS, late).numpy()
    else:
        ref = _jax_run(mb, mb._mxu_kernel, rays, amat, late)
        got = tm.mt_linear(torch.from_numpy(rays), torch.from_numpy(amat),
                           ITERS, late).numpy()
    assert got.shape == (2, R) and got.dtype == np.float32
    hit = ref[1] >= 0
    assert R // 10 < int(hit.sum()) < R
    assert (got[1] == ref[1]).mean() >= 0.999
    same = (got[1] == ref[1]) & hit
    np.testing.assert_allclose(got[0][same], ref[0][same], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[0][~hit & (got[1] < 0)],
                                  np.float32(tm.INF))


def test_variants_agree_and_wrappers_take_plain_on_cpu():
    """All four forms give the same winner on the CPU, and the wrappers
    count no launch there."""
    rays, tris, amat = (torch.from_numpy(a) for a in tm.make_inputs(300))
    before = (tm.mt_vpu.launches, tm.mt_linear.launches)
    base = tm.mt_vpu(rays, tris, 11)
    for late in (False, True):
        a = tm.mt_vpu(rays, tris[:, :9], 11, late)
        b = tm.mt_linear(rays, amat, 11, late)
        assert torch.equal(a[1], base[1]) and torch.equal(b[1], base[1])
        torch.testing.assert_close(b[0], base[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(tm.mt_vpu(rays, tris, 11, True), base)
    assert (tm.mt_vpu.launches, tm.mt_linear.launches) == before
    assert torch.equal(tm.mt_vpu(rays, tris, 0),
                       torch.stack([torch.full((300,), tm.INF),
                                    torch.full((300,), -1.0)]))


def test_wrappers_reject_wrong_input():
    rays, tris, amat = (torch.from_numpy(a) for a in tm.make_inputs(8))
    with pytest.raises(TypeError):
        tm.mt_vpu(rays.double(), tris, 1)
    with pytest.raises(ValueError):
        tm.mt_vpu(rays[:7], tris, 1)
    with pytest.raises(ValueError):
        tm.mt_vpu(rays, tris[:, :8], 1)
    with pytest.raises(ValueError):
        tm.mt_linear(rays, amat[:, :256], 1)
    with pytest.raises(ValueError):
        tm.mt_linear(rays, amat, -1)


def test_tool_runs_on_cpu_and_needs_a_card_by_default(capsys):
    res = tool.run(iters=3, r=200, device="cpu", log=lambda _: None)
    assert list(res) == ["vpu", "vpu-late", "mxu", "mxu-late"]
    for rec in res.values():
        assert rec["agree_with_vpu"] == 1.0 and rec["hits"] > 0
        assert rec["call_ms"] > 0 and rec["gflops"] > 0
        assert rec["device_ms"] is None and rec["device_source"] is None
    assert tool.main(["2", "64", "--device", "cpu"]) == 0
    assert "mxu-late  R=64" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert tool.main(["2", "64"]) == 2


def test_tf32_split():
    """hi has its low 13 mantissa bits zero (so has lo), hi + lo is x
    within 2^-21 relative, and a tie rounds away from zero (cvt.rna)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32)
    x[:3] = 0.0, 1.0, -2.5
    hi, lo = tm.tf32_split(torch.from_numpy(x))
    for v in (hi, lo):
        assert not bool((v.view(torch.int32) & 0x1FFF).any())
    xd = torch.from_numpy(x).double()
    err = (hi.double() + lo.double() - xd).abs()
    assert bool((err <= 2.0 ** -21 * xd.abs()).all())
    assert hi[:3].tolist() == [0.0, 1.0, -2.5] and not lo[:3].any()
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert tm.tf32_split(tie)[0].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def test_mma_table_layout_is_undone_exactly():
    """mma_table, gathered back out of mma.sync's A-fragment order and
    un-permuted by MMA_ROWS, is tf32_split(amat) bit for bit; MMA_ROWS puts
    numerator 2 m + h of triangle 8 q + g at row 32 q + 16 m + 8 h + g."""
    amat = torch.from_numpy(tm.make_inputs(8)[2])
    tab = tm.mma_table(amat)
    assert tab.shape == (tm.NSLOT, 16, 2, 2, 2, 32, 4)
    assert tab.is_contiguous() and tab.dtype == torch.float32
    perm = tm.MMA_ROWS
    assert sorted(perm.tolist()) == list(range(4 * tm.TC))
    for q, m, h, g in ((0, 0, 0, 0), (0, 0, 1, 0), (0, 1, 0, 0), (0, 1, 1, 7),
                       (1, 0, 0, 1), (15, 1, 1, 7)):
        assert int(perm[32 * q + 16 * m + 8 * h + g]) == \
            (2 * m + h) * tm.TC + 8 * q + g
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(4 * tm.TC)
    want = tm.tf32_split(amat)
    for part in (0, 1):
        tiles = torch.full((tm.NSLOT, 16, 2, 16, tm.N_FEAT), float("nan"))
        for kk in (0, 1):
            for lane in range(32):
                for reg in range(4):
                    row = lane // 4 + 8 * (reg % 2)
                    col = 8 * kk + lane % 4 + 4 * (reg // 2)
                    tiles[:, :, :, row, col] = tab[:, :, :, kk, part, lane,
                                                   reg]
        rows = tiles.reshape(tm.NSLOT, 4 * tm.TC, tm.N_FEAT)
        assert torch.equal(rows[:, inv], want[part])


@pytest.mark.parametrize("late", [False, True])
def test_tf32_emulation_passes_the_gate(late):
    """The three-product numerators summed in FP32 pass linear_gate against
    the plain FP32 version and against the JAX _mxu_kernel (interpret
    mode) at 1,024 rays x 16 visits."""
    mb = _jax_tool()
    rays, _, amat = tm.make_inputs(R)
    tr, ta = torch.from_numpy(rays), torch.from_numpy(amat)
    emu = tm.mt_linear_tf32_plain(tr, ta, ITERS, late)
    jax_ref = torch.from_numpy(np.array(_jax_run(mb, mb._mxu_kernel, rays,
                                                 amat, late)))
    for ref in (tm.mt_linear_plain(tr, ta, ITERS, late), jax_ref):
        rec = tm.linear_gate(emu, ref, tr, ta, ITERS)
        assert rec["ok"], rec
        assert rec["hits"] > R // 10 and rec["same_index"] >= tm.GATE_AGREE


def test_gate_rejects_corrupted_results():
    """A single TF32 pass, t off by 1e-3, a wrong winner, a dropped hit and
    a broken miss sentinel each fail linear_gate."""
    rays, _, amat = (torch.from_numpy(a) for a in tm.make_inputs(R))
    ref = tm.mt_linear_plain(rays, amat, ITERS)
    emu = tm.mt_linear_tf32_plain(rays, amat, ITERS)
    assert tm.linear_gate(emu, ref, rays, amat, ITERS)["ok"]
    one = tm.mt_linear_tf32_plain(rays, amat, ITERS, products=1)
    assert not tm.linear_gate(one, ref, rays, amat, ITERS)["ok"]
    hits = torch.nonzero(emu[1] >= 0).reshape(-1)[:5]
    misses = torch.nonzero(emu[1] < 0).reshape(-1)[:1]
    bad_t, bad_i, dropped, sentinel = (emu.clone() for _ in range(4))
    bad_t[0, hits] *= 1 + 1e-3
    bad_i[1, hits] = (bad_i[1, hits] + 1) % tm.TC
    dropped[0, hits], dropped[1, hits] = tm.INF, -1.0
    sentinel[0, misses] = 1.0
    for bad in (bad_t, bad_i, dropped, sentinel):
        assert not tm.linear_gate(bad, ref, rays, amat, ITERS)["ok"]
    rec = tm.linear_gate(bad_i, ref, rays, amat, ITERS)
    assert rec["differ"] == 5 and rec["unexplained"] == 5


def test_bare_rtol_fails_between_fp32_evaluations():
    """The plain FP32 version against its sums right to left and against
    float64: the same winner on every ray, t beyond rtol 1e-5 on some hits
    (ill-conditioned quotients), and linear_gate passes both."""
    rays, _, amat = (torch.from_numpy(a) for a in tm.make_inputs(R))
    rec = tm.rtol_witness(rays, amat, ITERS)
    assert rec["hits"] > R // 10
    for name in ("fp32_reversed", "float64"):
        assert rec[name]["differ"] == 0 and rec[name]["t_beyond_rtol"] > 0
    ref = tm.mt_linear_plain(rays, amat, ITERS)
    for other in (tm.mt_linear_plain(rays, amat, ITERS, reverse=True),
                  tm.mt_linear_plain(rays.double(), amat.double(),
                                     ITERS).float()):
        assert other.dtype == torch.float32
        assert tm.linear_gate(other, ref, rays, amat, ITERS)["ok"]
