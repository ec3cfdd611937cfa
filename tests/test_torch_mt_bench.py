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

The CUDA kernels are held against these plain versions bitwise on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 6).
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
        assert rec["ms"] > 0 and rec["gflops"] > 0
    assert tool.main(["2", "64", "--device", "cpu"]) == 0
    assert "mxu-late  R=64" in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert tool.main(["2", "64"]) == 2
