"""Port ops/envlight.py against the JAX package's ops/envlight.py on shared
numpy inputs: the synthetic sky of scene/procedural.py and a random map of
odd size.

  - build_envmap: every table bitwise (both build in float64 on the host);
  - the CDF searches bitwise against jnp.searchsorted(side="right"), on
    random queries, on queries equal to table entries, and at 0 and 1;
  - sample_dir, pdf_dir, sample_L, sample_Le: rtol 1e-5, atol 1e-6 per lane.
    arccos and atan2 may differ by an ulp between XLA and torch; where that
    moves a direction across a pixel edge, round() or a truncation picks
    another texel and the lane differs by the map's contrast.  Such lanes
    are rare (none in these draws for sample_L, whose pixel indices come
    from the searches, not from a direction); the direction lookups are
    held on >= 99.9 % of lanes and every lane is held to the map's value
    range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.ops import envlight as jenv
from bidirectional_pathtracing_tpu_torch.ops import envlight as tenv
from bidirectional_pathtracing_tpu_torch.scene.procedural import synthetic_sky

N = 20_000


def _maps():
    rng = np.random.default_rng(7)
    odd = rng.uniform(0.0, 2.0, (17, 40, 3)).astype(np.float32)
    odd[3] = 0.0                                  # an all-black row
    odd[8, 5:9] = 50.0                            # a bright patch
    return {"sky": synthetic_sky(), "odd": odd}


def _both(name):
    img = _maps()[name]
    return jenv.build_envmap(img), tenv.build_envmap(img, device="cpu")


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0]]   # poles, seam
    return d


def _close_lanes(got, ref, rtol=1e-5, atol=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    ok = np.isclose(got, ref, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(-1)


@pytest.mark.parametrize("name", ["sky", "odd"])
def test_build_envmap_tables_bitwise(name):
    j, t = _both(name)
    for f in j._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", ["sky", "odd"])
def test_cdf_searches_match_jnp_searchsorted(name):
    j, t = _both(name)
    h, w = t.conditional_cdf.shape
    rng = np.random.default_rng(3)
    cond = t.conditional_cdf.numpy()
    rows = rng.integers(0, h, N)
    q = rng.uniform(size=N).astype(np.float32)
    q[:500] = cond[rows[:500], rng.integers(0, w, 500)]    # exact entries
    q[500:510] = 0.0
    q[510:520] = 1.0
    ref_y = np.asarray(jnp.searchsorted(j.marginal_cdf, q, side="right"))
    got_y = tenv.searchsorted_right(t.marginal_cdf[None],
                                    torch.zeros(N, dtype=torch.int64),
                                    torch.from_numpy(q))
    np.testing.assert_array_equal(got_y.numpy(), ref_y)
    ref_x = np.array([np.searchsorted(cond[r], v, side="right")
                      for r, v in zip(rows, q)])
    got_x = tenv.searchsorted_right(t.conditional_cdf,
                                    torch.from_numpy(rows),
                                    torch.from_numpy(q))
    np.testing.assert_array_equal(got_x.numpy(), ref_x)


@pytest.mark.parametrize("name", ["sky", "odd"])
def test_direction_lookups_match_jax(name):
    j, t = _both(name)
    d = _dirs(N, 1)
    lo, hi = float(t.data.min()), float(t.data.max())
    ref = jenv.sample_dir(j, jnp.asarray(d))
    got = tenv.sample_dir(t, torch.from_numpy(d))
    assert got.shape == (N, 3)
    assert _close_lanes(got, ref).mean() >= 0.999
    assert bool(((got >= lo - 1e-4) & (got <= hi + 1e-4)).all())
    ref = jenv.pdf_dir(j, jnp.asarray(d))
    got = tenv.pdf_dir(t, torch.from_numpy(d))
    assert _close_lanes(got, ref).mean() >= 0.999
    assert bool(torch.isfinite(got).all() & (got >= 0).all())


@pytest.mark.parametrize("name", ["sky", "odd"])
def test_sample_L_and_sample_Le_match_jax(name):
    j, t = _both(name)
    rng = np.random.default_rng(5)
    u4 = rng.uniform(size=(N, 4)).astype(np.float32)
    u2 = rng.uniform(size=(N, 2)).astype(np.float32)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    ref = jenv.sample_L(j, jnp.asarray(p), jnp.asarray(u4))
    got = tenv.sample_L(t, torch.from_numpy(p), torch.from_numpy(u4))
    for k, (a, b) in enumerate(zip(ref, got)):
        assert _close_lanes(b, a).all(), k
    center = np.array([0.3, 0.7, -0.2], np.float32)
    radius = np.float32(2.5)
    ref = jenv.sample_Le(j, jnp.broadcast_to(jnp.asarray(center), (N, 3)),
                         jnp.asarray(radius), jnp.asarray(u4),
                         jnp.asarray(u2))
    got = tenv.sample_Le(t, torch.from_numpy(center).expand(N, 3),
                         torch.tensor(radius), torch.from_numpy(u4),
                         torch.from_numpy(u2))
    for k, (a, b) in enumerate(zip(ref, got)):
        assert b.shape == np.shape(a), k
        assert _close_lanes(b, a, atol=1e-5).all(), k
