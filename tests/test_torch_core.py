"""Port core/ (math, samplers, rng) against the JAX package on shared
inputs.  Math and samplers: rtol 1e-5, atol 1e-6.  RNG: bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.core import math as jm
from bidirectional_pathtracing_tpu.core import rng as jr
from bidirectional_pathtracing_tpu.core import samplers as js
from bidirectional_pathtracing_tpu_torch.core import math as tm
from bidirectional_pathtracing_tpu_torch.core import rng as tr
from bidirectional_pathtracing_tpu_torch.core import samplers as ts

RTOL, ATOL = 1e-5, 1e-6


def _close(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x = np.asarray(x)
        y = y.numpy()
        assert x.shape == y.shape, (x.shape, y.shape)
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


def _inputs(seed=0, n=257):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    unit = v / np.linalg.norm(v, axis=-1, keepdims=True)
    # include axis-aligned and tied normals for make_coord_space's tie rule
    unit[:6] = [[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0, -1],
                [0.6, 0.6, 0.529150262], [0.0, 0.70710678, 0.70710678]]
    ior = rng.uniform(1.1, 2.0, n).astype(np.float32)
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    return v, w, unit.astype(np.float32), ior, u


MATH_CASES = {
    "dot": lambda m, t, v, w, n, ior: m.dot(t(v), t(w)),
    "norm": lambda m, t, v, w, n, ior: m.norm(t(v)),
    "norm2": lambda m, t, v, w, n, ior: m.norm2(t(v)),
    "normalize": lambda m, t, v, w, n, ior: m.normalize(t(v)),
    "cross": lambda m, t, v, w, n, ior: m.cross(t(v), t(w)),
    "luminance": lambda m, t, v, w, n, ior: m.luminance(t(np.abs(v))),
    "make_coord_space": lambda m, t, v, w, n, ior: m.make_coord_space(t(n)),
    "to_local": lambda m, t, v, w, n, ior: m.to_local(
        m.make_coord_space(t(n)), t(w)),
    "to_world": lambda m, t, v, w, n, ior: m.to_world(
        m.make_coord_space(t(n)), t(w)),
    "reflect_local": lambda m, t, v, w, n, ior: m.reflect_local(t(n)),
    "refract_local": lambda m, t, v, w, n, ior: m.refract_local(t(n), t(ior)),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math_matches_jax(name):
    v, w, n, ior, _ = _inputs()
    fn = MATH_CASES[name]
    _close(fn(jm, jnp.asarray, v, w, n, ior),
           fn(tm, torch.from_numpy, v, w, n, ior))


def test_math_constants():
    assert tm.INF_D == jm.INF_D == 1e30
    assert tm.EPS_F == jm.EPS_F
    assert tm.PI == float(jm.PI)


SAMPLER_CASES = ["uniform_sphere", "uniform_sphere_pdf", "uniform_hemisphere",
                 "uniform_hemisphere_pdf", "cosine_hemisphere",
                 "cosine_hemisphere_pdf"]


@pytest.mark.parametrize("name", SAMPLER_CASES)
def test_samplers_match_jax(name):
    v, _, _, _, u = _inputs(1)
    arg = v if name.endswith("_pdf") else u
    _close(getattr(js, name)(jnp.asarray(arg)),
           getattr(ts, name)(torch.from_numpy(arg)))


KEYS = [(0, 0), (7, 3), (123456789, 41), (2 ** 31 + 5, 2 ** 32 - 1)]


@pytest.mark.parametrize("seed,data", KEYS)
def test_fold_in_bitwise(seed, data):
    ref = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.key(seed), data)))
    np.testing.assert_array_equal(tr.fold_in(tr.key(seed), data), ref)


def test_fold_in_known_value():
    # fold_in(key(7), 3) of jax's threefry, checked against jax
    np.testing.assert_array_equal(tr.fold_in(tr.key(7), 3),
                                  [276534068, 1641862660])


LANES = [(0, 300), (172_500, 172_800), (2 ** 31 - 200, 2 ** 31 - 1)]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("seed,pass_i", [(0, 0), (3, 17)])
def test_lane_streams_bitwise(lanes, seed, pass_i):
    ids = np.arange(*lanes, dtype=np.int32)
    jkey = jax.random.fold_in(jax.random.key(seed), pass_i)
    tkey = tr.fold_in(tr.key(seed), pass_i)
    jk = jr.lane_keys(jkey, jnp.asarray(ids))
    tk = tr.lane_keys(tkey, torch.from_numpy(ids))
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    for site in (1, 10, 40, 1000 + 8 * 5 + 1, 2 ** 31 + 3):
        jf, tf = jr.fold(jk, site), tr.fold(tk, site)
        np.testing.assert_array_equal(np.asarray(jf).astype(np.int64),
                                      tf.numpy())
        for suffix in ((), (2,), (3,), (2, 2)):
            a = np.asarray(jr.uniform(jf, suffix))
            b = tr.uniform(tf, suffix)
            assert b.dtype == torch.float32 and a.shape == tuple(b.shape)
            np.testing.assert_array_equal(a, b.numpy())
        for maxval in (1, 3, 1000):
            a = np.asarray(jr.randint(jf, maxval))
            b = tr.randint(tf, maxval)
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(a, b.numpy())
