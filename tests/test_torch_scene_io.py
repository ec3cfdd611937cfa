"""The port's scene loading and image IO against the JAX package's, on the
CPU:

  - scene/build.py load_scene on the two COLLADA fixtures of
    tests/golden/torch_port/ (cbox_spheres.dae: phong walls, CGL light,
    mirror and glass spheres, translate/rotate/scale and a short camera
    matrix; cbox_ico.dae: the mesh Cornell box with level-1 icospheres),
    with and without each mesh op: every leaf of the scene and every aux
    entry bitwise equal;
  - scene/meshedit.py HalfedgeMesh: each edit operation on the icosahedron
    and the grid of tests/test_meshedit.py gives the same to_arrays() and
    a valid mesh;
  - the file writers give the JAX package's bytes, and each side reads
    the other's files: PNG, EXR, the tonemapped image, the sampling-rate
    image, the env map's probability image and the camera settings file;
  - scene/procedural.py write_cornell_box_dae writes cbox_ico.dae at
    level 1, and two upsample rounds give the triangle count chip_smoke.py
    phase 9a holds at level 4 (and the BVH both packages attach there);
  - scene/dump.py: the text dump of both fixtures byte for byte.

The JAX package's downsample breaks cost ties by the builtin id() of an
edge, a memory address, so on meshes with tied costs (the grid, the
icosahedron) its result changes from run to run.  The port breaks them by
the edge's index in the mesh's edge list; the tests run the JAX downsample
with its edges numbered in the same order (numbered_ids), so the two
compute the same mesh.
"""

import builtins
import itertools
import os

import numpy as np
import pytest
import torch

from bidirectional_pathtracing_tpu.ops import envlight as jenv
from bidirectional_pathtracing_tpu.scene import build as jbuild
from bidirectional_pathtracing_tpu.scene import camera_file as jcam
from bidirectional_pathtracing_tpu.scene import clusters as jclusters
from bidirectional_pathtracing_tpu.scene import dump as jdump
from bidirectional_pathtracing_tpu.scene import meshedit as jme
from bidirectional_pathtracing_tpu.utils import exr as jexr
from bidirectional_pathtracing_tpu.utils import image as jimage
from bidirectional_pathtracing_tpu.utils import png as jpng
from bidirectional_pathtracing_tpu_torch.ops import envlight as tenv
from bidirectional_pathtracing_tpu_torch.scene import build as tbuild
from bidirectional_pathtracing_tpu_torch.scene import camera_file as tcam
from bidirectional_pathtracing_tpu_torch.scene import dump as tdump
from bidirectional_pathtracing_tpu_torch.scene import meshedit as tme
from bidirectional_pathtracing_tpu_torch.scene import procedural as tproc
from bidirectional_pathtracing_tpu_torch.scene.types import to_numpy
from bidirectional_pathtracing_tpu_torch.utils import exr as texr
from bidirectional_pathtracing_tpu_torch.utils import image as timage
from bidirectional_pathtracing_tpu_torch.utils import png as tpng
from tests.test_meshedit import grid, icosahedron
from tests.test_torch_clusters import numpy_builder  # noqa: F401
from tests.test_torch_scene import (
    assert_leaves_equal, jax_scene_arrays)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden", "torch_port")
MESH_OPS = [(), ("upsample",), ("downsample",), ("resample",)]


def fixture(name):
    return os.path.join(FIXTURES, f"{name}.dae")


@pytest.fixture
def numbered_ids(monkeypatch):
    """Give the JAX package's meshedit an id() that numbers edges in the
    order it first sees them: its downsample first sees every edge in the
    order of the mesh's edge list, the order the port breaks ties in."""
    counter = itertools.count()

    def numbered_id(obj):
        if isinstance(obj, jme.Edge):
            if obj.id < 0:
                obj.id = next(counter)
            return obj.id
        return builtins.id(obj)

    monkeypatch.setattr(jme, "id", numbered_id, raising=False)


def assert_aux_equal(ja, ta):
    for k in ("num_tris", "num_spheres", "names"):
        assert ja[k] == ta[k], k
    for a, b in zip(ja["bbox"], ta["bbox"]):
        np.testing.assert_array_equal(a, b)
    assert len(ja["material_records"]) == len(ta["material_records"])
    for a, b in zip(ja["material_records"], ta["material_records"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ja["orbit"].keys() == ta["orbit"].keys()
    for k in ja["orbit"]:
        np.testing.assert_array_equal(ja["orbit"][k], ta["orbit"][k],
                                      err_msg=k)


def assert_scenes_equal(js, ja, ts, ta):
    mine = to_numpy(ts)
    assert (js.clusters is None) == (ts.clusters is None)
    if js.clusters is not None:
        # the JAX package attaches its paired layout at this size: hold the
        # port's tables to its flat ones, whose 9 vertex rows of
        # [C,16,128] the port keeps
        flat = jclusters.build_clusters(js.geometry, paired=False)
        for f in flat._fields:
            ref = np.asarray(getattr(flat, f))
            got = mine.pop(f"clusters.{f}")
            np.testing.assert_array_equal(
                ref[:, :9] if f == "tris" else ref, got, err_msg=f)
    assert_leaves_equal(jax_scene_arrays(js), mine)
    assert_aux_equal(ja, ta)


@pytest.mark.parametrize("ops", MESH_OPS, ids=lambda o: "+".join(o) or "none")
@pytest.mark.parametrize("name", ["cbox_spheres", "cbox_ico"])
def test_load_scene_matches_jax_bitwise(name, ops, numbered_ids):
    js, ja = jbuild.load_scene(fixture(name), 48, 36, mesh_ops=ops)
    ts, ta = tbuild.load_scene(fixture(name), 48, 36, mesh_ops=ops,
                               device="cpu")
    assert ts.device == torch.device("cpu")
    assert_scenes_equal(js, ja, ts, ta)
    assert set(ta["seconds"]) == {"load_dae", "mesh_ops", "flatten",
                                  "bvh_build", "clusters", "upload"}


def test_fixtures_load_as_described():
    """cbox_spheres.dae: 12 triangles (walls and light quad), the mirror
    and glass spheres of radius 0.3 where their nodes put them, six
    materials in order of first use, one area light of area 0.48, wall
    normals pointing into the box (the boundary-walk flip)."""
    ts, ta = tbuild.load_scene(fixture("cbox_spheres"), 48, 36, device="cpu")
    g = ts.geometry
    assert (ta["num_tris"], ta["num_spheres"]) == (12, 2)
    np.testing.assert_allclose(g.sph_c.numpy(),
                               [[-0.4, 0.3, -0.3], [0.4, 0.3, 0.3]],
                               atol=1e-6)
    np.testing.assert_allclose(g.sph_r.numpy(), [0.3, 0.3], rtol=1e-6)
    assert ts.materials.kind.tolist() == [0, 0, 0, 1, 2, 4]
    assert g.tri_mat.tolist() == [0] * 6 + [1, 1, 2, 2, 3, 3]
    np.testing.assert_allclose(ts.lights.area.numpy(), [0.48], rtol=1e-6)
    normals = g.tri_n[::2, 0].numpy()       # floor, ceiling, back, left,
    np.testing.assert_array_equal(           # right, light
        normals, [[0, 1, 0], [0, -1, 0], [0, 0, 1], [1, 0, 0], [-1, 0, 0],
                  [0, -1, 0]])


def test_cornell_box_dae_writer_counts(numbered_ids, numpy_builder,
                                       tmp_path):
    """write_cornell_box_dae at level 1 writes cbox_ico.dae, whose
    triangles are mesh_cornell_box_arrays(1)'s; two upsample rounds give
    12 quads x 16 + 2 x 20 x 4**(level+2) triangles in both packages (the
    count chip_smoke.py phase 9a holds at level 4: 164,032), with the
    cluster tables attached (above 2,048 primitives) and equal."""
    path = str(tmp_path / "cb1.dae")
    tproc.write_cornell_box_dae(path, 1)
    with open(path, "rb") as a, open(fixture("cbox_ico"), "rb") as b:
        assert a.read() == b.read()
    ts, _ = tbuild.load_scene(path, 48, 36, device="cpu")
    arrays = tproc.mesh_cornell_box_arrays(1)
    np.testing.assert_array_equal(ts.geometry.tri_p.numpy()[12:],
                                  arrays["tri_p"][12:])
    ops = ("upsample", "upsample")
    js, ja = jbuild.load_scene(path, 48, 36, mesh_ops=ops)
    ts, ta = tbuild.load_scene(path, 48, 36, mesh_ops=ops, device="cpu")
    assert ja["num_tris"] == 6 * 2 * 16 + 2 * 20 * 4 ** 3 == 2752
    assert js.clusters is not None and ts.clusters is not None
    assert_scenes_equal(js, ja, ts, ta)
    for f in ts.bvh._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js.bvh, f)),
                                      getattr(ts.bvh, f).numpy(), err_msg=f)


@pytest.mark.parametrize("name", ["cbox_spheres", "cbox_ico"])
def test_dump_scene_matches_jax(name, tmp_path):
    from bidirectional_pathtracing_tpu.scene import collada as jcollada
    from bidirectional_pathtracing_tpu_torch.scene import collada as tcollada
    text = tdump.dump_scene_text(tcollada.load_dae(fixture(name)))
    assert text == jdump.dump_scene_text(jcollada.load_dae(fixture(name)))
    assert text.startswith("camera ") and "\nmaterial " in text
    tdump.dump_scene(fixture(name), str(tmp_path / "port.txt"))
    jdump.dump_scene(fixture(name), str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


def _port_mesh(jax_mesh):
    """The same mesh built by both packages from one array pair."""
    pos, tris = jax_mesh.to_arrays()
    return (jme.HalfedgeMesh.from_arrays(pos, tris),
            tme.HalfedgeMesh.from_arrays(pos, tris))


def _first_edge(mesh, boundary):
    return next(i for i, e in enumerate(mesh.edges)
                if not e.removed and e.is_boundary() == boundary)


EDITS = [(shape, op) for shape in ("icosahedron", "grid")
         for op in ("flip_edge", "split_edge", "split_boundary",
                    "collapse_edge", "upsample", "downsample", "resample")
         # the icosahedron is closed: it has no boundary edge
         if (shape, op) != ("icosahedron", "split_boundary")]


@pytest.mark.parametrize("shape,op", EDITS)
def test_halfedge_mesh_matches_jax(shape, op, numbered_ids):
    jm, tm = _port_mesh(icosahedron() if shape == "icosahedron" else grid())
    for m in (jm, tm):
        if op.endswith(("_edge", "_boundary")):
            i = _first_edge(m, boundary=op == "split_boundary")
            name = "split_edge" if op == "split_boundary" else op
            out = getattr(m, name)(m.edges[i])
            assert out is not None, (shape, op)
        else:
            getattr(m, op)()
        m.validate()
    (jp, jt), (tp, tt) = jm.to_arrays(), tm.to_arrays()
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jp, tp)


def _rgba(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _hdr(seed, h=18, w=24):
    rng = np.random.default_rng(seed)
    return rng.gamma(0.7, 0.6, (h, w, 3)).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _write_both(tmp_path, name, write):
    """write(module_pair_index, path) for the JAX side (0) and the port (1);
    returns the two paths."""
    paths = [str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")]
    for side, p in enumerate(paths):
        write(side, p)
    return paths


@pytest.mark.parametrize("channels", [3, 4])
def test_png_bytes_and_cross_read(tmp_path, channels):
    img = _rgba(channels, (13, 17, channels))
    pj, pt = _write_both(tmp_path, "a.png", lambda s, p: (
        jpng, tpng)[s].write_png(p, img))
    assert _bytes(pj) == _bytes(pt)
    want = img if channels == 4 else np.concatenate(
        [img, np.full((13, 17, 1), 255, np.uint8)], axis=2)
    np.testing.assert_array_equal(tpng.read_png(pj), want)
    np.testing.assert_array_equal(jpng.read_png(pt), want)


@pytest.mark.parametrize("compression", [0, 2, 3], ids=["none", "zips",
                                                         "zip"])
def test_exr_bytes_and_cross_read(tmp_path, compression):
    """The writers' bytes are equal.  The port reads every file back
    exactly: the sky's blocks shrink under zlib, the noise rows' do not.
    The JAX reader misdecodes shrunk blocks (ROADMAP C), so it is held to
    the image on the uncompressed file."""
    img = np.concatenate([tproc.synthetic_sky()[:, :19], _hdr(compression,
                                                            5, 19)])
    pj, pt = _write_both(tmp_path, "a.exr", lambda s, p: (
        jexr, texr)[s].write_exr(p, img, compression))
    assert _bytes(pj) == _bytes(pt)
    got = texr.read_exr(pj)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    if compression == 0:
        np.testing.assert_array_equal(jexr.read_exr(pt), img)


def test_exr_zip_undelta_inverts_the_predictor():
    """The port's _unpredict undoes _predict (OpenEXR's zip predictor and
    interleave); the JAX package's leaves sum(d[:i+1]) where the format
    has sum(d[:i+1]) - 128 i."""
    raw = np.random.default_rng(7).integers(0, 256, 1001, np.uint8)
    assert texr._predict(raw) == jexr._predict(raw)
    np.testing.assert_array_equal(texr._unpredict(texr._predict(raw)), raw)
    assert not np.array_equal(jexr._unpredict(jexr._predict(raw)), raw)


def test_exr_reader_refuses_other_files(tmp_path):
    stub = tmp_path / "stub.exr"
    stub.write_bytes(b"version https://git-lfs.github.com/spec/v1\n")
    with pytest.raises(ValueError, match="not an EXR file"):
        texr.read_exr(str(stub))


def test_save_image_bytes(tmp_path):
    hdr = _hdr(5)
    hdr[0, 0] = [1e30, -1.0, 0.0]
    pj, pt = _write_both(tmp_path, "out.png", lambda s, p: (
        jimage, timage)[s].save_image(p, hdr))
    assert _bytes(pj) == _bytes(pt)
    assert tpng.read_png(pt).shape == (18, 24, 4)
    np.testing.assert_array_equal(timage.tonemap(hdr), jimage.tonemap(hdr))


def test_save_sampling_rate_image_bytes(tmp_path):
    counts = np.random.default_rng(6).integers(0, 9, (18, 24)).astype(
        np.int32)
    pj, pt = _write_both(tmp_path, "out.png", lambda s, p: (
        jimage, timage)[s].save_sampling_rate_image(p, counts, 8))
    assert _bytes(pj[:-4] + "_rate.png") == _bytes(pt[:-4] + "_rate.png")


def test_save_probability_debug_bytes(tmp_path):
    sky = tproc.synthetic_sky()
    envs = (jenv.build_envmap(sky), tenv.build_envmap(sky, device="cpu"))
    pj, pt = _write_both(tmp_path, "probability_debug.png", lambda s, p: (
        jenv, tenv)[s].save_probability_debug(envs[s], p))
    assert _bytes(pj) == _bytes(pt)
    assert tpng.read_png(pt).shape == (32, 64, 4)


@pytest.mark.parametrize("orbit", [True, False], ids=["orbit", "derived"])
def test_camera_file_bytes_and_load(tmp_path, orbit):
    js, ja = jbuild.load_scene(fixture("cbox_spheres"), 48, 36)
    ts, ta = tbuild.load_scene(fixture("cbox_spheres"), 48, 36,
                               device="cpu")
    pj, pt = _write_both(tmp_path, "cam.txt", lambda s, p: (
        jcam, tcam)[s].dump_camera_settings(
            (js, ts)[s].camera, p, 48, 36,
            orbit=(ja, ta)[s]["orbit"] if orbit else None))
    assert _bytes(pj) == _bytes(pt)
    jc = jcam.load_camera_settings(pj, lens_radius=0.1)
    tc = tcam.load_camera_settings(pt, lens_radius=0.1, device="cpu")
    for f in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    # the dump's floats read back to the loaded camera's float32 values
    for f in ("c2w", "pos", "hfov", "vfov", "nclip", "fclip"):
        torch.testing.assert_close(getattr(tc, f), getattr(ts.camera, f),
                                   rtol=0, atol=0)
