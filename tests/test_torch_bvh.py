"""Procedural scenes, the BVH build and its packed tables: the port against the JAX
package, bit for bit; the native build and widening against JAX's and the port's
numpy code, and the inputs that send them to the numpy code; the per-ray
`intersect_bvh` against JAX's and against the brute-force scan; and the auto driver,
which sends a 564-triangle scene to the 8-wide BVH kernel, against JAX's (its Pallas
kernel in interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.config import CameraConfig as JCam
from oclpathtracer_tpu.core import bvh as jbvh
from oclpathtracer_tpu.core.intersect import intersect_world as j_intersect_world
from oclpathtracer_tpu.kernels import bvh_megakernel as jbk
from oclpathtracer_tpu.kernels import wide_bvh as jwb
from oclpathtracer_tpu.render import driver as jdriver
from oclpathtracer_tpu.scene import procgen as jprocgen
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.core import bvh
from oclpathtracer_tpu_torch.core.intersect import intersect_world
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import selfcheck
from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
from oclpathtracer_tpu_torch.render import driver
from oclpathtracer_tpu_torch.runtime import native, profiling
from oclpathtracer_tpu_torch.scene import load_cornell_box, procgen
from oclpathtracer_tpu_torch.scene.types import Geometry

torch.set_num_threads(1)

EYE = (0.0, 3.0, 9.0)  # the JAX package's camera for procedural scenes


def _port(jscene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in jscene], device="cpu")


def _port_geometry(jgeom):
    return Geometry(*(torch.from_numpy(np.array(x)) for x in jgeom))


def _assert_bitwise(port, ref):
    ref = np.asarray(ref)
    got = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _assert_same_bits(port, ref):
    """Equal dtype, shape and bytes (so also the sign of every zero)."""
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert port.numpy().tobytes() == ref.numpy().tobytes()


def _build_counts():
    c = profiling.counts()
    return {k: c.get(k, 0) for k in ("bvh_build.native", "bvh_build.fallback",
                                      "bvh_widen.native", "bvh_widen.fallback")}


def _rose(before, after):
    return {k for k in after if after[k] != before[k]}


@pytest.fixture(scope="module")
def geoms(scene):
    """(JAX geometry, port geometry) of the build cases."""
    jsf = jprocgen.sphere_field(3, 1, seed=2)
    jrt = jprocgen.random_triangles(777, seed=3)
    j5k = jprocgen.sphere_field()
    j102k = jprocgen.sphere_field(80, 3)
    return {"cornell": (scene.geometry, _port(scene).geometry),
            "random777": (jrt, _port_geometry(jrt)),
            "spheres244": (jsf.geometry, _port(jsf).geometry),
            "spheres5k": (j5k.geometry, _port(j5k).geometry),
            "spheres102k": (j102k.geometry, _port(j102k).geometry)}


@pytest.fixture(scope="module")
def scenes(scene):
    """(JAX scene, port scene) with materials."""
    jsf = jprocgen.sphere_field(3, 1, seed=2)
    return {"cornell": (scene, _port(scene)), "spheres244": (jsf, _port(jsf))}


@pytest.mark.parametrize("args", [dict(n_spheres=3, subdivisions=1, seed=2), dict(),
                                  dict(n_spheres=2, subdivisions=0, seed=5,
                                       specular_fraction=1.0)])
def test_sphere_field_bitwise(args):
    ref = jprocgen.sphere_field(**args)
    got = procgen.sphere_field(**args, device="cpu")
    for part_t, part_j in zip(got, ref):
        for t, j in zip(part_t, part_j):
            _assert_bitwise(t, j)
    if not args:
        assert got.num_triangles == 5124


def test_random_triangles_and_icosphere_bitwise():
    for t, j in zip(procgen.random_triangles(777, seed=3, device="cpu"), jprocgen.random_triangles(777, seed=3)):
        _assert_bitwise(t, j)
    for t, j in zip(procgen.icosphere((1.0, 2.0, 3.0), 0.5, 2),
                    jprocgen.icosphere((1.0, 2.0, 3.0), 0.5, 2)):
        np.testing.assert_array_equal(t, j)


BUILD_CASES = ([(name, leaf, branching) for branching in (2, 8) for leaf in (4, 8, 32)
                for name in ("cornell", "random777", "spheres244")]
               + [("spheres5k", leaf, branching) for branching in (2, 8) for leaf in (8, 32)]
               + [("spheres102k", 64, 8)])


@pytest.mark.parametrize("name,leaf,branching", BUILD_CASES,
                         ids=[f"{n}-{leaf}-{b}" for n, leaf, b in BUILD_CASES])
def test_build_bvh_bitwise(geoms, name, leaf, branching):
    """The native build and widening, against JAX's and the port's numpy code; each
    call takes the native route."""
    jgeom, tgeom = geoms[name]
    ref = jbvh.build_bvh(jgeom, leaf_size=leaf, branching=branching)
    before = _build_counts()
    got = bvh.build_bvh(tgeom, leaf_size=leaf, branching=branching)
    tw = bvh.widen_bvh(got)
    assert _rose(before, _build_counts()) == {"bvh_build.native", "bvh_widen.native"}
    assert _build_counts()["bvh_build.native"] == before["bvh_build.native"] + 1
    plain = bvh.build_bvh_numpy(tgeom, leaf_size=leaf, branching=branching)
    for field in bvh.FlatBVH._fields:
        _assert_bitwise(getattr(got, field), getattr(ref, field))
        _assert_same_bits(getattr(got, field), getattr(plain, field))
    assert got.num_nodes == ref.num_nodes
    jw = jbvh.widen_bvh(ref)
    pw = bvh.widen_bvh_numpy(plain)
    for field in bvh.WideBVH._fields[:-1]:
        _assert_bitwise(getattr(tw, field), getattr(jw, field))
        _assert_same_bits(getattr(tw, field), getattr(pw, field))
    assert tw.depth == jw.depth == pw.depth
    for t, j in zip(bvh.reorder_geometry(tgeom, got), jbvh.reorder_geometry(jgeom, ref)):
        _assert_bitwise(t, j)


@pytest.mark.parametrize("branching", [2, 8])
def test_build_bvh_falls_back_on_coincident_centroids(branching):
    """40 copies of one triangle among random ones: a group of them has degenerate
    centroids, where the numpy build takes np.argpartition's order, so the whole
    build runs in numpy, bit for bit JAX's."""
    jrt = jprocgen.random_triangles(300, seed=11)
    parts = [np.asarray(x) for x in jrt]
    at = 150
    parts = [np.concatenate([x[:at], np.repeat(x[at:at + 1], 40, axis=0), x[at:]])
             for x in parts]
    jgeom = jrt._replace(**dict(zip(jrt._fields, parts)))
    ref = jbvh.build_bvh(jgeom, leaf_size=4, branching=branching)
    before = _build_counts()
    got = bvh.build_bvh(_port_geometry(jgeom), leaf_size=4, branching=branching)
    after = _build_counts()
    assert _rose(before, after) == {"bvh_build.fallback"}
    assert after["bvh_build.fallback"] == before["bvh_build.fallback"] + 1
    for field in bvh.FlatBVH._fields:
        _assert_bitwise(getattr(got, field), getattr(ref, field))
    jw, tw = jbvh.widen_bvh(ref), bvh.widen_bvh(got)
    for field in bvh.WideBVH._fields[:-1]:
        _assert_bitwise(getattr(tw, field), getattr(jw, field))
    assert tw.depth == jw.depth


def test_build_bvh_falls_back_without_the_library(geoms, monkeypatch):
    """Where the native library cannot be built or loaded, the build and the
    widening run in numpy, bit for bit JAX's, and count a fallback each."""
    def no_library():
        raise OSError("no native library")

    monkeypatch.setattr(native, "load_library", no_library)
    jgeom, tgeom = geoms["spheres244"]
    ref = jbvh.build_bvh(jgeom, leaf_size=8, branching=8)
    before = _build_counts()
    got = bvh.build_bvh(tgeom, leaf_size=8, branching=8)
    tw = bvh.widen_bvh(got)
    after = _build_counts()
    assert _rose(before, after) == {"bvh_build.fallback", "bvh_widen.fallback"}
    assert after["bvh_build.fallback"] == before["bvh_build.fallback"] + 1
    for field in bvh.FlatBVH._fields:
        _assert_bitwise(getattr(got, field), getattr(ref, field))
    jw = jbvh.widen_bvh(ref)
    for field in bvh.WideBVH._fields[:-1]:
        _assert_bitwise(getattr(tw, field), getattr(jw, field))
    assert tw.depth == jw.depth


def test_native_widen_raises_on_too_many_children(geoms):
    """A node with more children than `max_children` raises the numpy code's
    ValueError through the native route."""
    _, tgeom = geoms["spheres244"]
    flat = bvh.build_bvh(tgeom, leaf_size=4, branching=8)
    with pytest.raises(ValueError) as plain:
        bvh.widen_bvh_numpy(flat, max_children=4)
    before = _build_counts()
    with pytest.raises(ValueError) as got:
        bvh.widen_bvh(flat, max_children=4)
    assert _rose(before, _build_counts()) == {"bvh_widen.native"}
    assert str(got.value) == str(plain.value)
    assert "more than 4 children" in str(got.value)


@pytest.mark.parametrize("leaf", [4, 32])
@pytest.mark.parametrize("name", ["cornell", "spheres244"])
def test_packed_bvh_tables_bitwise(scenes, name, leaf):
    jscene, tscene = scenes[name]
    for t, j in zip(bk.pack_bvh_scene(tscene, leaf_size=leaf),
                    jbk.pack_bvh_scene(jscene, leaf_size=leaf)):
        _assert_bitwise(t, j)
    got = bk.pack_bvh_scene_tp(tscene, leaf_size=leaf)
    ref = jbk.pack_bvh_scene_tp(jscene, leaf_size=leaf)
    for t, j in zip(got[:3], ref[:3]):
        _assert_bitwise(t, j)
    assert got[3] == ref[3]
    for scan in ("parity", "tp"):
        got = wb.pack_wide_bvh_scene(tscene, leaf_size=leaf, scan=scan)
        ref = jwb.pack_wide_bvh_scene(jscene, leaf_size=leaf, scan=scan)
        for t, j in zip(got[:3], ref[:3]):
            _assert_bitwise(t, j)
        assert got[3:] == ref[3:]


def test_single_leaf_tree_widens_to_one_group(geoms):
    jgeom, tgeom = geoms["cornell"]
    jw = jbvh.widen_bvh(jbvh.build_bvh(jgeom, leaf_size=64, branching=8))
    tw = bvh.widen_bvh(bvh.build_bvh(tgeom, leaf_size=64, branching=8))
    assert tw.depth == jw.depth == 1
    for field in bvh.WideBVH._fields[:-1]:
        _assert_bitwise(getattr(tw, field), getattr(jw, field))


def _rays(seed, n, lo, hi, shift=(0.0, 0.0, 0.0)):
    rs = np.random.RandomState(seed)
    o = (rs.uniform(lo, hi, (n, 3)) + np.asarray(shift)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("case", ["cornell", "random500"])
def test_intersect_bvh_matches_jax_and_brute_force(scene, case):
    """tests/test_bvh.py's traversal checks, for the per-ray twin: the same hits,
    distances and triangles as JAX's intersect_bvh and the brute-force scan."""
    if case == "cornell":
        jgeom, leaf = scene.geometry, 4
        o, d = _rays(0, 256, -2, 2, (0.0, 2.75, 0.0))
    else:
        jgeom, leaf = jprocgen.random_triangles(500, seed=11), 8
        o, d = _rays(5, 128, -3, 3)
    tgeom = _port_geometry(jgeom)
    jtree = jbvh.build_bvh(jgeom, leaf_size=leaf)
    ttree = bvh.build_bvh(tgeom, leaf_size=leaf)
    t_j, idx_j, hit_j = jbvh.intersect_bvh(jnp.asarray(o), jnp.asarray(d), jtree,
                                           jbvh.reorder_geometry(jgeom, jtree))
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t_t, idx_t, hit_t = bvh.intersect_bvh(to, td, ttree, bvh.reorder_geometry(tgeom, ttree))
    np.testing.assert_array_equal(hit_t.numpy(), np.asarray(hit_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    ok = hit_t.numpy()
    np.testing.assert_allclose(t_t.numpy()[ok], np.asarray(t_j)[ok], rtol=1e-6, atol=1e-6)

    rec = intersect_world(to, td, tgeom)
    np.testing.assert_array_equal(hit_t.numpy(), rec.hit.numpy())
    np.testing.assert_allclose(t_t.numpy()[ok], rec.t.numpy()[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ttree.order.numpy()[idx_t.numpy()[ok]],
                                  rec.tri_idx.numpy()[ok])
    rec_j = j_intersect_world(jnp.asarray(o), jnp.asarray(d), jgeom)
    np.testing.assert_array_equal(ok, np.asarray(rec_j.hit))


def test_auto_sends_large_scenes_to_widebvh_and_matches_jax(monkeypatch):
    """sphere_field(7, 1) has 564 triangles: auto picks the 8-wide BVH kernel with tp
    leaves in both packages (JAX's at leaf 32, the port's at WIDE_BVH_SMALL_LEAF).
    32×32, 2 bounces, 1 spp; JAX's kernel runs in interpret mode. Images allclose at
    rtol = atol = 1e-4, the JAX package's contract (the driver returns no segment
    count)."""
    jscene = jprocgen.sphere_field(7, 1)
    tscene = procgen.sphere_field(7, 1, device="cpu")
    assert tscene.num_triangles == 564 > driver.LINEAR_KERNEL_MAX_TRIS
    calls = []
    real = wb.render_samples_wide_bvh_stats

    def spy(*args, **kw):
        calls.append(kw["scan"])
        return real(*args, **kw)

    monkeypatch.setattr(wb, "render_samples_wide_bvh_stats", spy)
    img_j = jdriver.render_progressive(jscene, JCfg(width=32, height=32, bounces=2,
                                                    camera=JCam(eye=EYE)),
                                       1, samples_per_step=1, backend="auto")
    img_t = driver.render_progressive(tscene, RenderConfig(width=32, height=32, bounces=2,
                                                           camera=CameraConfig(eye=EYE)),
                                      1, samples_per_step=1, backend="auto")
    assert calls == ["tp"]
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)


def _auto_launch(scene, monkeypatch, backend="auto") -> dict:
    """The keyword arguments and table rows of the 8-wide launch that the driver makes
    for `scene` on `backend` (the launch itself replaced by zeros), and under `built`
    the leaves whose `wide_leaf.<leaf>` counter the render raised, by how much."""
    seen = {}
    before = profiling.counts()

    def fake(table, wn_f, wn_i, cfg, start, n, **kw):
        seen.update(kw, rows=table.shape[0])
        return torch.zeros((cfg.n_pixels, 3)), torch.zeros((), dtype=torch.int64)

    monkeypatch.setattr(wb, "render_samples_wide_bvh_stats", fake)
    driver.render_progressive(scene, RenderConfig(8, 8, bounces=16), 1, backend=backend)
    after = profiling.counts()
    seen["built"] = {int(k.split(".")[1]): v - before.get(k, 0) for k, v in after.items()
                     if k.startswith("wide_leaf.") and v != before.get(k, 0)}
    return seen


def test_default_sphere_field_takes_the_fast_scan_on_widebvh(monkeypatch):
    """sphere_field() (5,124 triangles, 18 material classes): auto goes to widebvh
    with the fast scan, as in the JAX driver, at the leaf measured on the H100 for
    scenes past WIDE_BVH_LEAF_SWITCH_TRIS (6; the JAX driver's is 32), a 5-level
    tree. The render itself is not run here (the plain version at this size is the
    card's test)."""
    seen = _auto_launch(procgen.sphere_field(device="cpu"), monkeypatch)
    assert seen["scan"] == "fast" and seen["max_leaf"] == 6 and seen["max_depth"] == 5
    assert seen["emi_const"] == (30.0, 30.0, 30.0) and seen["rows"] == 5124 + 6
    assert seen["built"] == {6: 1}


@pytest.mark.parametrize("spheres, subdivisions, tris, leaf, depth",
                         [(10, 1, 804, 16, 3), (3, 2, 964, 6, 4)])
def test_auto_leaf_switches_at_the_measured_triangle_count(monkeypatch, spheres,
                                                           subdivisions, tris, leaf, depth):
    """One scene on each side of WIDE_BVH_LEAF_SWITCH_TRIS (900): leaf 16 at or below,
    leaf 6 above; the table carries that many zero rows past the triangles."""
    scene = procgen.sphere_field(spheres, subdivisions, device="cpu")
    assert scene.num_triangles == tris
    assert (tris <= driver.WIDE_BVH_LEAF_SWITCH_TRIS) == (leaf == driver.WIDE_BVH_SMALL_LEAF)
    seen = _auto_launch(scene, monkeypatch)
    assert seen["max_leaf"] == leaf and seen["max_depth"] == depth
    assert seen["rows"] == tris + leaf and seen["built"] == {leaf: 1}


def test_explicit_widebvh_below_the_auto_range_keeps_leaf_32(monkeypatch):
    """The Cornell box (36 triangles, at or below LINEAR_KERNEL_MAX_TRIS, so auto takes
    the linear kernels): an explicit backend="widebvh" builds at leaf 32, as before
    the leaf was measured on the H100 (leaf 16 is 8 % slower there)."""
    scene = load_cornell_box(device="cpu")
    assert scene.num_triangles == 36 <= driver.LINEAR_KERNEL_MAX_TRIS
    seen = _auto_launch(scene, monkeypatch, backend="widebvh")
    assert seen["max_leaf"] == driver.WIDE_BVH_TINY_LEAF == 32
    assert seen["rows"] == 36 + 32 and seen["built"] == {32: 1}


def test_the_cards_checks_take_the_drivers_wide_leaf():
    """kernels/selfcheck.py's DRIVER_WIDE_LEAF, at which the card's checks hold the
    8-wide kernel bit for bit its plain version on sphere_field(), is the leaf the
    driver builds for sphere_field() and sphere_field(80, 3)."""
    assert selfcheck.DRIVER_WIDE_LEAF == driver.WIDE_BVH_LEAF
    assert driver.wide_leaf(5124) == driver.wide_leaf(102_404) == driver.WIDE_BVH_LEAF
    assert {(c.scene, c.scan) for c in selfcheck.bvh_cases(8, 8)
            if c.kernel == "widebvh" and c.leaf == driver.WIDE_BVH_LEAF} == {
        ("spheres5k", "parity"), ("spheres5k", "fast")}
