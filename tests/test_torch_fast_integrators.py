"""The AO and direct-NEE kernels' plain PyTorch versions (kernels 5 and 6) against
the JAX package: its Pallas kernels in interpret mode and its twins.

On CPU tensors `render_ao_pallas` and `render_direct_pallas` run the plain versions;
the CUDA kernels are held against them on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances are the JAX package's for its kernels against their twins
(tests/test_kernels.py): 1e-5 for AO, 1e-4 for direct, whose kernel clamps the BRDF
denominator after the ×4 where the twin's eval_brdf clamps before it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.integrators.ao import render_ao_sample_ref as jao_ref
from oclpathtracer_tpu.integrators.direct import render_direct_sample_ref as jdirect_ref
from oclpathtracer_tpu.kernels import fast_integrators as jfi
from oclpathtracer_tpu.kernels.megakernel import pack_scene as jpack_scene
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.integrators import ao, direct
from oclpathtracer_tpu_torch.kernels import fast_integrators as fi
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.scene.procgen import sphere_field

torch.set_num_threads(1)

TOL = {"ao": dict(rtol=1e-5, atol=1e-5), "direct": dict(rtol=1e-4, atol=1e-4)}


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.fixture(scope="module")
def tables(port_scene):
    lt, area = fi.pack_lights(port_scene)
    return mk.pack_scene(port_scene), lt, area


def _port(kind, tables, cfg, start, n, **kw):
    table, lt, area = tables
    if kind == "ao":
        return fi.render_ao_pallas(table, cfg, start, n, **kw).numpy()
    return fi.render_direct_pallas(table, lt, area, cfg, start, n, **kw).numpy()


def test_pack_lights_matches_jax_bitwise(scene, port_scene):
    lt, area = fi.pack_lights(port_scene)
    jlt, jarea = jfi.pack_lights(scene)
    assert lt.dtype == torch.float32 and lt.shape == (jlt.shape[0], fi.LIGHT_COLS)
    assert np.array_equal(lt.numpy(), np.asarray(jlt))
    assert isinstance(area, np.float32) and area == jarea


def test_ao_plain_matches_jax_interpret_kernel(scene, tables):
    """32×32 (one JAX block), 1 spp: the JAX Pallas kernel in interpret mode."""
    want = np.asarray(jfi.render_ao_pallas(jpack_scene(scene), JCfg(width=32, height=32), 0, 1))
    got = _port("ao", tables, RenderConfig(width=32, height=32), 0, 1)
    np.testing.assert_allclose(got, want, **TOL["ao"])
    assert 0.3 < got.mean() < 1.0  # partially occluded


@pytest.fixture(scope="module")
def jax_direct_32(scene):
    """The JAX Pallas direct kernel in interpret mode at 32×32, 1 spp (about 20 s on
    a CPU), computed once for the tests below."""
    jlt, jarea = jfi.pack_lights(scene)
    return np.asarray(jfi.render_direct_pallas(jpack_scene(scene), jlt, jarea,
                                               JCfg(width=32, height=32), 0, 1))


def test_direct_plain_matches_jax_interpret_kernel(jax_direct_32, tables):
    """32×32, 1 spp: the JAX Pallas kernel in interpret mode, through the wrapper.
    At 2 spp one pixel of the JAX kernel sits 1.006× the tolerance from its own twin
    and from this plain version alike, which agree with each other to 0.007× of it."""
    got = _port("direct", tables, RenderConfig(width=32, height=32), 0, 1)
    np.testing.assert_allclose(got, jax_direct_32, **TOL["direct"])
    assert got.mean() > 0.1  # lit


@pytest.mark.parametrize("kind", ["ao", "direct"])
def test_plain_matches_jax_twin(scene, tables, kind):
    """48×40, frames 3 and 4, against the sum of the JAX reference-stream twins."""
    twin = jao_ref if kind == "ao" else jdirect_ref
    jcfg = JCfg(width=48, height=40)
    want = sum(np.asarray(twin(scene, jcfg, f)) for f in (3, 4))
    got = _port(kind, tables, RenderConfig(width=48, height=40), 3, 2)
    np.testing.assert_allclose(got, want, **TOL[kind])


@pytest.mark.parametrize("kind", ["ao", "direct"])
def test_pid_base_and_ragged_n_rays(scene, tables, kind):
    """Pixels [100, 433) of a 32×24 image: the full image's rows bit for bit, and the
    JAX twin at those pixel ids."""
    cfg = RenderConfig(width=32, height=24)
    full = _port(kind, tables, cfg, 7, 2)
    part = _port(kind, tables, cfg, 7, 2, pid_base=100, n_rays=333)
    assert part.shape == (333, 3) and np.array_equal(part, full[100:433])
    twin = jao_ref if kind == "ao" else jdirect_ref
    pid = jnp.arange(100, 433, dtype=jnp.int32)
    want = sum(np.asarray(twin(scene, JCfg(width=32, height=24), f, pixel_ids=pid))
               for f in (7, 8))
    np.testing.assert_allclose(part, want, **TOL[kind])


def test_ao_radius_reaches_the_kernel(tables):
    """A radius too short to reach any surface leaves every pixel visible."""
    cfg = RenderConfig(width=16, height=16)
    assert np.array_equal(_port("ao", tables, cfg, 0, 2, radius=1e-6), np.full((256, 3), 2.0))
    assert _port("ao", tables, cfg, 0, 2).mean() < 2.0


def test_twins_agree_with_their_integrators(port_scene, tables):
    """The port's AO and direct twins are its integrators on reference uniforms; the
    plain AO kernel equals the AO twin to 1e-5."""
    cfg = RenderConfig(width=16, height=16)
    got = _port("ao", tables, cfg, 2, 1)
    np.testing.assert_allclose(got, ao.render_ao_sample_ref(port_scene, cfg, 2).numpy(),
                               **TOL["ao"])
    got = _port("direct", tables, cfg, 2, 1)
    np.testing.assert_allclose(got, direct.render_direct_sample_ref(port_scene, cfg, 2).numpy(),
                               **TOL["direct"])


def test_plain_counts_the_rays_it_casts(tables):
    table, lt, area = tables
    cfg = RenderConfig(width=16, height=16)
    for kind in ("ao", "direct"):
        counts = fi._new_counts()
        if kind == "ao":
            fi._render_ao_plain(table, cfg, 0, 3, counts=counts)
        else:
            fi._render_direct_plain(table, lt, area, cfg, 0, 3, counts=counts)
        assert counts["camera"] == 3 * 256
        assert 0 < counts["rays"] <= counts["camera"]
        assert counts["rays"] <= counts["tris"] <= counts["rays"] * table.shape[0]


def test_wrappers_check_their_inputs(tables):
    table, lt, area = tables
    cfg = RenderConfig(width=8, height=8)
    with pytest.raises(ValueError):
        fi.render_ao_pallas(table[:, :20].contiguous(), cfg, 0, 1)
    with pytest.raises(ValueError):
        fi.render_ao_pallas(table, cfg, 0, 0)
    with pytest.raises(ValueError):  # the count would no longer be the f32 sum's bits
        fi.render_ao_pallas(table, cfg, 0, 1 << 24)
    with pytest.raises(ValueError):
        fi.render_direct_pallas(table, lt[:, :15].contiguous(), area, cfg, 0, 1)
    with pytest.raises(ValueError):
        fi.render_direct_pallas(table, lt[:0], area, cfg, 0, 1)


# ---- the AO kernel's split and its camera scan over eye rows ------------------------

def _eye_cases(tables):
    """(table, cfg): the Cornell box from its camera, and a sphere field seen from
    inside it, so that rows lie behind the eye and to every side of it."""
    field = sphere_field(8, 1, seed=2, device="cpu")
    eye = (0.0, 2.0, 3.0)
    return {"cornell": (tables[0], RenderConfig(width=20, height=16)),
            "inside a sphere field": (mk.pack_scene(field),
                                      RenderConfig(width=20, height=16,
                                                   camera=CameraConfig(eye=eye)))}


def _camera_rays(cfg, n_samples=2):
    k = mk._Consts.of(cfg)
    pid = torch.arange(cfg.n_pixels, dtype=torch.int64)
    rays = [mk._camera_path(k, cfg, pid, s)[:2] for s in range(n_samples)]
    o = tuple(torch.cat([r[0][a] for r in rays]) for a in range(3))
    d = tuple(torch.cat([r[1][a] for r in rays]) for a in range(3))
    return k, o, d


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("case", ["cornell", "inside a sphere field"])
def test_eye_rows_are_parity_candidate_row_by_row(tables, case):
    """Each kept eye row gives mk._tri_parity's candidacy and t bit for bit on camera
    rays; each row left out is a candidate for none of them."""
    table, cfg = _eye_cases(tables)[case]
    k, o, d = _camera_rays(cfg)
    kept = {row[0]: row for row in fi._eye_rows(table, k.eye)}
    rows = table.tolist()
    assert 0 < len(kept) < len(rows)
    for j, r in enumerate(rows):
        cand, t, _ = mk._tri_parity(r.__getitem__, o, d, None)
        if j in kept:
            cand_e, t_e = fi._tri_parity_eye(kept[j], d)
            assert torch.equal(cand_e, cand) and torch.equal(_bits(t_e), _bits(t))
        else:
            assert not bool(cand.any())


@pytest.mark.parametrize("case", ["cornell", "inside a sphere field"])
def test_eye_scan_nearest_hit_is_the_linear_scan(tables, case):
    table, cfg = _eye_cases(tables)[case]
    k, o, d = _camera_rays(cfg)
    ps = mk._PlainScene(table, (), "parity")
    want = mk._scan_linear(ps, o, d)
    got = fi._scan_eye(ps, fi._eye_rows(table, k.eye), d)
    flat = lambda h: [x for v in h for x in (v if isinstance(v, tuple) else (v,))]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(flat(got), flat(want)))
    assert 0.05 < float((want[0] < mk.T_MAX).float().mean())


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 32])
def test_ao_split_plain_is_the_unsplit_plain_bitwise(tables, lanes):
    """Runs of ceil(n / lanes) samples, integer counts added as integers, the camera
    scan over eye rows: the sample-order f32 sum's bits, on a ragged pixel range
    from a pid_base, with n not a multiple of the lanes."""
    table = tables[0]
    cfg = RenderConfig(width=24, height=16)
    kw = dict(pid_base=37, n_rays=301)
    want = fi._render_ao_plain(table, cfg, 11, 5, **kw)
    got = fi._render_ao_plain(table, cfg, 11, 5, lanes=lanes, **kw)
    assert got.shape == (301, 3) and torch.equal(got, want)
    assert 1.0 < float(want.mean()) < 5.0


def test_ao_lanes_and_route(tables):
    assert [fi.ao_lanes(n) for n in (1, 2, 3, 5, 8, 64)] == [1, 2, 4, 8, 8, 8]
    assert fi.ao_in_shared(tables[0])
    rows = mk.SMEM_TABLE_MAX_BYTES // (mk.TABLE_COLS * 4 + 64)
    assert not fi.ao_in_shared(torch.zeros((rows + 1, mk.TABLE_COLS)))
    assert mk.table_in_shared(torch.zeros((rows + 1, mk.TABLE_COLS)))


# ---- the direct kernel's camera scan over eye rows ----------------------------------

def _eye_lights(tables, case):
    """(light table, total area) of the scene of _eye_cases' `case`."""
    if case == "cornell":
        return tables[1], tables[2]
    return fi.pack_lights(sphere_field(8, 1, seed=2, device="cpu"))


@pytest.mark.parametrize("case", ["cornell", "inside a sphere field"])
def test_direct_eye_plain_is_the_full_scan_plain_bitwise(tables, case):
    """The camera scan over the eye rows (the kernel's shared route) against the scan
    over every row (the JAX kernel's form and the global route), on a ragged pixel
    range from a pid_base: the same sample-order sums, bit for bit."""
    table, cfg = _eye_cases(tables)[case]
    lt, area = _eye_lights(tables, case)
    kw = dict(pid_base=23, n_rays=281)
    eye, full = fi._new_counts(), fi._new_counts()
    got = fi._render_direct_plain(table, lt, area, cfg, 5, 2, counts=eye, **kw)
    want = fi._render_direct_plain(table, lt, area, cfg, 5, 2, counts=full, full_scan=True, **kw)
    assert got.shape == (281, 3) and torch.equal(_bits(got), _bits(want))
    assert 0 < eye["eye_rows"] < table.shape[0] and full["eye_rows"] == 0
    assert {k: v for k, v in eye.items() if k != "eye_rows"} == {
        k: v for k, v in full.items() if k != "eye_rows"}
    assert eye["lit"] > 0


def test_direct_eye_plain_matches_jax_interpret_kernel(jax_direct_32, tables):
    """The eye-row plain version, called as such, within the JAX interpret-mode
    kernel's tolerance (test_direct_plain_matches_jax_interpret_kernel)."""
    table, lt, area = tables
    counts = fi._new_counts()
    got = fi._render_direct_plain(table, lt, area, RenderConfig(width=32, height=32), 0, 1,
                                  counts=counts)
    assert counts["eye_rows"] == 20
    np.testing.assert_allclose(got.numpy(), jax_direct_32, **TOL["direct"])


@pytest.mark.parametrize("kind", ["ao", "direct"])
def test_plain_counts_20_eye_rows_on_the_cornell_box(tables, kind):
    """20 of the Cornell box's 36 rows face its camera's eye: what the bound counts."""
    table, lt, area = tables
    cfg = RenderConfig(width=4, height=4)
    counts = fi._new_counts()
    if kind == "ao":
        fi._render_ao_plain(table, cfg, 0, 1, counts=counts, lanes=1)
    else:
        fi._render_direct_plain(table, lt, area, cfg, 0, 1, counts=counts)
    assert table.shape[0] == 36 and counts["eye_rows"] == 20


def test_direct_lanes_and_route(tables):
    table, lt, _ = tables
    assert [fi.direct_lanes(n) for n in (1, 2, 3, 5, 8, 64)] == [1, 2, 4, 8, 8, 8]
    assert fi.direct_in_shared(table, lt)
    # The most rows AO stages: with the two lights the direct kernel reads globally.
    rows = (mk.SMEM_TABLE_MAX_BYTES - 16) // (mk.TABLE_COLS * 4 + 64)
    big = torch.zeros((rows, mk.TABLE_COLS))
    assert fi.ao_in_shared(big) and not fi.direct_in_shared(big, lt)
    assert fi.fast_smem_bytes(36, 2) == 36 * 160 + 2 * 64 + 16


@pytest.mark.parametrize("kind", ["ao", "direct"])
def test_wrappers_refuse_lanes_that_are_no_power_of_two_up_to_32(tables, kind):
    cfg = RenderConfig(width=4, height=4)
    for lanes in (0, 3, 64):
        with pytest.raises(ValueError, match="lanes"):
            _port(kind, tables, cfg, 0, 2, lanes=lanes)
    ok = _port(kind, tables, cfg, 0, 2, lanes=32)
    assert np.array_equal(ok, _port(kind, tables, cfg, 0, 2))
