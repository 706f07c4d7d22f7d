"""The port's threefry streams and the path integrator on them against the JAX
package's: keys and uniforms bit for bit, renders allclose with equal segments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.integrators import path as jpath
from oclpathtracer_tpu.render import driver as jdriver
from oclpathtracer_tpu_torch import cli
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.integrators import path
from oclpathtracer_tpu_torch.render import driver

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, 2**31, 2**32 + 5, -2**40]
SAMPLES = [0, 3, 4095, 65536, 10**6]
PIDS = np.array([0, 1, 255, 65535, 65536, 70001, 262143, 2**31 - 1], np.int32)
SIZE = 16
BOUNCES = 3


def _key_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_make_key_sample_key_and_split_bitwise(seed):
    kj, kt = jrng.make_key(seed), rng.make_key(seed, device="cpu")
    np.testing.assert_array_equal(kt.numpy(), _key_data(kj))
    np.testing.assert_array_equal(rng.split(kt).numpy(), _key_data(jax.random.split(kj)))
    for s in SAMPLES:
        np.testing.assert_array_equal(rng.sample_key(kt, s).numpy(),
                                      _key_data(jrng.sample_key(kj, jnp.int32(s))))


@pytest.mark.parametrize("seed", [0, 7, -1])
@pytest.mark.parametrize("sample", [0, 65536, 10**6])
def test_pixel_uniforms_bitwise(seed, sample):
    """Ids up to 2^31 - 1 (past 2^16, where a 16-bit slip would show), 10 draws."""
    sj = jrng.sample_key(jrng.make_key(seed), jnp.int32(sample))
    st = rng.sample_key(rng.make_key(seed, device="cpu"), sample)
    uj = np.asarray(jrng.pixel_uniforms(sj, jnp.asarray(PIDS), 10))
    ut = rng.pixel_uniforms(st, torch.from_numpy(PIDS.astype(np.int64)), 10)
    assert ut.dtype == torch.float32
    np.testing.assert_array_equal(ut.numpy(), uj)


def test_uniform_bits_cover_the_mantissa():
    """The float conversion at its ends: 0 bits → 0.0, all ones → 1 − 2^-23."""
    bits = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    assert rng.uniform_bits_to_float(bits).tolist() == [0.0, 1.0 - 2.0**-23]


def test_make_key_rejects_seeds_jax_cannot_hold():
    with pytest.raises(OverflowError):
        jrng.make_key(2**64)
    with pytest.raises(OverflowError):
        rng.make_key(2**64, device="cpu")


@pytest.mark.parametrize("sample", [0, 5])
def test_render_sample_matches_jax(scene, port_scene, sample):
    cfg_j = JCfg(width=SIZE, height=SIZE, bounces=BOUNCES)
    rad_j, st_j = jpath.render_sample(scene, cfg_j, jnp.int32(sample), jrng.make_key(3))
    rad_t, st_t = path.render_sample(port_scene, RenderConfig(SIZE, SIZE, bounces=BOUNCES),
                                     sample, rng.make_key(3, device="cpu"))
    np.testing.assert_allclose(rad_t.numpy(), np.asarray(rad_j), rtol=1e-4, atol=1e-4)
    assert int(st_t["segments"]) == int(st_j["segments"])


def test_render_sample_on_a_pixel_subset_matches_the_full_image(port_scene):
    cfg = RenderConfig(SIZE, SIZE, bounces=BOUNCES)
    key = rng.make_key(2, device="cpu")
    full, _ = path.render_sample(port_scene, cfg, 1, key)
    ids = torch.arange(37, 201, dtype=torch.int64)
    part, _ = path.render_sample(port_scene, cfg, 1, key, pixel_ids=ids)
    assert torch.equal(part, full[37:201])


def test_count_segments_matches_jax(scene, port_scene):
    got = path.count_segments(port_scene, RenderConfig(SIZE, SIZE, bounces=BOUNCES),
                              torch.arange(3), rng.make_key(4, device="cpu"))
    want = jpath.count_segments(scene, JCfg(width=SIZE, height=SIZE, bounces=BOUNCES),
                                jnp.arange(3, dtype=jnp.int32), jrng.make_key(4))
    assert int(got) == int(want)


def test_render_progressive_jnp_with_seed_and_sample_fn(scene, port_scene):
    """backend="jnp" keyed by `seed`, and a `sample_fn` (which forces that path):
    both against the JAX driver at rtol = atol = 1e-4."""
    kw = dict(seed=5, samples_per_step=2)
    img_j = jdriver.render_progressive(scene, JCfg(width=SIZE, height=SIZE, bounces=2), 4,
                                       **kw)
    img_t = driver.render_progressive(port_scene, RenderConfig(SIZE, SIZE, bounces=2), 4,
                                      **kw)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)

    def half(sc, cfg, s, key):
        rad, stats = path.render_sample(sc, cfg, s, key)
        return rad * 0.5, stats

    img_h = driver.render_progressive(port_scene, RenderConfig(SIZE, SIZE, bounces=2), 4,
                                      sample_fn=half, backend="pallas", **kw)
    np.testing.assert_allclose(img_h.numpy(), img_t.numpy() * 0.5, rtol=1e-6, atol=1e-6)


def test_cli_renders_the_path_integrator(tmp_path, capsys):
    out = str(tmp_path / "p.png")
    rc = cli.main(["render", "--device", "cpu", "--width", "8", "--height", "6", "--spp", "2",
                   "--bounces", "2", "--integrator", "path", "--seed", "3", "-o", out])
    assert rc == 0 and (tmp_path / "p.png").stat().st_size > 0
    assert "integrator=path" in capsys.readouterr().out
