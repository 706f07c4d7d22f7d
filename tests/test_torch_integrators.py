"""The port's lower integrator rungs against the JAX package's: `occluded`, the
primary cast, AO and direct NEE (threefry and reference-stream twins), the direct
estimator's roughness gradient, and the CLI's new integrator choices.

Same inputs through both packages on the CPU (the Cornell box carried across with
convert.scene_from_numpy). Tolerances: `occluded` and the hit masks exactly; the
integrators allclose at rtol = atol = 1e-6 (both packages run the same f32
operations; XLA and torch may round a reduction or a transcendental differently
by an ulp); the roughness gradient within 1e-4 of its largest entry.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import intersect as jintersect
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.core.camera import generate_rays as jgenerate_rays
from oclpathtracer_tpu.diff.inverse import apply_params as japply_params
from oclpathtracer_tpu.diff.inverse import extract_params as jextract_params
from oclpathtracer_tpu.integrators import ao as jao
from oclpathtracer_tpu.integrators import direct as jdirect
from oclpathtracer_tpu.integrators import primary as jprimary
from oclpathtracer_tpu_torch import cli
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.core import intersect, rng
from oclpathtracer_tpu_torch.core.camera import generate_rays
from oclpathtracer_tpu_torch.diff.inverse import apply_params, extract_params
from oclpathtracer_tpu_torch.integrators import ao, direct, primary
from oclpathtracer_tpu_torch.scene.types import SPECULAR

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


def _cfgs(w, h, bounces=2):
    return RenderConfig(width=w, height=h, bounces=bounces), JCfg(width=w, height=h,
                                                                  bounces=bounces)


def _shadow_rays(n=400, seed=0):
    """Rays from points inside the box in seeded directions, and seeded t_max."""
    g = np.random.default_rng(seed)
    o = g.uniform((-0.8, 0.3, -1.5), (0.8, 2.5, 0.5), (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, g.uniform(0.05, 4.0, n).astype(np.float32)


@pytest.mark.parametrize("per_ray", [False, True])
def test_occluded_matches_jax_exactly(scene, port_scene, per_ray):
    o, d, t_max = _shadow_rays()
    tm = t_max if per_ray else 1.5
    want = np.asarray(jintersect.occluded(jnp.asarray(o), jnp.asarray(d), scene.geometry,
                                          jnp.asarray(tm) if per_ray else tm))
    got = intersect.occluded(torch.from_numpy(o), torch.from_numpy(d), port_scene.geometry,
                             torch.from_numpy(tm) if per_ray else tm).numpy()
    assert np.array_equal(got, want)
    assert 0.05 < want.mean() < 0.95  # both outcomes occur


def test_render_primary_matches_jax(scene, port_scene):
    cfg, jcfg = _cfgs(32, 24)
    np.testing.assert_allclose(primary.render_primary(port_scene, cfg).numpy(),
                               np.asarray(jprimary.render_primary(scene, jcfg)), **TOL)
    # The hit masks of the camera rays are equal.
    pid = np.arange(cfg.n_pixels)
    half = np.full(cfg.n_pixels, 0.5, np.float32)
    jo, jd = jgenerate_rays(jnp.asarray(pid % 32), jnp.asarray(pid // 32), 32, 24,
                            jnp.asarray(half), jnp.asarray(half), jcfg.camera)
    po, pd = generate_rays(torch.from_numpy(pid % 32), torch.from_numpy(pid // 32), 32, 24,
                           torch.from_numpy(half), torch.from_numpy(half), cfg.camera)
    assert np.array_equal(intersect.intersect_world(po, pd, port_scene.geometry).hit.numpy(),
                          np.asarray(jintersect.intersect_world(jo, jd, scene.geometry).hit))


def test_render_primary_with_pixel_ids_and_jitter(scene, port_scene):
    cfg, jcfg = _cfgs(16, 16)
    pid = np.arange(40, 140, dtype=np.int32)
    jit = np.random.default_rng(1).uniform(size=(100, 2)).astype(np.float32)
    got = primary.render_primary(port_scene, cfg, torch.from_numpy(pid).long(),
                                 torch.from_numpy(jit)).numpy()
    want = np.asarray(jprimary.render_primary(scene, jcfg, jnp.asarray(pid), jnp.asarray(jit)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("frame", [0, 5])
def test_ao_ref_twin_matches_jax(scene, port_scene, frame):
    cfg, jcfg = _cfgs(32, 32)
    got = ao.render_ao_sample_ref(port_scene, cfg, frame).numpy()
    want = np.asarray(jao.render_ao_sample_ref(scene, jcfg, frame))
    np.testing.assert_allclose(got, want, **TOL)
    assert 0.3 < want.mean() < 1.0  # partially occluded


@pytest.mark.parametrize("frame", [0, 5])
def test_direct_ref_twin_matches_jax(scene, port_scene, frame):
    cfg, jcfg = _cfgs(32, 32)
    got = direct.render_direct_sample_ref(port_scene, cfg, frame).numpy()
    want = np.asarray(jdirect.render_direct_sample_ref(scene, jcfg, frame))
    np.testing.assert_allclose(got, want, **TOL)
    assert want.mean() > 0.1  # lit


def test_ao_threefry_matches_jax(scene, port_scene):
    cfg, jcfg = _cfgs(16, 16)
    got = ao.render_ao(port_scene, cfg, rng.make_key(5, "cpu"), spp=3).numpy()
    want = np.asarray(jao.render_ao(scene, jcfg, jrng.make_key(5), spp=3))
    np.testing.assert_allclose(got, want, **TOL)
    pid = torch.arange(30, 90)
    one = ao.render_ao_sample(port_scene, cfg, 2, rng.make_key(5, "cpu"), pid).numpy()
    jone = np.asarray(jao.render_ao_sample(scene, jcfg, 2, jrng.make_key(5),
                                           jnp.arange(30, 90, dtype=jnp.int32)))
    np.testing.assert_allclose(one, jone, **TOL)


def test_direct_threefry_matches_jax(scene, port_scene):
    cfg, jcfg = _cfgs(16, 16)
    got = direct.render_direct(port_scene, cfg, rng.make_key(5, "cpu"), spp=3).numpy()
    want = np.asarray(jdirect.render_direct(scene, jcfg, jrng.make_key(5), spp=3))
    np.testing.assert_allclose(got, want, **TOL)
    pid = torch.arange(30, 90)
    one = direct.render_direct_sample(port_scene, cfg, 2, rng.make_key(5, "cpu"), pid).numpy()
    jone = np.asarray(jdirect.render_direct_sample(scene, jcfg, 2, jrng.make_key(5),
                                                   jnp.arange(30, 90, dtype=jnp.int32)))
    np.testing.assert_allclose(one, jone, **TOL)


def test_sample_lights_matches_jax(scene, port_scene):
    g = np.random.default_rng(3)
    us = g.uniform(size=(3, 500)).astype(np.float32)
    got = direct.sample_lights(port_scene, *(torch.from_numpy(u) for u in us))
    want = jdirect.sample_lights(scene, *(jnp.asarray(u) for u in us))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _with_spec_roughness_j(scene, r):
    rough = jnp.where(scene.materials.mtype == SPECULAR, r, scene.materials.roughness)
    return scene._replace(materials=scene.materials._replace(roughness=rough))


def _with_spec_roughness(scene, r):
    m = scene.materials
    rough = torch.where(m.mtype == SPECULAR, torch.tensor(r, dtype=torch.float32), m.roughness)
    return scene._replace(materials=m._replace(roughness=rough))


def test_direct_roughness_gradient_matches_jax_grad(scene, port_scene):
    """The loss of tests/test_diff.py's roughness test (sum of squares over pixels /
    n against 0.9 × a render on another key) at 16×16, 2 spp: autograd through the
    port's render_direct against jax.grad through the JAX package's."""
    cfg, jcfg = _cfgs(16, 16)
    n = cfg.n_pixels
    jsc = _with_spec_roughness_j(scene, 0.25)
    target = np.asarray(jdirect.render_direct(jsc, jcfg, jrng.make_key(7), spp=2)) * 0.9

    def jloss(p):
        img = jdirect.render_direct(japply_params(jsc, p), jcfg, jrng.make_key(3), spp=2)
        return jnp.sum((img - jnp.asarray(target)) ** 2) / n

    jp = jextract_params(jsc, albedo=False, roughness=True)
    jl, jg = jax.value_and_grad(jloss)(jp)
    want = np.asarray(jg.roughness)

    psc = _with_spec_roughness(port_scene, 0.25)
    params = extract_params(psc, albedo=False, roughness=True)
    rough = params.roughness.clone().requires_grad_(True)
    img = direct.render_direct(apply_params(psc, params._replace(roughness=rough)), cfg,
                               rng.make_key(3, "cpu"), spp=2)
    loss = torch.sum((img - torch.from_numpy(target)) ** 2) / n
    (got,) = torch.autograd.grad(loss, rough)
    got = got.numpy()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    scale = float(np.abs(want).max())
    assert scale > 1e-6 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("integrator", ["primary", "ao", "ao-pallas", "direct",
                                        "direct-pallas", "sorted"])
def test_cli_renders_the_new_integrators(tmp_path, capsys, integrator):
    out = str(tmp_path / "r.png")
    rc = cli.main(["render", "--device", "cpu", "--width", "16", "--height", "16",
                   "--spp", "2", "--bounces", "2", "--integrator", integrator, "-o", out])
    assert rc == 0 and os.path.getsize(out) > 0
    printed = capsys.readouterr().out
    assert f"integrator={integrator}" in printed
    mean = float(printed.split("mean=")[1].split()[0])
    assert np.isfinite(mean) and mean > 0.0

