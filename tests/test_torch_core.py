"""The port's camera, intersection, BRDF and integrator twins against the JAX ones.

Hit ids must be equal; floats allclose at rtol=1e-5, atol=1e-6 (f32 ops, which may
be ordered differently by the two frameworks' reductions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import CameraConfig as JCam
from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import brdf as jbrdf
from oclpathtracer_tpu.core import camera as jcamera
from oclpathtracer_tpu.core import intersect as jintersect
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.integrators import path as jpath
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.core import brdf, camera, intersect
from oclpathtracer_tpu_torch.integrators import parity, path

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rays(n, seed):
    """Origins inside the box and unit directions, from numpy."""
    g = np.random.default_rng(seed)
    o = g.uniform([-2.5, 0.3, -5.3], [2.5, 5.2, -0.3], size=(n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("cam", [CameraConfig(), CameraConfig(eye=(0.3, 1.0, 3.0),
                                                             look=(0.1, -0.2, -1.0),
                                                             vfov_degrees=45.0)])
def test_generate_rays(cam):
    g = np.random.default_rng(1)
    w, h = 16, 12
    pid = np.arange(w * h)
    u1 = g.random(w * h, dtype=np.float32)
    u2 = g.random(w * h, dtype=np.float32)
    jcam = JCam(eye=cam.eye, look=cam.look, up=cam.up, vfov_degrees=cam.vfov_degrees)
    oj, dj = jcamera.generate_rays(jnp.asarray(pid % w), jnp.asarray(pid // w), w, h,
                                   jnp.asarray(u1), jnp.asarray(u2), jcam)
    ot, dt = camera.generate_rays(_t(pid % w), _t(pid // w), w, h, _t(u1), _t(u2), cam)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL, atol=ATOL)
    for a, b in zip(camera.basis(cam), jcamera.basis(jcam)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wh", [(16, 12), (33, 9)])
def test_pixel_grid_bitwise(wh):
    pid, px, py = camera.pixel_grid(*wh, device="cpu")
    for got, want in zip((pid, px, py), jcamera.pixel_grid(*wh)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_world(scene, port_scene, seed):
    o, d = _rays(2000, seed)
    rj = jintersect.intersect_world(jnp.asarray(o), jnp.asarray(d), scene.geometry)
    rt = intersect.intersect_world(_t(o), _t(d), port_scene.geometry)
    hit = np.asarray(rj.hit)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(rt.hit.numpy(), hit)
    np.testing.assert_array_equal(rt.tri_idx.numpy()[hit], np.asarray(rj.tri_idx)[hit])
    np.testing.assert_array_equal(rt.mat_id.numpy()[hit], np.asarray(rj.mat_id)[hit])
    for name in ("t", "point", "normal"):
        np.testing.assert_allclose(getattr(rt, name).numpy()[hit],
                                   np.asarray(getattr(rj, name))[hit], rtol=RTOL, atol=ATOL)


def test_sample_brdf(scene):
    g = np.random.default_rng(2)
    n = 1000
    nrm = g.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wo = g.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo = np.where((np.sum(wo * nrm, 1) < 0)[:, None], -wo, wo).astype(np.float32)
    albedo = g.uniform(0, 1, size=(n, 3)).astype(np.float32)
    rough = g.choice(np.array([0.0, 0.3, 0.6], np.float32), n)
    mtype = np.where(rough > 0, 2, 1).astype(np.int32)
    u1 = g.random(n, dtype=np.float32)
    u2 = g.random(n, dtype=np.float32)
    sj = jbrdf.sample_brdf(*(jnp.asarray(x) for x in (wo, nrm, albedo, rough, mtype, u1, u2)))
    st = brdf.sample_brdf(*(_t(x) for x in (wo, nrm, albedo, rough, mtype, u1, u2)))
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    for a, b in zip(brdf.tangent_frame(_t(nrm)), jbrdf.tangent_frame(jnp.asarray(nrm))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    cos = g.random(n, dtype=np.float32)
    np.testing.assert_allclose(brdf.distribution_ggx(_t(cos), _t(rough)).numpy(),
                               np.asarray(jbrdf.distribution_ggx(jnp.asarray(cos),
                                                                 jnp.asarray(rough))),
                               rtol=RTOL, atol=ATOL)


def test_trace_paths_twin(scene, port_scene):
    o, d = _rays(500, 3)
    g = np.random.default_rng(4)
    us = g.random((500, 3, 2), dtype=np.float32)
    jc, tc = JCfg(bounces=3), RenderConfig(bounces=3)
    for clamp in (True, False):
        rj, sj = jpath.trace_paths(jnp.asarray(o), jnp.asarray(d), scene, jnp.asarray(us),
                                   jc, clamp=clamp)
        rt, st = path.trace_paths(_t(o), _t(d), port_scene, _t(us), tc, clamp=clamp)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-4, atol=1e-4)
        assert int(st["segments"]) == int(sj["segments"])


def test_render_sample_ref_twin(scene, port_scene):
    jc = JCfg(width=16, height=16, bounces=2)
    tc = RenderConfig(width=16, height=16, bounces=2)
    rj = np.asarray(jparity.render_sample_ref(scene, jc, 3))
    rt = parity.render_sample_ref(port_scene, tc, 3)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-4, atol=1e-4)
    assert int(parity.count_segments_ref(port_scene, tc, [3, 4])) == int(
        jparity.count_segments_ref(scene, jc, jnp.arange(3, 5)))
