"""The port's boundary estimators (diff/edge.py, diff/secondary.py) and their
helpers against the JAX package's, on the same scenes, weights and keys.

The default probes are the twins on threefry streams, bit for bit JAX's, so the
gradients agree to float rounding. Each of dp1/dp2/dp3 is held within rtol 1e-4 and
atol 1e-4·max|g| (max over that array), the rule of every vertex-gradient test; the worst
case measured on a CPU is in each test's docstring. The helpers are held at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import brdf as jbrdf
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.diff import edge as jedge
from oclpathtracer_tpu.diff import inverse as jinv
from oclpathtracer_tpu.diff import secondary as jsec
from oclpathtracer_tpu.integrators.parity import ref_uniforms as jref_uniforms
from oclpathtracer_tpu.integrators.path import trace_paths as jtrace_paths
from oclpathtracer_tpu.scene import types as jtypes
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy, scene_params_from_numpy
from oclpathtracer_tpu_torch.core import brdf, rng
from oclpathtracer_tpu_torch.diff import edge, inverse, secondary
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels.selfcheck import occluder_arrays

torch.set_num_threads(1)

GRAD_RTOL = 1e-4
GRAD_ATOL_REL = 1e-4


def both_scenes(arrays):
    """(JAX Scene, port Scene on the CPU) from numpy leaves, e.g. occluder_arrays():
    tests/test_diff.py's occluder scene, whose loss's finite differences are pure
    primary boundary term."""
    g, m, lt = arrays
    jscene = jtypes.Scene(jtypes.Geometry(*map(jnp.asarray, g)),
                          jtypes.Materials(*map(jnp.asarray, m)),
                          jtypes.Lights(*map(jnp.asarray, lt)))
    return jscene, scene_from_numpy(g, m, lt, device="cpu")


def weight_for(n: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(n, 3)) / n).astype(np.float32)


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        g = g.detach().numpy()
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(np.abs(w).max()))


@pytest.fixture(scope="module")
def occluder():
    return both_scenes(occluder_arrays())


@pytest.fixture(scope="module")
def cornell(scene):
    return scene, scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene],
                                   device="cpu")


def test_eval_brdf_matches_jax():
    g = np.random.default_rng(3)

    def unit(n):
        v = g.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    n = 512
    wo, wi, nrm = unit(n), unit(n), unit(n)
    albedo = g.uniform(0, 1, (n, 3)).astype(np.float32)
    rough = g.uniform(0, 0.5, n).astype(np.float32)
    mty = g.integers(1, 3, n).astype(np.int32)
    args = (wo, wi, nrm, albedo, rough, mty)
    want = np.asarray(jbrdf.eval_brdf(*map(jnp.asarray, args)))
    got = brdf.eval_brdf(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (want == 0).any() and (want > 0).any()


def test_project_to_screen_and_rays_at_match_jax():
    cfg, jcfg = RenderConfig(width=24, height=16), JCfg(width=24, height=16)
    g = np.random.default_rng(4)
    pts = g.uniform([-3, -1, -6], [3, 6, 5], (400, 3)).astype(np.float32)
    c, valid = edge.project_to_screen(torch.from_numpy(pts), cfg)
    jc, jvalid = jedge.project_to_screen(jnp.asarray(pts), jcfg)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid)) and not valid.all()
    np.testing.assert_allclose(c.numpy()[valid.numpy()], np.asarray(jc)[np.asarray(jvalid)],
                               rtol=1e-6, atol=1e-6)
    coords = g.uniform([-2, -2], [26, 18], (400, 2)).astype(np.float32)
    o, d = edge.rays_at(torch.from_numpy(coords), cfg)
    jo, jd = jedge.rays_at(jnp.asarray(coords), jcfg)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


OCC_CFG = dict(width=16, height=16, bounces=2)
OCC_EDGE = dict(samples_per_edge=16, spp=2, delta=0.03)


def test_boundary_grads_twin_probes_match_jax(occluder):
    """The occluder at 16², 2 bounces, 16 samples per edge, spp 2, δ 0.03, with the
    default twin probes (threefry streams bit for bit JAX's). Measured on a CPU:
    worst |Δ| 6e-8 of max|g| 0.48."""
    jscene, tscene = occluder
    cfg, jcfg = RenderConfig(**OCC_CFG), JCfg(**OCC_CFG)
    w = weight_for(cfg.n_pixels)
    want = jedge.boundary_vertex_grads(jscene, jcfg, jnp.asarray(w), jrng.make_key(3),
                                       **OCC_EDGE)
    got = edge.boundary_vertex_grads(tscene, cfg, torch.from_numpy(w),
                                     rng.make_key(3, device="cpu"), **OCC_EDGE)
    assert_grads_close(got, want)
    assert float(np.abs(np.asarray(want[0])).max()) > 0


def test_boundary_grads_kernel_probes_match_jax(occluder):
    """The same estimator with kernel-style probes: the port's plain kernel 2 against
    a JAX probe built from its twin (trace_paths on ref_uniforms), rows keyed from 0,
    samples from 2^20. Measured on a CPU: worst |Δ| 1.8e-7 of max|g| 0.98."""
    jscene, tscene = occluder
    cfg, jcfg = RenderConfig(**OCC_CFG), JCfg(**OCC_CFG)
    w = weight_for(cfg.n_pixels, seed=1)
    spp, start = OCC_EDGE["spp"], 1 << 20
    table = mk.pack_scene(tscene)

    def probe(coords):
        o, d = edge.rays_at(coords, cfg)
        img, _ = mk.trace_rays_pallas_stats(table, o.contiguous(), d, cfg, spp,
                                            start_sample=start)
        return img / spp

    def jprobe(coords):
        o, d = jedge.rays_at(coords, jcfg)
        n = o.shape[0]
        rows = jnp.arange(n, dtype=jnp.int32)
        acc = jnp.zeros((n, 3), jnp.float32)
        for s in range(spp):
            us = jref_uniforms(rows, start + s, 2 * jcfg.bounces)
            acc = acc + jtrace_paths(o, d, jscene, us.reshape(n, jcfg.bounces, 2), jcfg)[0]
        return acc / spp

    want = jedge.boundary_vertex_grads(jscene, jcfg, jnp.asarray(w), jrng.make_key(3),
                                       probe_fn=jprobe, **OCC_EDGE)
    got = edge.boundary_vertex_grads(tscene, cfg, torch.from_numpy(w),
                                     rng.make_key(3, device="cpu"), probe_fn=probe, **OCC_EDGE)
    assert_grads_close(got, want)


@pytest.mark.parametrize("depth,stride", [(1, 1), (2, 2)])
def test_secondary_grads_match_jax(cornell, depth, stride):
    """The light's rim on the Cornell box at 8², 4 samples per edge, spp 1: depth 1,
    and depth 2 with pixel stride 2 (the prefix extension), at 3 bounces so that depth
    2 exists (the cap is bounces − 1). Twin probes, threefry streams bit for bit
    JAX's. Measured on a CPU: worst |Δ| 1.3e-8 of max|g| 0.027 (depth 1), 1.5e-7 of
    0.12 (depth 2)."""
    jscene, tscene = cornell
    cfg, jcfg = RenderConfig(8, 8, bounces=3), JCfg(width=8, height=8, bounces=3)
    w = weight_for(cfg.n_pixels, seed=2)
    kw = dict(samples_per_edge=4, spp=1, max_prefix_depth=depth, pixel_stride=stride)
    want = jsec.secondary_boundary_vertex_grads(jscene, jcfg, jnp.asarray(w), jrng.make_key(5),
                                                **kw)
    got = secondary.secondary_boundary_vertex_grads(tscene, cfg, torch.from_numpy(w),
                                                    rng.make_key(5, device="cpu"), **kw)
    assert secondary.emissive_tris(tscene) == jsec.emissive_tris(jscene) == (10, 11)
    assert_grads_close(got, want)
    assert float(np.abs(np.asarray(want[0])).max()) > 0


def test_edge_aware_loss_value_and_grads_match_jax(occluder):
    """make_edge_aware_loss_fn on the occluder at 16², 2 bounces, spp 4 (secondary on:
    the backdrop is the emitter): the loss and every vertex gradient against jax.grad
    of JAX's, and the target's gradient 2(t − img)/n. Measured on a CPU: worst |Δ|
    7.6e-6 of max|g| 42.9."""
    jscene, tscene = occluder
    cfg, jcfg = RenderConfig(**OCC_CFG), JCfg(**OCC_CFG)
    kw = dict(samples_per_edge=16, edge_spp=2, delta=0.03, secondary_samples_per_edge=8,
              secondary_spp=2)
    target = np.random.default_rng(6).uniform(0, 2, (cfg.n_pixels, 3)).astype(np.float32)
    jparams = jinv.extract_params(jscene, albedo=False, vertices=True)
    jloss = jedge.make_edge_aware_loss_fn(jscene, jcfg, 4, **kw)
    (l_j, (g_j, gt_j)) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jparams, jnp.asarray(target), jrng.make_key(3))

    tparams = scene_params_from_numpy(vertices=[np.asarray(v) for v in jparams.vertices],
                                      device="cpu")
    loss = edge.make_edge_aware_loss_fn(tscene, cfg, 4, **kw)
    tt = torch.from_numpy(target).requires_grad_()
    leaves = [x.requires_grad_() for x in inverse.params_leaves(tparams)]
    l_t = loss(inverse.params_from_leaves(tparams, leaves), tt, rng.make_key(3, device="cpu"))
    grads = torch.autograd.grad(l_t, [*leaves, tt])
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-5)
    assert_grads_close(grads[:3], g_j.vertices)
    np.testing.assert_allclose(grads[3].numpy(), np.asarray(gt_j), rtol=1e-4, atol=1e-7)
