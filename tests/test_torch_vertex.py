"""The port's vertex train step (diff/vertex.py) against the JAX package's, and the
parameter carrier for vertices.

The JAX step runs its Pallas kernels (two forwards, the probes) in interpret mode,
too slow here; the reference below is the same step assembled from the JAX
package's public parts (vertex.py:120-159) with each kernel swapped for its twin:
render_sample_ref for the forwards, trace_paths on ref_uniforms for the probes.
The port runs its kernels' plain versions. The rule is test_torch_edge.py's: the loss
within rtol 1e-4, each gradient array within rtol 1e-4 and atol 1e-4·max|g|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.diff import edge as jedge
from oclpathtracer_tpu.diff import inverse as jinv
from oclpathtracer_tpu.diff import secondary as jsec
from oclpathtracer_tpu.integrators.parity import ref_uniforms, render_sample_ref
from oclpathtracer_tpu.integrators.path import trace_paths
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_params_from_numpy
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import extract_params, inverse, make_vertex_train_step, vertex
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels.selfcheck import occluder_arrays
from test_torch_edge import assert_grads_close, both_scenes

torch.set_num_threads(1)

SIZE, BOUNCES, SPP = 16, 2, 2
STEP_KW = dict(interior_spp=1, samples_per_edge=16, edge_spp=2, delta=0.03,
               secondary_samples_per_edge=8, secondary_spp=2, secondary_pixel_stride=4)


@pytest.fixture(scope="module")
def occluder():
    return both_scenes(occluder_arrays())


def _jax_twin_vertex_step(scene, cfg, spp, params, target, step_idx, key, interior_spp,
                          samples_per_edge, edge_spp, delta, secondary_samples_per_edge,
                          secondary_spp, secondary_pixel_stride):
    """JAX vertex.py:120-159 (loss_and_grads) with the kernels' twins."""
    n3 = cfg.n_pixels * 3
    sec_tris = jsec.emissive_tris(scene)

    def frames(sc, first, n):
        return sum(render_sample_ref(sc, cfg, f) for f in range(first, first + n)) / n

    def twin_pair_loss(p):
        sc = jinv.apply_params(scene, p)
        a = frames(sc, (2 * step_idx) * spp, interior_spp)
        b = frames(sc, (2 * step_idx + 1) * spp, interior_spp)
        return jnp.mean((a - target) * (b - target))

    sc = jinv.apply_params(scene, params)
    a = frames(sc, (2 * step_idx) * spp, spp)
    b = frames(sc, (2 * step_idx + 1) * spp, spp)
    loss = jnp.mean((a - target) * (b - target))
    grads = (jax.grad(twin_pair_loss)(params) if interior_spp > 0 else
             jax.tree.map(jnp.zeros_like, params))
    weight = (a + b - 2.0 * target) / n3
    base = (1 << 20) + step_idx * 1024

    def twin_probe(o, d, bounces, start, n_samples):
        rows = jnp.arange(o.shape[0], dtype=jnp.int32)
        acc = jnp.zeros(o.shape, jnp.float32)
        for s in range(n_samples):
            us = ref_uniforms(rows, start + s, 2 * bounces)
            acc = acc + trace_paths(o, d, sc, us.reshape(-1, bounces, 2), cfg)[0]
        return acc / n_samples

    def edge_probe(coords):
        o, d = jedge.rays_at(coords, cfg)
        return twin_probe(o, d, cfg.bounces, base, edge_spp)

    def sec_probe(o, d, rem, depth):
        return twin_probe(o, d, rem, base + 512 + depth, secondary_spp)

    skey = jax.random.fold_in(key, step_idx)
    dp = jedge.boundary_vertex_grads(sc, cfg, weight, skey, samples_per_edge=samples_per_edge,
                                     spp=edge_spp, delta=delta, probe_fn=edge_probe)
    sp = jsec.secondary_boundary_vertex_grads(
        sc, cfg, weight, skey, tri_idx=sec_tris, samples_per_edge=secondary_samples_per_edge,
        spp=secondary_spp, pixel_stride=secondary_pixel_stride, probe_fn=sec_probe)
    verts = tuple(v + x + y for v, x, y in zip(grads.vertices, dp, sp))
    return loss, grads._replace(vertices=verts)


def _shifted_vertices(params_vertices, shift=(0.15, 0.1, 0.0), row=2):
    """The occluder triangle (row 2) translated: each of p1, p2, p3 as numpy."""
    out = []
    for v in params_vertices:
        v = np.array(v, np.float32)
        v[row] += np.asarray(shift, np.float32)
        out.append(v)
    return out


def test_step_loss_and_grads_match_the_jax_step_on_twins(occluder):
    """One step at step index 1 (interior term on, albedo trained beside the
    vertices, secondary rim on: the backdrop is the emitter) against the JAX step
    on twins. Measured on a CPU: loss rel 8e-8, worst |Δ| 1.9e-6 of max|g| 14."""
    jscene, tscene = occluder
    cfg, jcfg = RenderConfig(SIZE, SIZE, bounces=BOUNCES), JCfg(width=SIZE, height=SIZE,
                                                               bounces=BOUNCES)
    target = np.random.default_rng(7).uniform(0, 3, (cfg.n_pixels, 3)).astype(np.float32)
    jp = jinv.extract_params(jscene, albedo=True, vertices=True)
    verts = _shifted_vertices(jp.vertices)
    jp = jp._replace(vertices=tuple(jnp.asarray(v) for v in verts))
    l_j, g_j = _jax_twin_vertex_step(jscene, jcfg, SPP, jp, jnp.asarray(target), 1,
                                     jrng.make_key(5), **STEP_KW)

    tp = scene_params_from_numpy(albedo=np.asarray(jp.albedo), vertices=verts, device="cpu")
    loss_and_grads = vertex.make_vertex_loss_and_grads(tscene, cfg, SPP, **STEP_KW)
    l_t, g_t = loss_and_grads(tp, torch.from_numpy(target), 1, rng.make_key(5, device="cpu"))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
    assert_grads_close(g_t.vertices, g_j.vertices)
    assert_grads_close([g_t.albedo], [g_j.albedo])
    assert float(np.abs(np.asarray(g_j.vertices[0])).max()) > 0


def test_vertex_train_step_runs_and_improves(occluder):
    """tests/test_diff_fast.py::test_vertex_train_step_runs_and_improves on the port:
    24², 2 bounces, spp 4, the occluder shifted by (0.15, 0.1, 0), four SGD(2e-3)
    steps on a fixed frame pair. The losses stay finite, the occluder moves, and the
    last loss is at most 1.05× the first."""
    _, tscene = occluder
    cfg = RenderConfig(24, 24, bounces=2)
    spp = 4
    target, _ = mk.render_samples_pallas_stats(mk.pack_scene(tscene), cfg, 0, 2 * spp,
                                               scan="parity")
    target = target / (2 * spp)
    params = extract_params(tscene, albedo=False, vertices=True)
    params = params._replace(vertices=tuple(
        torch.from_numpy(v) for v in _shifted_vertices([v.numpy() for v in params.vertices])))
    step, init = make_vertex_train_step(tscene, cfg, spp, functools.partial(torch.optim.SGD,
                                                                          lr=2e-3),
                                        interior_spp=0, samples_per_edge=32, edge_spp=2,
                                        secondary=False)
    state = init(params)
    key = rng.make_key(5, device="cpu")
    losses, p = [], params
    for _ in range(4):
        p, state, loss = step(p, state, target, 0, key)
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert float((p.vertices[0][2] - params.vertices[0][2]).abs().sum()) > 0.0
    assert losses[-1] <= losses[0] * 1.05, losses


def test_scene_params_carry_vertices_across(occluder):
    """convert.scene_params_from_numpy carries a JAX SceneParams with (shifted)
    vertices across: the same CRN loss from both packages (rtol 1e-5)."""
    jscene, tscene = occluder
    cfg, jcfg = RenderConfig(SIZE, SIZE, bounces=BOUNCES), JCfg(width=SIZE, height=SIZE,
                                                               bounces=BOUNCES)
    jp = jinv.extract_params(jscene, albedo=False, vertices=True)
    jp = jp._replace(vertices=tuple(jnp.asarray(v) for v in _shifted_vertices(jp.vertices)))
    tp = scene_params_from_numpy(*[None if x is None else
                                   (tuple(np.asarray(v) for v in x) if isinstance(x, tuple)
                                    else np.asarray(x)) for x in jp], device="cpu")
    assert tp.albedo is None and all(v.dtype == torch.float32 for v in tp.vertices)
    target = np.zeros((cfg.n_pixels, 3), np.float32)
    l_j = jinv.make_loss_fn(jscene, jcfg, SPP)(jp, jnp.asarray(target), jrng.make_key(2))
    l_t = inverse.make_loss_fn(tscene, cfg, SPP)(tp, torch.from_numpy(target),
                                                 rng.make_key(2, device="cpu"))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)
