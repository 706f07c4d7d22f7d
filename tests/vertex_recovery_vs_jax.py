"""examples/train_vertices.py's recovery run through the JAX package's vertex step and
through the port's, side by side on the CPU (a script, not a test).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/vertex_recovery_vs_jax.py \
        [--optimizer adam|sgd] [--lr 1e-2] [--steps 100] [--no-port]

The light quad (triangles 10 and 11) starts moved +0.3 in x; 64², 2 bounces, 8 spp,
no interior term, 48 samples per edge at 4 spp, the rim at 16 per edge, 2 spp,
pixel stride 4, key 7: the example's run. The JAX side is the package's own
`diff.vertex.make_vertex_train_step` with its two Pallas kernels swapped for their
twins inside that module (`render_sample_ref` for the forwards, `trace_paths` on
`ref_uniforms` for the probes), since the kernels in interpret mode take minutes a
step on a CPU. The port runs its kernels' plain versions. Prints the light-vertex
error (mean |Δ| over the light's corners) every 10 steps for each.
"""

from __future__ import annotations

import argparse
import functools
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.diff import extract_params as jextract_params
from oclpathtracer_tpu.diff import vertex as jvertex
from oclpathtracer_tpu.integrators.parity import ref_uniforms, render_sample_ref
from oclpathtracer_tpu.integrators.path import trace_paths
from oclpathtracer_tpu.scene import load_cornell_box as jload_cornell_box

LIGHT_TRIS = (10, 11)
SIZE, BOUNCES, SPP, SHIFT = 64, 2, 8, 0.3
STEP_KW = dict(interior_spp=0, samples_per_edge=48, edge_spp=4, secondary=True,
               secondary_samples_per_edge=16, secondary_spp=2, secondary_pixel_stride=4)


def _render_twin(scene, cfg, start, n, scan="parity"):
    """render_samples_pallas_stats' twin; `scene` stands where the table stood."""
    def body(acc, f):
        return acc + render_sample_ref(scene, cfg, f), None

    acc, _ = jax.lax.scan(body, jnp.zeros((cfg.n_pixels, 3), jnp.float32),
                          start + jnp.arange(n, dtype=jnp.int32))
    return acc, jnp.int32(0)


def _trace_rays_twin(scene, o, d, cfg, n, row_base=0, start_sample=0, scan="parity"):
    """trace_rays_pallas_stats' twin (tests/test_torch_trace_rays.py's reference)."""
    rows = jnp.arange(o.shape[0], dtype=jnp.int32) + row_base
    acc = jnp.zeros(o.shape, jnp.float32)
    for s in range(n):
        us = ref_uniforms(rows, start_sample + s, 2 * cfg.bounces)
        acc = acc + trace_paths(o, d, scene, us.reshape(-1, cfg.bounces, 2), cfg)[0]
    return acc, jnp.int32(0)


def light_error(vertices, true_vertices) -> float:
    rows = list(LIGHT_TRIS)
    return float(np.mean([np.abs(np.asarray(v)[rows] - np.asarray(t)[rows]).mean()
                          for v, t in zip(vertices, true_vertices)]))


def shifted(vertices, n_tris: int):
    sel = np.zeros((n_tris, 1), np.float32)
    sel[list(LIGHT_TRIS)] = 1.0
    return [np.asarray(v) + sel * np.asarray([SHIFT, 0.0, 0.0], np.float32) for v in vertices]


def run_jax(optimizer: str, lr: float, steps: int) -> list:
    scene = jload_cornell_box()
    cfg = JCfg(width=SIZE, height=SIZE, bounces=BOUNCES)
    with mock.patch.multiple(jvertex, pack_scene_table=lambda sc: sc,
                             render_samples_pallas_stats=_render_twin,
                             trace_rays_pallas_stats=_trace_rays_twin):
        target = _render_twin(scene, cfg, 0, 2 * SPP)[0] / (2 * SPP)
        params = jextract_params(scene, albedo=False, vertices=True)
        true_v = params.vertices
        params = params._replace(vertices=tuple(
            jnp.asarray(v) for v in shifted(true_v, scene.num_triangles)))
        opt = optax.adam(lr) if optimizer == "adam" else optax.sgd(lr)
        step, init = jvertex.make_vertex_train_step(scene, cfg, SPP, opt, **STEP_KW)
        state, key = init(params), jrng.make_key(7)
        errs = []
        for i in range(steps):
            params, state, _ = step(params, state, target, jnp.int32(i), key)
            if (i + 1) % 10 == 0:
                errs.append(light_error(params.vertices, true_v))
    return errs


def run_port(optimizer: str, lr: float, steps: int) -> list:
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.diff import extract_params, make_vertex_train_step
    from oclpathtracer_tpu_torch.kernels import megakernel as mk
    from oclpathtracer_tpu_torch.scene import load_cornell_box

    scene = load_cornell_box(device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES)
    target = mk.render_samples_pallas_stats(mk.pack_scene(scene), cfg, 0, 2 * SPP,
                                            scan="parity")[0] / (2 * SPP)
    params = extract_params(scene, albedo=False, vertices=True)
    true_v = [v.numpy() for v in params.vertices]
    params = params._replace(vertices=tuple(
        torch.from_numpy(v) for v in shifted(true_v, scene.num_triangles)))
    factory = functools.partial(torch.optim.Adam if optimizer == "adam" else torch.optim.SGD,
                                lr=lr)
    step, init = make_vertex_train_step(scene, cfg, SPP, factory, **STEP_KW)
    state, key = init(params), rng.make_key(7, device="cpu")
    errs = []
    for i in range(steps):
        params, state, _ = step(params, state, target, i, key)
        if (i + 1) % 10 == 0:
            errs.append(light_error([v.numpy() for v in params.vertices], true_v))
    return errs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--optimizer", choices=("adam", "sgd"), default="adam")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--no-port", action="store_true", help="run the JAX step only")
    args = ap.parse_args()
    print(f"{args.optimizer} {args.lr:g}, {args.steps} steps; light-vertex error from "
          f"{SHIFT / 3:.4f}, every 10 steps")
    runs = [("jax (twins)", run_jax)] + ([] if args.no_port else [("port (plain)", run_port)])
    for name, run in runs:
        t0 = time.perf_counter()
        errs = run(args.optimizer, args.lr, args.steps)
        print(f"{name}: {[round(e, 4) for e in errs]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)


if __name__ == "__main__":
    main()
