"""Inverse rendering of GEOMETRY: recover a moved Cornell light by gradient descent
on vertex positions.

    python -m oclpathtracer_tpu_torch.examples.train_vertices [--steps 100] [--size 64]
        [--optimizer sgd] [--lr 2e-4] [--device cuda]

Plain autograd cannot do this: emission pickup is piecewise constant in the vertices
(GenerateColors.cl:241), so every vertex gradient lives in the visibility boundary
terms — the PRIMARY silhouette term (diff/edge.py) for the rim the camera sees and
the SECONDARY term (diff/secondary.py) for the rim seen from the bounce vertices.
`diff.vertex.make_vertex_train_step` runs the step on the kernels: megakernel
forwards, trace_rays boundary probes, and no twin interior term (the trainable subset
is the light quad of a diffuse scene, whose interior term is zero). The default, SGD
at 2e-4, is the run that recovers in both packages (`tests/vertex_recovery_vs_jax.py`
prints the two trajectories side by side).
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import extract_params, make_vertex_train_step
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.scene import load_cornell_box

LIGHT_TRIS = (10, 11)  # the ceiling light quad (RaytraceTest.cpp:147-153)
OPTIMIZERS = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}
RECOVERED = 0.6  # "most of the offset": the final error below this × the initial


def shifted_light(scene, shift: float):
    """Vertex params with the light quad moved `shift` in x (both triangles of each
    corner: the vertices are per-triangle soup rows)."""
    params = extract_params(scene, albedo=False, vertices=True)
    sel = torch.zeros((scene.num_triangles, 1), device=scene.geometry.p1.device)
    sel[list(LIGHT_TRIS)] = 1.0
    offset = torch.tensor([shift, 0.0, 0.0], device=sel.device)
    return params._replace(vertices=tuple(v + sel * offset for v in params.vertices))


def light_error(params, true_vertices) -> float:
    """Mean |Δ| over the light triangles' corners, averaged over p1, p2, p3."""
    rows = list(LIGHT_TRIS)
    return float(np.mean([float((v[rows] - t[rows]).abs().mean())
                          for v, t in zip(params.vertices, true_vertices)]))


def setup(scene, size: int, spp: int, optimizer, shift: float):
    """The recovery run at size², 2 bounces: (step, opt_init, the moved light's
    params, the target (the true scene's megakernel render over frames 0 ..
    2·spp − 1), the key, the true vertices). `optimizer` makes a torch.optim
    optimizer from a list of tensors."""
    cfg = RenderConfig(width=size, height=size, bounces=2)
    target, _ = mk.render_samples_pallas_stats(mk.pack_scene(scene), cfg, 0, 2 * spp,
                                               scan="parity")
    target = target / (2 * spp)
    true_v = extract_params(scene, albedo=False, vertices=True).vertices
    step, init = make_vertex_train_step(
        scene, cfg, spp, optimizer, interior_spp=0, samples_per_edge=48, edge_spp=4,
        secondary=True, secondary_samples_per_edge=16, secondary_spp=2,
        secondary_pixel_stride=4)
    key = rng.make_key(7, scene.geometry.p1.device)
    return step, init, shifted_light(scene, shift), target, key, true_v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--optimizer", choices=sorted(OPTIMIZERS), default="sgd")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--shift", type=float, default=0.3,
                    help="initial light x-offset (world units)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    scene = load_cornell_box(device=args.device)
    step, init, params, target, key, true_v = setup(
        scene, args.size, args.spp, functools.partial(OPTIMIZERS[args.optimizer], lr=args.lr),
        args.shift)
    state = init(params)
    err0 = light_error(params, true_v)
    print(f"initial light-vertex error: {err0:.4f} world units")
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, state, loss = step(params, state, target, i, key)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1:3d}  loss {float(loss):+.6f}  "
                  f"light err {light_error(params, true_v):.4f}")
    dt = time.perf_counter() - t0
    err = light_error(params, true_v)
    print(f"{args.steps} steps in {dt:.1f}s ({dt / args.steps * 1e3:.0f} ms/step): "
          f"light-vertex error {err0:.4f} -> {err:.4f}")
    if err < err0 * RECOVERED:
        print("recovered most of the light offset")
    return 0


if __name__ == "__main__":
    sys.exit(main())
