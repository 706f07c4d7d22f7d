"""Training-step benchmark — the port's counterpart of the root `bench_train.py`.

    python -m oclpathtracer_tpu_torch.bench_train

Times one inverse-rendering step five ways on the Cornell box at SIZE², BOUNCES
bounces, SPP frames a render (target zeros, step index 0) and prints a JSON line
for each, with the root script's metric names and keys:

  train_step_kernel  — diff.fast.make_kernel_train_step: kernel forwards AND the
                       adjoint kernel's backward (`kernels/csrc/grad_megakernel.cu`);
  train_step_hybrid  — diff.fast.make_fast_loss_fn: megakernel forwards, autograd
                       through the reference-stream twin, SGD 1e-3;
  train_step_jnp     — diff.make_train_step: forward and backward through the batched
                       torch integrator (the twin step; the JAX name is kept so that
                       the lines compare);
  train_step_vertex_jnp    — diff.make_edge_aware_loss_fn, all of it through the twin,
                             SGD 1e-4 on the vertices;
  train_step_vertex_kernel — diff.make_vertex_train_step: megakernel forwards and
                             trace_rays probes (`kernels/csrc/trace_rays.cu`),
                             torch.optim.SGD 1e-4.

The first three report Mrays/s = traced segments the step processes / its best
time. The segments of one SPP-frame window are counted once, by the megakernel's
own tally on the reference streams (the adjoint kernel traces the same paths): the
kernel and hybrid steps make 4 sweeps of a window a step (2 forward, 2 backward),
the twin step 2. The vertex steps report ms/step. Each step is called once first
(which builds the kernels), then STEPS times; the best time on the host clock
counts, each call ending with a synchronize on its outputs
(`runtime.profiling.timed`).
"""

from __future__ import annotations

import functools
import json

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import edge, fast, inverse, vertex
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.runtime.profiling import timed
from oclpathtracer_tpu_torch.scene import load_cornell_box

SIZE = 256
BOUNCES = 4
SPP = 8
STEPS = 6
# The vertex steps' estimator quadrature: primary 64 samples an edge at 4 spp, the
# light's rim 16 an edge at 2 spp and pixel stride 4 (the root bench_train.py:128-131).
VERTEX_KW = dict(samples_per_edge=64, edge_spp=4, secondary_samples_per_edge=16,
                 secondary_spp=2, secondary_pixel_stride=4)


def segments_per_window(scene, cfg: RenderConfig, spp: int) -> int:
    """Traced segments of frames 0 .. spp-1, by the megakernel's own tally."""
    scan, table, emi, classes = mk.prepare_scan(scene, "auto")
    _, segs = mk.render_samples_pallas_stats(table, cfg, 0, spp, scan=scan, emi_const=emi,
                                             classes=classes)
    return int(segs)


def hybrid_step(scene, cfg: RenderConfig, spp: int, lr: float = 1e-3):
    """Autograd of make_fast_loss_fn (megakernel forward, twin backward), plain SGD:
    step(params, target, step_idx) → (params, loss)."""
    loss_fn = fast.make_fast_loss_fn(scene, cfg, spp)

    def step(params, target, step_idx):
        loss, g = inverse.value_and_grad(loss_fn, params, target, step_idx)
        return inverse.params_from_leaves(params, [
            p - lr * d for p, d in zip(inverse.params_leaves(params), inverse.params_leaves(g))
        ]), loss

    return step


def twin_step(scene, cfg: RenderConfig, spp: int, lr: float = 1e-3):
    """make_train_step on threefry key 0: step(params, target, step_idx)."""
    step = inverse.make_train_step(scene, cfg, spp, lr=lr)
    key = rng.make_key(0, scene.geometry.p1.device)
    return lambda params, target, step_idx: step(params, target, step_idx, key)


def vertex_steps(scene, cfg: RenderConfig, spp: int, lr: float = 1e-4) -> dict:
    """The two vertex steps on threefry key 0, SGD at `lr`: {"jnp", "kernel"} →
    step(params, target, step_idx) → (params, loss). "jnp" is autograd of
    make_edge_aware_loss_fn, all of it through the twin; "kernel" is
    make_vertex_train_step (interior_spp spp // 4) with torch.optim.SGD, its
    optimizer made at its first call."""
    key = rng.make_key(0, scene.geometry.p1.device)
    eloss = edge.make_edge_aware_loss_fn(scene, cfg, spp, **VERTEX_KW)

    def jnp_step(params, target, step_idx):
        loss, g = inverse.value_and_grad(eloss, params, target, key)
        return params._replace(vertices=tuple(
            a - lr * b for a, b in zip(params.vertices, g.vertices))), loss

    kstep, init = vertex.make_vertex_train_step(
        scene, cfg, spp, functools.partial(torch.optim.SGD, lr=lr),
        interior_spp=max(spp // 4, 1), **VERTEX_KW)
    state = []

    def kernel_step(params, target, step_idx):
        if not state:
            state.append(init(params))
        params, state[0], loss = kstep(params, state[0], target, step_idx, key)
        return params, loss

    return {"jnp": jnp_step, "kernel": kernel_step}


def time_steps(step, params, target, steps: int = STEPS):
    """(best seconds of `steps` calls after one untimed call, the last loss)."""
    (params, loss), _ = timed(step, params, target, 0)
    best = float("inf")
    for _ in range(steps):
        (params, loss), dt = timed(step, params, target, 0)
        best = min(best, dt)
    return best, float(loss)


def run(size: int = SIZE, bounces: int = BOUNCES, spp: int = SPP, steps: int = STEPS,
        device="cuda") -> list:
    """Time the five steps on the Cornell box on `device` (the card by default; "cpu"
    runs the kernels' plain versions) and print their JSON lines; returns them."""
    scene = load_cornell_box(device=device)
    cfg = RenderConfig(width=size, height=size, bounces=bounces)
    segs = segments_per_window(scene, cfg, spp)
    target = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=scene.geometry.p1.device)
    params = inverse.extract_params(scene, albedo=True, emissive=True)
    kstep = fast.make_kernel_train_step(scene, cfg, spp, lr=1e-3)

    results = {}
    for name, step, p0, sweeps in (
            ("kernel", kstep, fast.extract_class_params(scene), 4),
            ("hybrid", hybrid_step(scene, cfg, spp), params, 4),
            ("jnp", twin_step(scene, cfg, spp), params, 2)):
        dt, loss = time_steps(step, p0, target, steps)
        results[name] = (dt, sweeps * segs / dt / 1e6, loss)
    lines = [{"metric": f"train_step_{name}", "value": mrays, "unit": "Mrays/s",
              "step_seconds": dt, "loss": loss, "speedup_vs_jnp": results["jnp"][0] / dt}
             for name, (dt, mrays, loss) in results.items()]

    vparams = inverse.extract_params(scene, albedo=False, vertices=True)
    vsteps = vertex_steps(scene, cfg, spp)
    vtimes = {name: time_steps(vsteps[name], vparams, target, steps) for name in ("jnp", "kernel")}
    lines += [{"metric": f"train_step_vertex_{name}", "value": dt * 1e3, "unit": "ms/step",
               "loss": loss, "speedup_vs_vertex_jnp": vtimes["jnp"][0] / dt}
              for name, (dt, loss) in vtimes.items()]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def main() -> None:
    run()


if __name__ == "__main__":
    main()
