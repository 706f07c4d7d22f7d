"""Fast differentiable rendering: kernel forwards, with gradients from the twin or
from the adjoint kernel.

Counterpart of `oclpathtracer_tpu.diff.fast`. Two routes:

* the hybrid (`make_fast_renderer`, `make_fast_loss_fn`): a torch.autograd.Function
  whose forward is the parity megakernel (`kernels/megakernel.py`) and whose
  backward is autograd through the reference-stream twin
  (`integrators/parity.render_sample_ref`), which computes the same function of the
  parameters. Any SceneParams leaf trains this way.
* the kernel step (`make_kernel_train_step`, `make_kernel_optax_step`): material
  CLASS attributes (ClassParams) with forward AND backward in the adjoint kernel
  (`kernels/grad_megakernel.py`). A step is two forward launches and two adjoint
  launches, and never copies parameters to the host.

`make_sharded_kernel_train_step` is the kernel step over a mesh (`parallel/`): each
entry runs the four launches on its range of absolute pixel ids, and the class
gradients are added in mesh order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.diff.inverse import (
    SceneParams,
    apply_params,
    params_from_leaves,
    params_leaves,
)
from oclpathtracer_tpu_torch.integrators.parity import render_sample_ref
from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk
from oclpathtracer_tpu_torch.kernels.megakernel import pack_scene, render_samples_pallas_stats
from oclpathtracer_tpu_torch.parallel.mesh import tile_devices
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

# The JAX package's device-side packer; megakernel.pack_scene already packs on the
# scene's device, so the name is kept for readers of that package.
pack_scene_table = pack_scene


def make_fast_renderer(scene: Scene, cfg: RenderConfig, n_samples: int):
    """(render, twin): render(params, start_sample) → MEAN image over n_samples
    reference-stream frames. Forward: the parity megakernel (its plain version on
    CPU tensors). Backward: autograd through the twin, `twin(params, start_sample)`.
    """

    def twin(params: SceneParams, start_sample: int) -> torch.Tensor:
        sc = apply_params(scene, params)
        device = sc.geometry.p1.device
        acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=device)
        for f in range(start_sample, start_sample + n_samples):
            acc = acc + render_sample_ref(sc, cfg, f, device=device)
        return acc / n_samples

    class _Render(torch.autograd.Function):
        @staticmethod
        def forward(ctx, start_sample, like, *leaves):
            ctx.start_sample, ctx.like = start_sample, like
            ctx.save_for_backward(*leaves)
            table = pack_scene_table(apply_params(scene, params_from_leaves(like, leaves)))
            img, _ = render_samples_pallas_stats(table.contiguous(), cfg, start_sample,
                                                 n_samples, scan="parity")
            return img / n_samples

        @staticmethod
        def backward(ctx, g):
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            with torch.enable_grad():
                img = twin(params_from_leaves(ctx.like, leaves), ctx.start_sample)
                grads = torch.autograd.grad(img, leaves, g, allow_unused=True)
            return (None, None, *grads)

    def render(params: SceneParams, start_sample: int) -> torch.Tensor:
        return _Render.apply(int(start_sample), params, *params_leaves(params))

    return render, twin


def make_fast_loss_fn(scene: Scene, cfg: RenderConfig, spp: int):
    """Unbiased pairwise loss with kernel forwards: loss(params, target, step_idx).

    The two independent sample sets are two disjoint reference-frame ranges,
    selected by step index: frames [2k·spp, (2k+1)·spp) and [(2k+1)·spp, (2k+2)·spp).
    """
    render, _ = make_fast_renderer(scene, cfg, spp)

    def loss(params: SceneParams, target, step_idx: int):
        a = render(params, (2 * step_idx) * spp)
        b = render(params, (2 * step_idx + 1) * spp)
        return torch.mean((a - target) * (b - target))

    return loss


class ClassParams(NamedTuple):
    """Trainable material-CLASS attributes (the kernel train path): the adjoint
    kernel differentiates w.r.t. the ≤16 classes its scan tracks; materials that
    share a class train jointly (the Cornell box: 5 classes for 18 records)."""

    albedo: torch.Tensor    # (C, 3)
    emissive: torch.Tensor  # (C, 3)


def extract_class_params(scene: Scene) -> ClassParams:
    _, ct, _, _ = gk.prepare_grad_scene(scene)
    return ClassParams(albedo=ct[:, 0:3], emissive=ct[:, 3:6])


def class_params_to_materials(scene: Scene, params: ClassParams) -> SceneParams:
    """Broadcast class attributes back to per-material SceneParams."""
    _, _, _, mat_class = gk.prepare_grad_scene(scene)
    return SceneParams(albedo=params.albedo[mat_class], emissive=params.emissive[mat_class])


def _pair_and_grads(table, ct, cfg: RenderConfig, spp: int, n_classes: int, target,
                    step_idx: int, n3: int, pid_base: int = 0, n_rays=None):
    """The pairwise loss's two MEAN images a, b over pixels [pid_base, pid_base +
    n_rays) and the class gradients g (C, 6) of the loss over n3 values.

    Two dynamic-class forwards on the frame ranges [2k·spp, (2k+1)·spp) and
    [(2k+1)·spp, (2k+2)·spp), then two adjoint launches weighted by ∂loss/∂(frame-SUM
    image) of each render: (b − t)/(n3·spp) and (a − t)/(n3·spp). The forwards and
    the weights are the span `train.forward`, the adjoints `train.backward`.
    """
    fa = (2 * step_idx) * spp
    fb = (2 * step_idx + 1) * spp
    span = dict(pid_base=pid_base, n_rays=n_rays)
    with profiling.span("train.forward"):
        a, _ = gk.render_grads_pallas(table, ct, cfg, fa, spp, n_classes, with_grads=False,
                                      **span)
        b, _ = gk.render_grads_pallas(table, ct, cfg, fb, spp, n_classes, with_grads=False,
                                      **span)
        a = a / spp
        b = b / spp
        w_a = (b - target) / (n3 * spp)
        w_b = (a - target) / (n3 * spp)
    with profiling.span("train.backward"):
        _, ga = gk.render_grads_pallas(table, ct, cfg, fa, spp, n_classes, weight=w_a,
                                       **span)
        _, gb = gk.render_grads_pallas(table, ct, cfg, fb, spp, n_classes, weight=w_b,
                                       **span)
        g = ga + gb
    return a, b, g


def _kernel_loss_and_grads(scene: Scene, cfg: RenderConfig, spp: int):
    """(params, target, step_idx) → (loss, ClassParams of gradients): the pairwise
    loss through the adjoint kernel (`_pair_and_grads`), shared by the SGD and
    optimizer steps."""
    table, ct0, n_classes, _ = gk.prepare_grad_scene(scene)
    n3 = cfg.n_pixels * 3

    def loss_and_grads(params: ClassParams, target, step_idx: int):
        ct = torch.cat([params.albedo, params.emissive, ct0[:, 6:8]], dim=1)
        a, b, g = _pair_and_grads(table, ct, cfg, spp, n_classes, target, step_idx, n3)
        loss = torch.mean((a - target) * (b - target))
        return loss, ClassParams(albedo=g[:, 0:3], emissive=g[:, 3:6])

    return loss_and_grads


def _project_class(params: ClassParams) -> ClassParams:
    """Back to the physical domain (albedo ∈ [0, 1], emissive ≥ 0), under which the
    adjoint's right-sided derivative at the boundary is the right gradient."""
    return ClassParams(albedo=torch.clamp(params.albedo, 0.0, 1.0),
                       emissive=torch.clamp(params.emissive, min=0.0))


def make_kernel_train_step(scene: Scene, cfg: RenderConfig, spp: int, lr: float):
    """SGD step with kernel forwards AND the adjoint kernel's backward:
    (params: ClassParams, target, step_idx) → (params, loss). Needs
    tp_scan_supported(scene). Spans: `train.step`, over `_pair_and_grads`'
    `train.forward` and `train.backward`, and `train.update` (the step and the
    projection; the loss, in `_kernel_loss_and_grads`, is the step's own time)."""
    loss_and_grads = _kernel_loss_and_grads(scene, cfg, spp)

    @profiling.spanned("train.step")
    def step(params: ClassParams, target, step_idx: int):
        loss, g = loss_and_grads(params, target, step_idx)
        with profiling.span("train.update"):
            params = _project_class(ClassParams(albedo=params.albedo - lr * g.albedo,
                                                emissive=params.emissive - lr * g.emissive))
        return params, loss

    return step


def make_kernel_optax_step(scene: Scene, cfg: RenderConfig, spp: int, optimizer):
    """Optimizer-driven kernel train step with a torch.optim optimizer (made from a
    list of tensors, as in inverse.make_optax_train_step).

    Returns (step, opt_init): step(params, opt_state, target, step_idx) →
    (params, opt_state, loss), with the adjoint kernel's gradients. Adam-style
    preconditioning handles the spread of class gradient scales (walls see about
    100× the gradient of small faces).
    """
    loss_and_grads = _kernel_loss_and_grads(scene, cfg, spp)

    def opt_init(params: ClassParams):
        return optimizer([x.detach().clone() for x in params])

    def step(params: ClassParams, opt_state, target, step_idx: int):
        tensors = [t for group in opt_state.param_groups for t in group["params"]]
        loss, g = loss_and_grads(params, target, step_idx)
        with torch.no_grad():
            for t, p, gt in zip(tensors, params, g):
                t.copy_(p)
                t.grad = gt
        opt_state.step()
        params = _project_class(ClassParams(*(t.detach().clone() for t in tensors)))
        return params, opt_state, loss

    return step, opt_init


def make_sharded_kernel_train_step(scene: Scene, cfg: RenderConfig, mesh, spp: int,
                                   lr: float):
    """make_kernel_train_step over a 'tiles' mesh: pixels shard, class grads add.

    (params, target, step_idx) → (params, loss), `target` the full (n_pixels, 3)
    image. Entry i runs the step's four launches (`_pair_and_grads`) on its own
    device over pixels [i·n/m, (i+1)·n/m) (pid_base, n_rays), so its images are bit
    for bit those rows of the single call's. The loss is the entries' sums of
    (a − t)(b − t), added in mesh order, over the GLOBAL n_pixels·3; the gradients
    are the entries' ga + gb added in mesh order on the first entry's device (JAX's
    psum), then the step projects as make_kernel_train_step does. The mesh is this
    process's: its entries' ranges cover the whole image. No float atomic adds
    anything: the adjoint kernel sums its block partials in a fixed order, and the
    entries add in mesh order.
    """
    table, ct0, n_classes, _ = gk.prepare_grad_scene(scene)
    devices = tile_devices(mesh)
    if cfg.n_pixels % len(devices) != 0:
        raise ValueError(f"{cfg.n_pixels} pixels not divisible by {len(devices)}")
    local_n = cfg.n_pixels // len(devices)
    n3 = cfg.n_pixels * 3
    dev0 = devices[0]
    on = {d: (table.to(d), ct0[:, 6:8].to(d)) for d in devices}

    def step(params: ClassParams, target, step_idx: int):
        loss, g = None, None
        for i, d in enumerate(devices):
            tb, rest = on[d]
            ct = torch.cat([params.albedo.to(d), params.emissive.to(d), rest], dim=1)
            t = target[i * local_n:(i + 1) * local_n].to(d)
            a, b, gi = _pair_and_grads(tb, ct, cfg, spp, n_classes, t, step_idx, n3,
                                       pid_base=i * local_n, n_rays=local_n)
            part = torch.sum((a - t) * (b - t)).to(dev0)
            loss = part if loss is None else loss + part
            g = gi.to(dev0) if g is None else g + gi.to(dev0)
        params = _project_class(ClassParams(albedo=params.albedo - lr * g[:, 0:3],
                                            emissive=params.emissive - lr * g[:, 3:6]))
        return params, loss / n3

    return step
