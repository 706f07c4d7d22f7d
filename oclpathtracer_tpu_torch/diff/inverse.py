"""Inverse rendering: trainable scene parameters and train steps.

Counterpart of `oclpathtracer_tpu.diff.inverse`. The trainable subset of the scene
is a small NamedTuple (SceneParams) grafted back into the full Scene before each
forward render; gradients come from torch autograd through the batched integrator
(`integrators/path.py`, threefry streams): the material gathers and the
intersection geometry. `make_sharded_train_step` splits the pixels over a mesh
(`parallel/`) and adds the entries' gradients.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff.losses import l2_loss
from oclpathtracer_tpu_torch.integrators.path import render_sample
from oclpathtracer_tpu_torch.parallel import multihost
from oclpathtracer_tpu_torch.parallel.mesh import Mesh, tile_devices, tile_sharding
from oclpathtracer_tpu_torch.scene.types import Scene


class SceneParams(NamedTuple):
    """Trainable leaves. Any may be None → frozen at the scene's current value."""

    albedo: Optional[torch.Tensor] = None     # (M, 3)
    emissive: Optional[torch.Tensor] = None   # (M, 3)
    vertices: Optional[tuple] = None          # (p1, p2, p3) each (T, 3)
    roughness: Optional[torch.Tensor] = None  # (M,) GGX roughness


def params_leaves(params: SceneParams) -> list:
    """The set leaves in a fixed order: albedo, emissive, p1, p2, p3, roughness."""
    out = [params.albedo, params.emissive]
    out += list(params.vertices) if params.vertices is not None else [None] * 3
    out.append(params.roughness)
    return [x for x in out if x is not None]


def params_from_leaves(like: SceneParams, leaves) -> SceneParams:
    """`like` with its set leaves replaced, in params_leaves' order."""
    it = iter(leaves)

    def take(x):
        return None if x is None else next(it)

    albedo, emissive = take(like.albedo), take(like.emissive)
    vertices = None if like.vertices is None else tuple(take(v) for v in like.vertices)
    return SceneParams(albedo, emissive, vertices, take(like.roughness))


def extract_params(scene: Scene, albedo=True, emissive=False, vertices=False,
                   roughness=False) -> SceneParams:
    return SceneParams(
        albedo=scene.materials.albedo if albedo else None,
        emissive=scene.materials.emissive if emissive else None,
        vertices=(scene.geometry.p1, scene.geometry.p2, scene.geometry.p3)
        if vertices else None,
        roughness=scene.materials.roughness if roughness else None,
    )


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    """Graft trainable leaves back into the scene."""
    mats = scene.materials
    geom = scene.geometry
    if params.albedo is not None:
        mats = mats._replace(albedo=params.albedo)
    if params.emissive is not None:
        mats = mats._replace(emissive=params.emissive)
    if params.roughness is not None:
        mats = mats._replace(roughness=params.roughness)
    if params.vertices is not None:
        p1, p2, p3 = params.vertices
        geom = geom._replace(p1=p1, p2=p2, p3=p3)
    return scene._replace(materials=mats, geometry=geom)


def render_spp(scene: Scene, cfg: RenderConfig, spp: int, key: torch.Tensor,
               pixel_ids=None, base_sample: int = 0) -> torch.Tensor:
    """Mean of `spp` 1-spp samples, in sample order; differentiable."""
    n = cfg.n_pixels if pixel_ids is None else pixel_ids.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=key.device)
    for s in range(base_sample, base_sample + spp):
        radiance, _ = render_sample(scene, cfg, s, key, pixel_ids=pixel_ids)
        acc = acc + radiance
    return acc / spp


def make_loss_fn(scene: Scene, cfg: RenderConfig, spp: int) -> Callable:
    """loss(params, target, key, pixel_ids) with common-random-number rendering.

    Fixing `key` fixes the full sample set, so finite differences of this loss are
    well defined (no Monte-Carlo noise between two evaluations).
    """

    def loss(params: SceneParams, target, key, pixel_ids=None):
        img = render_spp(apply_params(scene, params), cfg, spp, key, pixel_ids)
        return l2_loss(img, target) / img.shape[0]

    return loss


def make_unbiased_loss_fn(scene: Scene, cfg: RenderConfig, spp: int) -> Callable:
    """Pairwise loss with unbiased value AND gradient: L = mean((A − t)·(B − t)) over
    two independent sample sets A, B (the key split in two). E[L] = ||E X − t||²/N,
    with no variance term for the gradient to chase (the JAX docstring derives it).
    """

    def loss(params: SceneParams, target, key, pixel_ids=None):
        ka, kb = rng.split(key)
        sc = apply_params(scene, params)
        a = render_spp(sc, cfg, spp, ka, pixel_ids)
        b = render_spp(sc, cfg, spp, kb, pixel_ids)
        return torch.mean((a - target) * (b - target))

    return loss


def value_and_grad(loss_fn, params: SceneParams, *args):
    """jax.value_and_grad(loss_fn)(params, *args) for SceneParams: (loss, SceneParams
    of gradients) by autograd over params' set leaves; a leaf the loss does not use
    gets zeros, as in JAX."""
    leaves = [x.detach().requires_grad_() for x in params_leaves(params)]
    loss = loss_fn(params_from_leaves(params, leaves), *args)
    return loss.detach(), params_from_leaves(params, grads_or_zeros(loss, leaves))


def grads_or_zeros(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for each leaf, as jax.grad gives them: zeros for a leaf the
    loss does not use, and for every leaf where it uses none (a 1-bounce render's
    loss does not depend on the vertices)."""
    if not loss.requires_grad:
        return [torch.zeros_like(x) for x in leaves]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]


def make_train_step(scene: Scene, cfg: RenderConfig, spp: int, lr: float):
    """Single-device SGD step: (params, target, step_idx, key) → (params, loss), on
    the CRN loss of sample key fold_in(key, step_idx)."""
    loss_fn = make_loss_fn(scene, cfg, spp)

    def step(params: SceneParams, target, step_idx, key):
        loss, grads = value_and_grad(loss_fn, params, target, rng.fold_in(key, step_idx))
        new = [p.detach() - lr * g for p, g in zip(params_leaves(params),
                                                   params_leaves(grads))]
        return params_from_leaves(params, new), loss

    return step


def _project_params(params: SceneParams) -> SceneParams:
    """Back to the physical ranges: albedo ∈ [0, 1], emissive ≥ 0, roughness ∈
    [1e-4, 1] (> 0: roughness 0 kills the GGX lobe's gradient)."""
    def clip(x, lo, hi=None):
        return None if x is None else torch.clamp(x, min=lo, max=hi)

    return params._replace(albedo=clip(params.albedo, 0.0, 1.0),
                           emissive=clip(params.emissive, 0.0),
                           roughness=clip(params.roughness, 1e-4, 1.0))


def make_optax_train_step(scene: Scene, cfg: RenderConfig, spp: int, optimizer,
                          clip01: bool = True, unbiased: bool = True):
    """Optimizer-driven step with a torch.optim optimizer.

    `optimizer` makes one from a list of tensors, e.g.
    `functools.partial(torch.optim.Adam, lr=5e-2)`. Returns (step, opt_init):
    opt_init(params) is the optimizer state (the optimizer, over its own copies of
    params' set leaves), and step(params, opt_state, target, step_idx, key) →
    (params, opt_state, loss). Each step loads `params` into the optimizer's
    tensors, so the returned params are values of their own, as in JAX. `clip01`
    projects albedo/emissive/roughness back into their physical ranges after the
    update; `unbiased` (default) trains on the pairwise two-sample loss.
    """
    loss_fn = (make_unbiased_loss_fn if unbiased else make_loss_fn)(scene, cfg, spp)

    def opt_init(params: SceneParams):
        return optimizer([x.detach().clone().requires_grad_()
                          for x in params_leaves(params)])

    def step(params: SceneParams, opt_state, target, step_idx, key):
        tensors = [t for group in opt_state.param_groups for t in group["params"]]
        with torch.no_grad():
            for t, p in zip(tensors, params_leaves(params)):
                t.copy_(p)
        loss = loss_fn(params_from_leaves(params, tensors), target,
                       rng.fold_in(key, step_idx))
        for t, g in zip(tensors, grads_or_zeros(loss, tensors)):
            t.grad = g
        opt_state.step()
        new = params_from_leaves(params, [t.detach().clone() for t in tensors])
        return (_project_params(new) if clip01 else new), opt_state, loss.detach()

    return step, opt_init


def make_sharded_train_step(scene: Scene, cfg: RenderConfig, mesh: Mesh, spp: int,
                            lr: float):
    """Mesh train step: pixels shard over 'tiles', params replicate, grads add.

    (params, target, pixel_ids, step_idx, key) → (params, loss). `target` (n, 3) and
    `pixel_ids` (n,) (shard_pixels' layout, n divisible by the mesh) split into the
    entries' blocks. Entry i renders its block on its own device, with its own
    replica of params' leaves, and takes d(local l2 sum / n_pixels)/d leaves; its
    graph is freed before the next entry renders. The losses and gradients are then
    added in mesh order on the first entry's device (JAX's psum; across processes
    one all_reduce of that sum), and the step is p − lr·g with no projection, as in
    JAX.
    """
    n_total = cfg.n_pixels
    devices = tile_devices(mesh)
    split = tile_sharding(mesh)
    dev0 = devices[0]

    def step(params: SceneParams, target: torch.Tensor, pixel_ids: torch.Tensor,
             step_idx: int, key: torch.Tensor):
        skey = rng.fold_in(key, step_idx)
        loss, grads = None, None
        for d, t, ids in zip(devices, split(target), split(pixel_ids)):
            leaves = [x.detach().to(d).requires_grad_() for x in params_leaves(params)]
            img = render_spp(apply_params(scene.to(d), params_from_leaves(params, leaves)),
                             cfg, spp, skey.to(d), ids)
            local = l2_loss(img, t) / n_total  # local sum / global count
            g = [x.to(dev0) for x in grads_or_zeros(local, leaves)]
            local = local.detach().to(dev0)
            loss = local if loss is None else loss + local
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss, *grads = multihost.all_reduce_sum([loss, *grads])
        new = [p.detach().to(dev0) - lr * g for p, g in zip(params_leaves(params), grads)]
        return params_from_leaves(params, new), loss

    return step
