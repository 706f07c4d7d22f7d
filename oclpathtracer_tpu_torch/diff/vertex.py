"""Vertex training at kernel speed: kernel forwards AND kernel boundary probes.

Counterpart of `oclpathtracer_tpu.diff.vertex`. A step is assembled from:

  * forward renders: two parity megakernel launches (`kernels/megakernel.py`) on
    `pack_scene_table` of the current parameters, built on their device;
  * boundary terms: `diff/edge.py` (primary silhouettes) and `diff/secondary.py`
    (the light's rim) with their radiance probes sent through the arbitrary-ray
    kernel (`megakernel.trace_rays_pallas_stats`, `csrc/trace_rays.cu`): two
    launches for the edges and two per prefix depth for the rim;
  * interior terms: autograd through the twin (`integrators/parity.render_sample_ref`)
    at `interior_spp` frames, the one part with no kernel adjoint. In pure-diffuse
    scenes it is identically zero per sample, so `interior_spp=0` skips it.

The loss is the unbiased pairwise form on two disjoint reference-frame ranges
(diff/fast.make_fast_loss_fn), and the boundary weight ∂loss/∂I = (a + b − 2t)/n3
applies to both renders' expectations.

Spans: `vertex.step` over a whole step, in it `vertex.forward` (the two renders and
the loss), `vertex.interior` (the twin's autograd), `vertex.edges`, `vertex.rim` and
`vertex.update` (the optimizer). The counter `vertex.probe_rows` adds the rows of
every probe launch, a size known on the host.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff.edge import boundary_vertex_grads, rays_at
from oclpathtracer_tpu_torch.diff.fast import pack_scene_table
from oclpathtracer_tpu_torch.diff.inverse import (
    SceneParams,
    apply_params,
    grads_or_zeros,
    params_from_leaves,
    params_leaves,
)
from oclpathtracer_tpu_torch.diff.secondary import (
    emissive_tris,
    secondary_boundary_vertex_grads,
)
from oclpathtracer_tpu_torch.integrators.parity import render_sample_ref
from oclpathtracer_tpu_torch.kernels.megakernel import (
    render_samples_pallas_stats,
    trace_rays_pallas_stats,
)
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

PROBE_SAMPLE_BASE = 1 << 20  # probe streams start past the forward renders' frames
PROBE_STEP_STRIDE = 1024     # sample-range shift per step
SECONDARY_SAMPLE_OFFSET = 512


def make_kernel_probe_fns(table: torch.Tensor, cfg: RenderConfig, edge_spp: int,
                          secondary_spp: int, step_idx: int):
    """(edge_probe, secondary_probe) over the CURRENT scene table.

    CRN pairing holds because paired calls have the same rows (the kernel keys its
    streams on (row, sample)); step_idx shifts the sample range from step to step.
    The 2^20 offset keeps the probes' streams off the forward renders' frames (probe
    row ids coincide with pixel ids, so equal samples would correlate the loss
    weight with ΔL). Sample indices wrap mod 2^32, as the kernel's seed takes them.
    """
    base = PROBE_SAMPLE_BASE + int(step_idx) * PROBE_STEP_STRIDE

    def edge_probe(coords):
        o, d = rays_at(coords, cfg)
        profiling.count("vertex.probe_rows", o.shape[0])
        img, _ = trace_rays_pallas_stats(table, o.contiguous(), d, cfg, edge_spp,
                                         start_sample=base & 0xFFFFFFFF, scan="parity")
        return img / edge_spp

    def secondary_probe(o, d, rem, depth):
        # Depth k's probes take samples [base + 512 + k, ... + secondary_spp), so with
        # secondary_spp > 1 they overlap depth k + 1's. The JAX package does the same
        # (vertex.py:75); it is kept so that the two packages draw the same streams,
        # and recorded as a reference fault in ROADMAP queue 3.
        profiling.count("vertex.probe_rows", o.shape[0])
        img, _ = trace_rays_pallas_stats(
            table, o, d, cfg.with_(bounces=rem), secondary_spp,
            start_sample=(base + SECONDARY_SAMPLE_OFFSET + depth) & 0xFFFFFFFF, scan="parity")
        return img / secondary_spp

    return edge_probe, secondary_probe


def make_vertex_loss_and_grads(scene: Scene, cfg: RenderConfig, spp: int, *,
                               interior_spp: int | None = None, samples_per_edge: int = 64,
                               edge_spp: int = 4, delta: float = 0.05, secondary: bool = True,
                               secondary_samples_per_edge: int = 16, secondary_spp: int = 2,
                               secondary_delta: float = 0.01, secondary_depth: int = 1,
                               secondary_pixel_stride: int = 4):
    """loss_and_grads(params, target, step_idx, key) → (loss, SceneParams of
    gradients): make_vertex_train_step's step before the optimizer update."""
    if interior_spp is None:
        interior_spp = max(spp // 4, 1)
    n3 = cfg.n_pixels * 3
    # The rim set comes from the static base scene (a reference fault repaired: the
    # JAX package reads it from the traced parameters).
    sec_tris = emissive_tris(scene) if secondary else ()

    def twin_pair_loss(params: SceneParams, target, step_idx: int):
        sc = apply_params(scene, params)
        device = sc.geometry.p1.device

        def mean_frames(first):
            acc = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=device)
            for f in range(first, first + interior_spp):
                acc = acc + render_sample_ref(sc, cfg, f, device=device)
            return acc / interior_spp

        a = mean_frames((2 * step_idx) * spp)
        b = mean_frames((2 * step_idx + 1) * spp)
        return torch.mean((a - target) * (b - target))

    def loss_and_grads(params: SceneParams, target, step_idx: int, key):
        if params.vertices is None:
            raise ValueError("make_vertex_train_step needs params.vertices")
        step_idx = int(step_idx)
        leaves = [x.detach() for x in params_leaves(params)]
        params = params_from_leaves(params, leaves)
        with profiling.span("vertex.forward"), torch.no_grad():
            sc = apply_params(scene, params)
            table = pack_scene_table(sc)
            a, _ = render_samples_pallas_stats(table, cfg, (2 * step_idx) * spp, spp,
                                               scan="parity")
            b, _ = render_samples_pallas_stats(table, cfg, (2 * step_idx + 1) * spp, spp,
                                               scan="parity")
            a = a / spp
            b = b / spp
            loss = torch.mean((a - target) * (b - target))

        # Interior terms (every leaf) through the twin at interior_spp.
        if interior_spp > 0:
            ins = [x.detach().requires_grad_() for x in leaves]
            with profiling.span("vertex.interior"), torch.enable_grad():
                grads = grads_or_zeros(twin_pair_loss(params_from_leaves(params, ins), target,
                                                      step_idx), ins)
        else:
            grads = [torch.zeros_like(x) for x in leaves]
        grads = params_from_leaves(params, grads)

        # Boundary terms (vertices) with kernel probes.
        with torch.no_grad():
            weight = (a + b - 2.0 * target) / n3
            edge_probe, sec_probe = make_kernel_probe_fns(table, cfg, edge_spp, secondary_spp,
                                                          step_idx)
            skey = rng.fold_in(key, step_idx)
            with profiling.span("vertex.edges"):
                dp = boundary_vertex_grads(sc, cfg, weight, skey,
                                           samples_per_edge=samples_per_edge, spp=edge_spp,
                                           delta=delta, probe_fn=edge_probe)
            if sec_tris:
                with profiling.span("vertex.rim"):
                    sp = secondary_boundary_vertex_grads(
                        sc, cfg, weight, skey, tri_idx=sec_tris,
                        samples_per_edge=secondary_samples_per_edge, spp=secondary_spp,
                        delta=secondary_delta, max_prefix_depth=secondary_depth,
                        pixel_stride=secondary_pixel_stride, probe_fn=sec_probe)
                dp = tuple(x + y for x, y in zip(dp, sp))
        grads = grads._replace(vertices=tuple(v + x for v, x in zip(grads.vertices, dp)))
        return loss, grads

    return loss_and_grads


def make_vertex_train_step(scene: Scene, cfg: RenderConfig, spp: int, optimizer, **kw):
    """Kernel-speed vertex (and any other leaf) train step with a torch.optim optimizer.

    `optimizer` makes one from a list of tensors, e.g.
    `functools.partial(torch.optim.Adam, lr=1e-2)`; the keyword arguments are
    make_vertex_loss_and_grads' (`interior_spp` defaults to spp // 4, at least 1; 0
    skips the twin). Returns (step, opt_init): opt_init(params) is the optimizer over
    its own copies of params' set leaves, and step(params, opt_state, target,
    step_idx, key) → (params, opt_state, loss). Requires params.vertices; other
    leaves train through the interior term.
    """
    loss_and_grads = make_vertex_loss_and_grads(scene, cfg, spp, **kw)

    def opt_init(params: SceneParams):
        return optimizer([x.detach().clone() for x in params_leaves(params)])

    @profiling.spanned("vertex.step")
    def step(params: SceneParams, opt_state, target, step_idx, key):
        tensors = [t for group in opt_state.param_groups for t in group["params"]]
        loss, g = loss_and_grads(params, target, step_idx, key)
        with profiling.span("vertex.update"):
            with torch.no_grad():
                for t, p, gt in zip(tensors, params_leaves(params), params_leaves(g)):
                    t.copy_(p)
                    t.grad = gt
            opt_state.step()
        return params_from_leaves(params, [t.detach().clone() for t in tensors]), opt_state, loss

    return step, opt_init
