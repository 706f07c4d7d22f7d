"""Progressive render driver (counterpart of `oclpathtracer_tpu.render.driver`).

The host loops over S-sample chunks, folded into a linear accumulator on the device.
On the kernel backends each chunk is one kernel launch that returns the chunk's
per-pixel sum; on the "jnp" backend (the JAX default) a chunk is S samples of the
batched torch integrator on threefry streams. The accumulator plus the next sample
index is the checkpoint.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.integrators.path import render_sample
from oclpathtracer_tpu_torch.render import checkpoint as ckpt
from oclpathtracer_tpu_torch.render.accumulate import Accumulator
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

# Auto-backend rule, as in the JAX package (driver.py:27-42): the linear-scan
# kernels up to LINEAR_KERNEL_MAX_TRIS triangles, the 8-wide BVH kernel beyond,
# with leaf 32 up to WIDE_BVH_LEAF_SWITCH_TRIS and leaf 64 past it. Both numbers
# were measured on the JAX package's chip; they are kept so that the same call
# builds the same tree in both packages (PERF.md has this card's crossover).
LINEAR_KERNEL_MAX_TRIS = 480
WIDE_BVH_LEAF_SWITCH_TRIS = 12_000

# Past this bounce cap auto picks the path-regeneration kernel: mean paths are far
# shorter than the cap, so regeneration keeps more lanes busy.
MEGAKERNEL_MAX_BOUNCES = 8

# The skip-link walk's leaf size on the driver's "bvh" backend (the JAX driver's).
BVH_LEAF = 32


def make_render_step(cfg: RenderConfig, samples_per_step: int,
                     sample_fn: Optional[Callable] = None):
    """Build a step (Accumulator, Scene, start_sample, key) → Accumulator.

    `sample_fn(scene, cfg, sample_idx, key) -> (radiance, stats)` defaults to the
    threefry path integrator (`integrators/path.render_sample`), one sample at a time
    in sample order.
    """
    fn = sample_fn or render_sample

    def step(acc: Accumulator, scene: Scene, start_sample: int, key: torch.Tensor):
        for s in range(start_sample, start_sample + samples_per_step):
            radiance, _ = fn(scene, cfg, s, key)
            acc = acc.add(radiance)
        return acc

    return step


def make_kernel_render_step(scene: Scene, cfg: RenderConfig, samples_per_step: int,
                            backend: str = "auto", scan: str = "auto",
                            bvh_leaf: int = BVH_LEAF):
    """Build a step (Accumulator, start_sample) → Accumulator over one of the kernels.

    backend ∈ {auto, pallas, wavefront, bvh, widebvh}: auto picks the 8-wide BVH
    kernel ("widebvh") above LINEAR_KERNEL_MAX_TRIS triangles, else the megakernel
    ("pallas") up to MEGAKERNEL_MAX_BOUNCES and the path-regeneration kernel
    ("wavefront") beyond; "bvh" is the skip-link walk (leaf size `bvh_leaf`).
    "widebvh" on a tree deeper than the wide kernel's stack (wide_bvh.WIDE_MAX_DEPTH
    levels) renders with the skip-link kernel on the same build, which gives the
    same bits; the depth decides before any launch. scan ∈ {auto, parity, fast,
    tp}: auto is the fastest scan the scene's materials support, for every backend.
    The kernels use the reference RNG keyed by absolute (pixel, sample); there is no
    seed. The build is the span `driver.prepare`, each step `driver.step`.
    """
    with profiling.span("driver.prepare"):
        chunk = _kernel_chunk(scene, cfg, samples_per_step, backend, scan, bvh_leaf)

    @profiling.spanned("driver.step")
    def step(acc: Accumulator, start_sample: int) -> Accumulator:
        return acc.add_sum(chunk(start_sample), samples_per_step)

    return step


def _kernel_chunk(scene: Scene, cfg: RenderConfig, samples_per_step: int, backend: str,
                  scan: str, bvh_leaf: int):
    """make_kernel_render_step's build: the chunk start_sample → the SUM image of
    samples_per_step samples, on the picked kernel with its tables made."""
    from oclpathtracer_tpu_torch.kernels.megakernel import prepare_scan

    n_tris = int(scene.geometry.p1.shape[0])
    if backend == "auto":
        if n_tris > LINEAR_KERNEL_MAX_TRIS:
            backend = "widebvh"
        else:
            backend = "wavefront" if cfg.bounces > MEGAKERNEL_MAX_BOUNCES else "pallas"

    if backend == "pallas":
        from oclpathtracer_tpu_torch.kernels.megakernel import (
            render_samples_pallas_stats,
            tp0_table_for,
        )

        scan, table, emi, classes = prepare_scan(scene, scan)
        tp0_table = tp0_table_for(table, cfg, scan)

        def chunk(start):
            img, _ = render_samples_pallas_stats(table, cfg, start, samples_per_step,
                                                 scan=scan, classes=classes,
                                                 tp0_table=tp0_table, emi_const=emi)
            return img
    elif backend == "wavefront":
        from oclpathtracer_tpu_torch.kernels.wavefront import (
            render_samples_wavefront_stats,
            scan_table,
        )

        scan, table, emi, classes = prepare_scan(scene, scan)
        scan_tbl = scan_table(table, scan)

        def chunk(start):
            img, _ = render_samples_wavefront_stats(table, cfg, start, samples_per_step,
                                                    scan=scan, classes=classes,
                                                    emi_const=emi, scan_tbl=scan_tbl)
            return img
    elif backend == "widebvh":
        from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
        from oclpathtracer_tpu_torch.kernels.bvh_megakernel import resolve_bvh_scan
        from oclpathtracer_tpu_torch.kernels.megakernel import NO_EMI, scene_emissive_const

        leaf = 32 if n_tris <= WIDE_BVH_LEAF_SWITCH_TRIS else 64
        scan = resolve_bvh_scan(scene, scan)
        emi = scene_emissive_const(scene) if scan == "fast" else NO_EMI
        wtable, wn_f, wn_i, depth, classes = wb.pack_wide_bvh_scene(scene, leaf_size=leaf,
                                                                    scan=scan)
        if depth > wb.WIDE_MAX_DEPTH:
            # Deeper than the kernel's shared-memory stack: the skip-link kernel on the
            # same build gives the same bits and needs no stack.
            return _kernel_chunk(scene, cfg, samples_per_step, "bvh", scan, leaf)
        record = wb.group_record(wn_f, wn_i)

        def chunk(start):
            img, _ = wb.render_samples_wide_bvh_stats(wtable, wn_f, wn_i, cfg, start,
                                                      samples_per_step, max_leaf=leaf,
                                                      max_depth=depth, scan=scan,
                                                      emi_const=emi, classes=classes,
                                                      record=record)
            return img
    elif backend == "bvh":
        from oclpathtracer_tpu_torch.kernels.bvh_megakernel import (
            prepare_bvh_scan,
            render_samples_bvh_stats,
        )

        scan, table, nodes_f, nodes_i, emi, classes = prepare_bvh_scan(scene, scan,
                                                                       leaf_size=bvh_leaf)

        def chunk(start):
            img, _ = render_samples_bvh_stats(table, nodes_f, nodes_i, cfg, start,
                                              samples_per_step, max_leaf=bvh_leaf,
                                              scan=scan, emi_const=emi, classes=classes)
            return img
    else:
        raise ValueError(f"unknown kernel backend {backend!r}")
    return chunk


def render_progressive(scene: Scene, cfg: RenderConfig, total_spp: int,
                       seed: Optional[int] = None,
                       samples_per_step: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 0,
                       sample_fn: Optional[Callable] = None,
                       progress: Optional[Callable[[int], None]] = None,
                       backend: str = "jnp", scan: str = "auto") -> torch.Tensor:
    """Render `total_spp` samples progressively; returns the linear mean image (N, 3)
    on the scene's device.

    Resumes from `checkpoint_path` if it exists (the JAX package's format).
    backend: "jnp" (the default; the batched torch integrator `integrators/path.py`
    on threefry streams keyed by `seed`, else `cfg.seed`) or a kernel, "auto",
    "pallas", "wavefront", "bvh" or "widebvh" (make_kernel_render_step; reference
    RNG streams, `seed` ignored). `sample_fn` forces the "jnp" path.
    """
    spb = samples_per_step or max(cfg.samples_per_batch, 1)
    device = scene.geometry.p1.device
    key = rng.make_key(cfg.seed if seed is None else seed, device)

    start = 0
    acc = Accumulator.zeros(cfg.n_pixels, device)
    if checkpoint_path:
        loaded = ckpt.load(checkpoint_path, device)
        if loaded is not None:
            acc, start = loaded
    use_kernel = sample_fn is None and backend != "jnp"
    if use_kernel:
        step = make_kernel_render_step(scene, cfg, spb, backend, scan=scan)
    else:
        jnp_step = make_render_step(cfg, spb, sample_fn)

        def step(acc, s):
            return jnp_step(acc, scene, s, key)

    s = start
    while s < total_spp:
        acc = step(acc, s)
        s += spb
        if checkpoint_path and checkpoint_every and (s % checkpoint_every == 0):
            ckpt.save(checkpoint_path, acc, s)
        if progress is not None:
            progress(s)
    if checkpoint_path:
        ckpt.save(checkpoint_path, acc, s)
    return acc.mean()
