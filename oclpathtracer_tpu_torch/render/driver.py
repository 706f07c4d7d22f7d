"""Progressive render driver (counterpart of `oclpathtracer_tpu.render.driver`).

The host loops over S-sample chunks, folded into a linear accumulator on the device.
On the kernel backends a chunk is the picked kernel's `prepare_chunks` chunk, its
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
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wavefront as wf
from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
from oclpathtracer_tpu_torch.render import checkpoint as ckpt
from oclpathtracer_tpu_torch.render.accumulate import Accumulator
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.types import Scene

# Auto-backend rule: the linear-scan kernels up to LINEAR_KERNEL_MAX_TRIS triangles
# (the JAX package's crossover, driver.py:27-33), the 8-wide BVH kernel beyond. The
# 8-wide tree's leaf (`wide_leaf`, on the "widebvh" backend too) was measured on an
# NVIDIA H100 (PERF.md §6, the leaf sweep: one 64-spp launch at 512², 16 bounces, on
# sphere_field scenes of 564 to 102,404 triangles). WIDE_BVH_LEAF was picked at
# 102,404 triangles, where it is the fastest and takes 0.51 times leaf 64's time;
# from 964 to 40,964 triangles it is within about 8 % of the fastest leaf. Up to
# WIDE_BVH_LEAF_SWITCH_TRIS triangles WIDE_BVH_SMALL_LEAF is the fastest (leaf 6
# takes 4-14 % longer at 564 and 804). Below the auto route's range only an explicit
# "widebvh" builds the tree, at WIDE_BVH_TINY_LEAF: on the Cornell box (36
# triangles) leaf 16 takes 8 % longer and leaf 6 55 %. The leaf only schedules the
# walk: a ray's nearest hit moves only where two triangles tie and the walk visits
# them in another order.
LINEAR_KERNEL_MAX_TRIS = 480
WIDE_BVH_LEAF_SWITCH_TRIS = 900
WIDE_BVH_TINY_LEAF = 32
WIDE_BVH_SMALL_LEAF = 16
WIDE_BVH_LEAF = 6

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
                            backend: str = "auto", scan: str = "auto"):
    """Build a step (Accumulator, start_sample) → Accumulator that adds prepare_chunks'
    chunk of samples_per_step samples. The kernels key the reference RNG on absolute
    (pixel, sample): no seed. The build is the span `driver.prepare`, a step
    `driver.step`."""
    with profiling.span("driver.prepare"):
        chunk = prepare_chunks(scene, cfg, backend, scan)

    @profiling.spanned("driver.step")
    def step(acc: Accumulator, start_sample: int) -> Accumulator:
        return acc.add_sum(chunk(start_sample, samples_per_step)[0], samples_per_step)

    return step


def wide_leaf(n_tris: int) -> int:
    """The 8-wide tree's leaf size for a scene of n_tris triangles."""
    if n_tris <= LINEAR_KERNEL_MAX_TRIS:
        return WIDE_BVH_TINY_LEAF
    return WIDE_BVH_SMALL_LEAF if n_tris <= WIDE_BVH_LEAF_SWITCH_TRIS else WIDE_BVH_LEAF


def prepare_chunks(scene: Scene, cfg: RenderConfig, backend: str = "auto",
                   scan: str = "auto"):
    """The picked kernel's prepare_chunks: its tables, made once, and its chunk (start,
    n) → (SUM image (n_pixels, 3), segments () int64). backend ∈ {auto, pallas,
    wavefront, bvh, widebvh}: auto picks "widebvh" (the 8-wide BVH kernel) above
    LINEAR_KERNEL_MAX_TRIS triangles, else "pallas" (the megakernel) up to
    MEGAKERNEL_MAX_BOUNCES and "wavefront" (path regeneration) beyond; "bvh" is the
    skip-link walk at BVH_LEAF, "widebvh" the 8-wide one at wide_leaf, which renders a
    tree deeper than its stack with the skip-link kernel on the same build (the same
    bits). scan ∈ {auto, parity, fast, tp}: auto is the fastest scan the scene's
    materials support."""
    n_tris = int(scene.geometry.p1.shape[0])
    if backend == "auto":
        if n_tris > LINEAR_KERNEL_MAX_TRIS:
            backend = "widebvh"
        else:
            backend = "wavefront" if cfg.bounces > MEGAKERNEL_MAX_BOUNCES else "pallas"
    prepares = {"pallas": mk.prepare_chunks, "wavefront": wf.prepare_chunks,
                "bvh": lambda *a: bk.prepare_chunks(*a, leaf_size=BVH_LEAF),
                "widebvh": lambda *a: wb.prepare_chunks(*a, leaf_size=wide_leaf(n_tris))}
    if backend not in prepares:
        raise ValueError(f"unknown kernel backend {backend!r}")
    return prepares[backend](scene, cfg, scan)


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
