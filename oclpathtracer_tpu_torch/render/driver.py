"""Progressive render driver (counterpart of `oclpathtracer_tpu.render.driver`).

The host loops over S-sample chunks; each chunk is one kernel launch that returns the
chunk's per-pixel sum, folded into a linear accumulator on the device. The
accumulator plus the next sample index is the checkpoint.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.render import checkpoint as ckpt
from oclpathtracer_tpu_torch.render.accumulate import Accumulator
from oclpathtracer_tpu_torch.scene.types import Scene

# Auto-backend rule, as in the JAX package (driver.py:84-96): the linear-scan
# kernels up to this many triangles, the 8-wide BVH kernel beyond. The crossover
# was measured on the JAX package's chip; the BVH kernels are not ported yet, so
# larger scenes raise until they are and the crossover is measured on this card.
LINEAR_KERNEL_MAX_TRIS = 480

# Past this bounce cap auto picks the path-regeneration kernel: mean paths are far
# shorter than the cap, so regeneration keeps more lanes busy.
MEGAKERNEL_MAX_BOUNCES = 8

_NOT_PORTED = {
    "widebvh": "ROADMAP queue 2 kernel 8 (kernels/wide_bvh.py)",
    "bvh": "ROADMAP queue 2 kernel 7 (kernels/bvh_megakernel.py)",
    "jnp": "ROADMAP queue 1 item 3 (the threefry render_sample path)",
}


def _not_ported(backend: str) -> NotImplementedError:
    return NotImplementedError(f"backend {backend!r} is not ported yet: {_NOT_PORTED[backend]}")


def make_kernel_render_step(scene: Scene, cfg: RenderConfig, samples_per_step: int,
                            backend: str = "auto", scan: str = "auto"):
    """Build a step (Accumulator, start_sample) → Accumulator over one of the kernels.

    backend ∈ {auto, pallas, wavefront}: auto picks the megakernel ("pallas") up to
    MEGAKERNEL_MAX_BOUNCES and the path-regeneration kernel ("wavefront") beyond.
    scan ∈ {auto, parity, tp} (megakernel.prepare_scan). The kernels use the
    reference RNG keyed by absolute (pixel, sample); there is no seed.
    """
    from oclpathtracer_tpu_torch.kernels.megakernel import prepare_scan

    n_tris = int(scene.geometry.p1.shape[0])
    if backend == "auto":
        if n_tris > LINEAR_KERNEL_MAX_TRIS:
            raise _not_ported("widebvh")
        backend = "wavefront" if cfg.bounces > MEGAKERNEL_MAX_BOUNCES else "pallas"

    if backend == "pallas":
        from oclpathtracer_tpu_torch.kernels.megakernel import (
            render_samples_pallas_stats,
            tp0_table_for,
        )

        scan, table, classes = prepare_scan(scene, scan)
        tp0_table = tp0_table_for(table, cfg, scan)

        def chunk(start):
            img, _ = render_samples_pallas_stats(table, cfg, start, samples_per_step,
                                                 scan=scan, classes=classes,
                                                 tp0_table=tp0_table)
            return img
    elif backend == "wavefront":
        from oclpathtracer_tpu_torch.kernels.wavefront import render_samples_wavefront_stats

        scan, table, classes = prepare_scan(scene, scan)

        def chunk(start):
            img, _ = render_samples_wavefront_stats(table, cfg, start, samples_per_step,
                                                    scan=scan, classes=classes)
            return img
    elif backend in _NOT_PORTED:
        raise _not_ported(backend)
    else:
        raise ValueError(f"unknown kernel backend {backend!r}")

    def step(acc: Accumulator, start_sample: int) -> Accumulator:
        return acc.add_sum(chunk(start_sample), samples_per_step)

    return step


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
    backend: "auto", "pallas" or "wavefront" (make_kernel_render_step). The JAX
    default "jnp" (threefry streams, `seed`) and `sample_fn` are not ported yet and
    raise NotImplementedError, so callers pass `backend` explicitly.
    """
    if sample_fn is not None or backend == "jnp":
        raise _not_ported("jnp")
    del seed  # the kernel backends use the reference's streams; no seed
    spb = samples_per_step or max(cfg.samples_per_batch, 1)
    device = scene.geometry.p1.device

    start = 0
    acc = Accumulator.zeros(cfg.n_pixels, device)
    if checkpoint_path:
        loaded = ckpt.load(checkpoint_path, device)
        if loaded is not None:
            acc, start = loaded
    step = make_kernel_render_step(scene, cfg, spb, backend, scan=scan)

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
