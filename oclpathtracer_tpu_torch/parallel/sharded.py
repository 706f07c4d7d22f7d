"""Tile-sharded progressive rendering with the batched integrator.

Counterpart of `oclpathtracer_tpu.parallel.sharded`. Entry i of the mesh renders
the i-th contiguous block of ABSOLUTE pixel ids on its own device; the scene and
key are replicated; the forward render has no communication at all, and assembly
of the full image is a concatenation on the first entry's device. Sample streams
do not depend on the layout, because every uniform is keyed by the absolute pixel
id (`core/rng.py`), so a sharded render is bit for bit the single-device one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.integrators.path import render_sample
from oclpathtracer_tpu_torch.parallel.mesh import Mesh, tile_devices, tile_sharding
from oclpathtracer_tpu_torch.render.accumulate import Accumulator
from oclpathtracer_tpu_torch.scene.types import Scene


def padded_pixel_count(n_pixels: int, n_dev: int) -> int:
    """n_pixels rounded up to a multiple of n_dev (the sharded array length)."""
    return ((n_pixels + n_dev - 1) // n_dev) * n_dev


def shard_pixels(cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """Absolute pixel ids (int64, on the first entry's device) laid out for
    sharding over 'tiles'.

    The length is n_pixels rounded UP to a multiple of the mesh's entries
    (pad-and-mask): the tail repeats the last pixel id, so a padded lane renders
    that real pixel again (the same bits, by the absolute-id RNG), and assembly drops
    the tail (render_progressive_sharded takes mean()[:n_pixels]). Where the mesh
    divides the image this is arange(n_pixels).
    """
    devices = tile_devices(mesh)
    n_pad = padded_pixel_count(cfg.n_pixels, len(devices))
    ids = torch.arange(n_pad, dtype=torch.int64, device=devices[0])
    return torch.clamp(ids, max=cfg.n_pixels - 1)


def make_sharded_render_step(cfg: RenderConfig, mesh: Mesh, samples_per_step: int,
                             sample_fn: Optional[Callable] = None):
    """(accs, scene, pixel_ids, start_sample, key) → accs over the mesh.

    `accs` is the sharded accumulator: one Accumulator per entry, on its device, over
    its block of `pixel_ids` (shard_pixels' layout); `scene` and `key` are
    replicated. Each entry adds its samples in sample order, as the single-device
    step does; no entry waits on another. `sample_fn(scene, cfg, sample_idx, key,
    pixel_ids=...)` defaults to the threefry path integrator.
    """
    fn = sample_fn or render_sample
    devices = tile_devices(mesh)
    split = tile_sharding(mesh)

    def step(accs: list, scene: Scene, pixel_ids: torch.Tensor, start_sample: int,
             key: torch.Tensor) -> list:
        out = []
        for acc, ids, d in zip(accs, split(pixel_ids), devices):
            sc, k = scene.to(d), key.to(d)
            for s in range(start_sample, start_sample + samples_per_step):
                radiance, _ = fn(sc, cfg, s, k, pixel_ids=ids)
                acc = acc.add(radiance)
            out.append(acc)
        return out

    return step


def render_progressive_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                               total_spp: int, samples_per_step: int = 16,
                               seed: Optional[int] = None,
                               sample_fn: Optional[Callable] = None) -> torch.Tensor:
    """Progressive render across the mesh; returns the full linear mean image
    (n_pixels, 3) on the first entry's device."""
    devices = tile_devices(mesh)
    key = rng.make_key(cfg.seed if seed is None else seed, devices[0])
    pixel_ids = shard_pixels(cfg, mesh)
    # Accumulate over the PADDED pixel space (pad-and-mask: see shard_pixels); the
    # tail duplicates the last pixel and is dropped at assembly.
    per_entry = pixel_ids.shape[0] // len(devices)
    accs = [Accumulator.zeros(per_entry, d) for d in devices]
    step = make_sharded_render_step(cfg, mesh, samples_per_step, sample_fn)

    s = 0
    while s < total_spp:
        accs = step(accs, scene, pixel_ids, s, key)
        s += samples_per_step
    total = Accumulator(sum=torch.cat([a.sum.to(devices[0]) for a in accs]),
                        count=accs[0].count.to(devices[0]))
    return total.mean()[:cfg.n_pixels]
