"""Tile-sharded rendering with the hand-written kernels — the fast multi-device path.

Counterpart of `oclpathtracer_tpu.parallel.sharded_pallas`. parallel/sharded.py
shards the batched integrator; this module shards the kernels: entry i launches the
megakernel (`kernels/csrc/megakernel.cu`) or the path-regeneration kernel
(`kernels/csrc/wavefront.cu`) over its contiguous range of ABSOLUTE pixel ids
(pid_base = i × pixels-per-entry, n_rays = pixels-per-entry), on its own device. RNG
streams, and so images and segment counts, are bit for bit the single call's on any
mesh. The forward path has no collective: the image is the entries' images
concatenated on the first entry's device, and the segments their counts added in
mesh order (int64, exact). The JAX module's per-shard BLOCK alignment was a TPU tile
rule; a CUDA launch takes any range.
"""

from __future__ import annotations

import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wavefront as wf
from oclpathtracer_tpu_torch.parallel.mesh import Mesh, tile_devices
from oclpathtracer_tpu_torch.scene.types import Scene


def make_sharded_kernel_step(cfg: RenderConfig, mesh: Mesh, n_samples: int,
                             scan: str = "parity", emi_const: tuple = mk.NO_EMI,
                             classes: tuple = (), kernel: str = "megakernel",
                             interleave: int = 0):
    """(table, start_sample) → (img (n_pixels, 3) SUM of n_samples frames on the
    first entry's device, segments () int64 there).

    `table`, scan, emi_const, classes: as `megakernel.prepare_scan` returns them; the
    table is replicated to each entry's device (once a table, as a render makes its
    tp0 and scan tables once). kernel: "megakernel" (fixed bounce loop, with the tp0
    peel where it applies) or "wavefront" (in-thread path regeneration, what
    backend="auto" renders with past 8 bounces). interleave: the wavefront's streams
    a pixel (0: its default, 1, which is bit for bit the megakernel); the megakernel
    has no such knob (its image does not depend on one). Requires n_pixels divisible
    by the mesh.
    """
    if kernel not in ("megakernel", "wavefront"):
        raise ValueError(f"kernel must be 'megakernel' or 'wavefront', got {kernel!r}")
    devices = tile_devices(mesh)
    n_pix = cfg.n_pixels
    if n_pix % len(devices) != 0:
        raise ValueError(f"{n_pix} pixels not divisible by {len(devices)} devices")
    local_n = n_pix // len(devices)
    tables = {}  # device → (the caller's table, its copy there, the aux table)

    def on(table: torch.Tensor, d: torch.device):
        hit = tables.get(d)
        if hit is None or hit[0] is not table:
            td = table.to(d)
            aux = (mk.tp0_table_for(td, cfg, scan) if kernel == "megakernel"
                   else wf.scan_table(td, scan))
            tables[d] = hit = (table, td, aux)
        return hit[1], hit[2]

    def launch(table, start_sample: int, base: int, d: torch.device):
        td, aux = on(table, d)
        if kernel == "wavefront":
            return wf.render_samples_wavefront_stats(
                td, cfg, start_sample, n_samples, interleave=interleave or 1, scan=scan,
                classes=classes, pid_base=base, n_rays=local_n, emi_const=emi_const,
                scan_tbl=aux)
        return mk.render_samples_pallas_stats(
            td, cfg, start_sample, n_samples, pid_base=base, n_rays=local_n, scan=scan,
            classes=classes, tp0_table=aux, emi_const=emi_const)

    def step(table: torch.Tensor, start_sample: int):
        parts = [launch(table, int(start_sample), i * local_n, d)
                 for i, d in enumerate(devices)]
        img = torch.cat([p[0].to(devices[0]) for p in parts])
        segs = parts[0][1]
        for p in parts[1:]:
            segs = segs + p[1].to(devices[0])
        return img, segs

    return step


def render_pallas_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh, total_spp: int,
                          samples_per_call: int = 0, scan: str = "auto") -> torch.Tensor:
    """Progressive mean image over the mesh via the megakernel, on the first entry's
    device; a last chunk shorter than samples_per_call takes the samples left."""
    scan, table, emi, classes = mk.prepare_scan(scene, scan)
    steps = {}  # samples a call → its step

    def chunk(start: int, n: int):
        if n not in steps:
            steps[n] = make_sharded_kernel_step(cfg, mesh, n, scan=scan, emi_const=emi,
                                                classes=classes)
        return steps[n](table, start)

    return mk.mean_of_chunks(chunk, cfg, total_spp, samples_per_call or total_spp,
                             tile_devices(mesh)[0])
