"""What the entries share: the program's scene and render settings, seeded choices,
the program's segment counts, and the reference's side of a render check."""

from __future__ import annotations

import functools
import gc
import random

import torch

from benchmark import compare
from benchmark.reference import culled
from benchmark.reference import pathtrace as pt
from benchmark.reference import scene as rs

# Samples are indexed by 32-bit signed ints in the kernels' launch parameters.
MAX_START = 1 << 30


def camera(cell) -> dict:
    """The configuration's camera (`camera`: any of `eye`, `look`, `up`, three numbers
    each, and `vfov_degrees`), the renderer's own default for what it leaves out."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cell.config.get("camera", {}).items()}


def program_scene(cell, device):
    """The program's scene and its render settings: read from the benchmark's copy of
    the scene file, or built by the port's own generator of that name."""
    from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from oclpathtracer_tpu_torch.scene import load_cornell_box, procgen

    c = cell.config
    spec = c["scene"]
    if isinstance(spec, dict):
        args = {k: v for k, v in spec.items() if k != "generator"}
        scene = getattr(procgen, spec["generator"])(**args, device=device)
    else:
        scene = load_cornell_box(cell.scene_path, device=device)
    return scene, RenderConfig(width=c["width"], height=c["height"], bounces=c["bounces"],
                               camera=CameraConfig(**camera(cell)))


def reference_render(cell) -> pt.Render:
    c = cell.config
    cam = camera(cell)
    if "vfov_degrees" in cam:
        cam["vfov"] = cam.pop("vfov_degrees")
    return pt.Render(c["width"], c["height"], c["bounces"], **cam)


def pixel_blocks(rnd: random.Random, n_pixels: int, blocks: int, size: int) -> list:
    """Starts of `blocks` runs of `size` consecutive pixels, one drawn in each of
    `blocks` equal slices of the image: every share of the image as large as a slice
    holds one."""
    part = n_pixels // blocks
    return [j * part + rnd.randrange(part // size) * size for j in range(blocks)]


def block_ids(starts: list, size: int, device) -> torch.Tensor:
    return torch.cat([torch.arange(s, s + size, dtype=torch.int64, device=device)
                      for s in starts])


def fresh_peak(device) -> None:
    """Free what the benchmark made and start the peak memory count at the program."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def draw(gen: torch.Generator, lo: float, hi: float, shape, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


class Segments:
    """The program's own count of traced segments of a sample range, from the stats
    entry of the kernel that its driver's auto backend picks for the configuration,
    in launches of at most `chunk` samples."""

    def __init__(self, scene, cfg, chunk: int = 64):
        from oclpathtracer_tpu_torch.kernels import megakernel as mk
        from oclpathtracer_tpu_torch.kernels import wavefront as wf
        from oclpathtracer_tpu_torch.render import driver

        self.cfg, self.chunk = cfg, chunk
        scan, table, emi, classes = mk.prepare_scan(scene, "auto")
        if cfg.bounces > driver.MEGAKERNEL_MAX_BOUNCES:
            tbl = wf.scan_table(table, scan)

            def launch(start, n, pid_base, n_rays):
                return wf.render_samples_wavefront_stats(
                    table, cfg, start, n, scan=scan, classes=classes, emi_const=emi,
                    scan_tbl=tbl, pid_base=pid_base, n_rays=n_rays)[1]
        else:
            tp0 = mk.tp0_table_for(table, cfg, scan)

            def launch(start, n, pid_base, n_rays):
                return mk.render_samples_pallas_stats(
                    table, cfg, start, n, pid_base=pid_base, n_rays=n_rays, scan=scan,
                    classes=classes, tp0_table=tp0, emi_const=emi)[1]
        self.launch = launch

    def __call__(self, start: int, n: int, pid_base: int = 0, n_rays=None) -> int:
        total = 0
        for s in range(start, start + n, self.chunk):
            total = total + self.launch(s, min(self.chunk, start + n - s), pid_base, n_rays)
        return int(total)

    def blocks(self, start: int, n: int, starts: list, size: int) -> int:
        return sum(self(start, n, b, size) for b in starts)


class RenderCheck:
    """The reference's side of a render cell's check: images compared at pixel
    blocks drawn from the seed, and segment counts over those blocks.

    `ranges` map an index to a (first sample, samples) pair; the program's outputs give, per
    compared image, its range's index and its mean at the block pixels, and per range
    its segment count over the blocks."""

    def __init__(self, cell, starts: list, size: int):
        self.cell, self.starts, self.size = cell, starts, size
        self.render = reference_render(cell)

    @functools.cached_property
    def scene(self) -> rs.SceneData:
        return rs.scene_data(self.cell)

    def sums(self, device, dtype, first: int, n: int, pixels=None):
        """(float64 sums at the block pixels, or at `pixels`, (P, 3), segments) of a
        sample range. A generated scene's hits come from `culled.py`."""
        sd = self.scene
        g = pt.geometry(sd, device, dtype)
        ids = block_ids(self.starts, self.size, device) if pixels is None else pixels
        alb = torch.as_tensor(sd.albedo, device=device)
        emi = torch.as_tensor(sd.emissive, device=device)
        scan = pt.nearest if sd.balls is None else functools.partial(culled.nearest,
                                                                     balls=sd.balls)
        return pt.pixel_sums(g, self.render, ids, first, n, alb, emi, nearest=scan)

    def means(self, device, dtype, ranges: dict):
        """Per range, (mean at the blocks (P, 3) float64 on the CPU, segments).
        Ranges that start alike and nest are traced once, the longer continuing the
        shorter."""
        out = {}
        done = {}
        for idx in sorted(ranges, key=lambda i: ranges[i]):
            first, n = ranges[idx]
            have = done.get(first)
            if have is None:
                s, c = self.sums(device, dtype, first, n)
            else:
                n0, s0, c0 = have
                s1, c1 = self.sums(device, dtype, first + n0, n - n0)
                s, c = s0 + s1, c0 + c1
            done[first] = (n, s, c)
            out[idx] = ((s / n).cpu(), c)
        return out

    def numbers(self, outputs: dict, reference: dict) -> dict:
        images = [compare.rel_l2(rows, reference[idx][0]) for idx, rows in outputs["images"]]
        prog = sum(outputs["segments"].values())
        ref = sum(reference[idx][1] for idx in outputs["segments"])
        return {"image_rel_l2": max(images), "segments_gap": compare.count_gap(prog, ref)}
