"""Render jobs: each unit is one progressive render of `job_spp` samples a pixel in
launches of `samples_per_step`, as the driver's `render_progressive` makes it on a
kernel backend (its step built for the call, an accumulator, the launches, the mean
image), but from a first sample drawn from the seed: the jobs cycle over `ranges`
sample ranges. The client waits for each image before it sends the next job.

Checked: the images of jobs drawn from the seed (and the last), at pixel blocks drawn
from the seed, against the reference over the same samples; the segments the program
counts over those blocks against the reference's.
"""

from __future__ import annotations

import random

import torch

from benchmark import common, faults


class Entry:
    wait_each = True

    def __init__(self, cell, seed: int, device: torch.device):
        from oclpathtracer_tpu_torch.render import driver
        from oclpathtracer_tpu_torch.render.accumulate import Accumulator

        t = cell.traffic
        rnd = random.Random(seed)
        self.device = device
        self.job_spp, self.step_spp = t["job_spp"], t["samples_per_step"]
        self.starts = [rnd.randrange(0, common.MAX_START) for _ in range(t["ranges"])]
        n_pixels = cell.config["width"] * cell.config["height"]
        self.blocks = common.pixel_blocks(rnd, n_pixels, t["check_blocks"], t["block_pixels"])
        self.check = common.RenderCheck(cell, self.blocks, t["block_pixels"])
        self.keep = random.Random(rnd.getrandbits(64))
        self.keep_share = 1.0 / t["keep_every"]
        self.kept, self.last = [], None
        common.fresh_peak(device)

        self.scene, self.cfg = common.program_scene(cell, device)

        def job(start):
            step = driver.make_kernel_render_step(self.scene, self.cfg, self.step_spp,
                                                  backend="auto")
            acc = Accumulator.zeros(self.cfg.n_pixels, device)
            for s in range(start, start + self.job_spp, self.step_spp):
                acc = step(acc, s)
            return acc.mean()

        self.job = job
        job(self.starts[0])  # builds and loads the kernels, warms this shape
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def unit(self, i: int) -> None:
        r = i % len(self.starts)
        img = self.job(self.starts[r])
        if self.keep.random() < self.keep_share:
            self.kept.append((r, img))
        self.last = (r, img)

    def ranges(self, units: int) -> list:
        return sorted({i % len(self.starts) for i in range(units)})

    def counts(self, units: int) -> dict:
        """Traced segments and paths of `units` jobs from the first."""
        seg = common.Segments(self.scene, self.cfg)
        per = {r: seg(self.starts[r], self.job_spp) for r in self.ranges(units)}
        return {"segments": sum(per[i % len(self.starts)] for i in range(units)),
                "paths": units * self.job_spp * self.cfg.n_pixels}

    def outputs(self, units: int) -> dict:
        """The program's compared answers, on the CPU; frees the program."""
        ids = common.block_ids(self.blocks, self.check.size, self.device)
        seg = common.Segments(self.scene, self.cfg)
        out = {"images": [(r, img[ids].double().cpu()) for r, img in self.kept + [self.last]],
               "segments": {r: seg.blocks(self.starts[r], self.job_spp, self.blocks,
                                          self.check.size) for r in self.ranges(units)}}
        self.kept, self.last, self.job, self.scene = [], None, None, None
        common.free(self.device)
        return out

    def reference(self, outputs: dict, dtype=torch.float32) -> dict:
        return self.check.means(self.device, dtype, {r: (self.starts[r], self.job_spp)
                                                     for r in outputs["segments"]})

    def numbers(self, outputs: dict) -> dict:
        return self.check.numbers(outputs, self.reference(outputs))

    def control_outputs(self, outputs: dict) -> dict:
        """`outputs` with the program's answers replaced by the reference's in
        bfloat16."""
        low = self.reference(outputs, torch.bfloat16)
        return {"images": [(r, low[r][0]) for r, _ in outputs["images"]],
                "segments": {r: low[r][1] for r in outputs["segments"]}}


def fault_patches(fault: str) -> list:
    """The port's functions a planted fault replaces (`faults.py`)."""
    from oclpathtracer_tpu_torch.kernels import wavefront
    from oclpathtracer_tpu_torch.render import driver

    if fault == "unchanged":
        orig = driver.make_kernel_render_step

        def make(*a, **kw):
            orig(*a, **kw)
            return lambda acc, start: acc

        return [(driver, "make_kernel_render_step", make)]
    orig = wavefront.render_samples_wavefront_stats

    def launch(table, cfg, start, n, *a, **kw):
        if kw.get("n_rays") is not None:  # the check's own block counts
            return orig(table, cfg, start, n, *a, **kw)
        if fault == "altered":
            return orig(table, cfg, start + faults.FAR, n, *a, **kw)
        half = cfg.n_pixels // 2
        img, segs = orig(table, cfg, start, n, *a, **{**kw, "n_rays": half})
        return torch.cat([img, torch.zeros((cfg.n_pixels - half, 3), dtype=img.dtype,
                                           device=img.device)]), segs

    return [(wavefront, "render_samples_wavefront_stats", launch)]
