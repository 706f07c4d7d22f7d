"""Preview frames: the driver's kernel step for one sample a launch is built once,
then each unit adds one frame to the image's accumulator and the client waits for
it, as the reference's progressive loop does; after `frames_per_image` frames the
image is done and the next starts from zero over the same samples, the first drawn
from the seed.

Checked: the last finished image and the one in progress when the window closes,
at pixel blocks drawn from the seed, against the reference over their frames; the
segments the program counts over those blocks against the reference's.
"""

from __future__ import annotations

import random

import torch

from benchmark import common
from benchmark.entries.render_jobs import fault_patches  # noqa: F401  (the same faults)


class Entry:
    wait_each = True

    def __init__(self, cell, seed: int, device: torch.device):
        from oclpathtracer_tpu_torch.render import driver
        from oclpathtracer_tpu_torch.render.accumulate import Accumulator

        t = cell.traffic
        rnd = random.Random(seed)
        self.device = device
        self.frames = t["frames_per_image"]
        self.first = rnd.randrange(0, common.MAX_START)
        n_pixels = cell.config["width"] * cell.config["height"]
        self.blocks = common.pixel_blocks(rnd, n_pixels, t["check_blocks"], t["block_pixels"])
        self.check = common.RenderCheck(cell, self.blocks, t["block_pixels"])
        common.fresh_peak(device)

        self.scene, self.cfg = common.program_scene(cell, device)
        self.zeros = lambda: Accumulator.zeros(self.cfg.n_pixels, device)
        self.step = driver.make_kernel_render_step(self.scene, self.cfg, 1, backend="auto")
        warm = self.zeros()
        for j in range(3):  # builds and loads the kernels, warms this shape
            warm = self.step(warm, self.first + j)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.acc, self.done = self.zeros(), None

    def unit(self, i: int) -> None:
        j = i % self.frames
        if j == 0 and i > 0:
            self.done, self.acc = self.acc, self.zeros()
        self.acc = self.step(self.acc, self.first + j)

    def counts(self, units: int) -> dict:
        seg = common.Segments(self.scene, self.cfg)
        whole, rest = divmod(units, self.frames)
        total = whole * seg(self.first, self.frames) if whole else 0
        return {"segments": total + seg(self.first, rest),
                "paths": units * self.cfg.n_pixels}

    def outputs(self, units: int) -> dict:
        ids = common.block_ids(self.blocks, self.check.size, self.device)
        seg = common.Segments(self.scene, self.cfg)
        current = units - self.frames * ((units - 1) // self.frames)
        images = [(0, self.acc.mean()[ids].double().cpu())]
        ranges = {0: current}
        if self.done is not None:
            images.append((1, self.done.mean()[ids].double().cpu()))
            ranges[1] = self.frames
        out = {"images": images, "frames": ranges,
               "segments": {k: seg.blocks(self.first, n, self.blocks, self.check.size)
                            for k, n in ranges.items()}}
        self.acc = self.done = self.step = self.scene = None
        common.free(self.device)
        return out

    def reference(self, outputs: dict, dtype=torch.float32) -> dict:
        return self.check.means(self.device, dtype,
                                {k: (self.first, n) for k, n in outputs["frames"].items()})

    def numbers(self, outputs: dict) -> dict:
        return self.check.numbers(outputs, self.reference(outputs))

    def control_outputs(self, outputs: dict) -> dict:
        low = self.reference(outputs, torch.bfloat16)
        return {"images": [(k, low[k][0]) for k, _ in outputs["images"]],
                "frames": outputs["frames"],
                "segments": {k: low[k][1] for k in outputs["segments"]}}
