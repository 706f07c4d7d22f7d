"""Progressive render jobs through the public call: each unit is one
`render_progressive(scene, cfg, total_spp=job_spp, samples_per_step=...,
backend="auto")`, samples 0 .. job_spp - 1, with the build its auto backend makes on
every call (on a scene past the linear kernels' size, the BVH build, its widening and
packing), and the client waits for each image. Set-up builds the scene with the
port's generator, runs one job and requires that the auto rule took the 8-wide BVH
kernel.

Checked: the last image and those kept (one in `keep_every`, drawn from the seed), at
pixel blocks drawn from the seed, against the reference's mean over the job's
samples; and the program's segment count over the whole image at `segment_samples`
single samples drawn from the seed, against the reference's (the BVH kernels have no
pixel window). The program's counts are the driver's own: set-up's job runs with
`render_samples_wide_bvh_stats` wrapped, which records the tables and arguments the
driver passes and the segments its launches return; every job renders the same
samples on the same build, so that is each job's count, and the compared single
samples are launched on the tables it recorded.
"""

from __future__ import annotations

import random

import torch

from benchmark import common, compare, faults


class Entry:
    wait_each = True

    def __init__(self, cell, seed: int, device: torch.device):
        from oclpathtracer_tpu_torch.render import driver
        from oclpathtracer_tpu_torch.runtime import profiling

        t = cell.traffic
        rnd = random.Random(seed)
        self.device = device
        self.job_spp, self.step_spp = t["job_spp"], t["samples_per_step"]
        n_pixels = cell.config["width"] * cell.config["height"]
        self.blocks = common.pixel_blocks(rnd, n_pixels, t["check_blocks"], t["block_pixels"])
        self.samples = sorted(rnd.sample(range(self.job_spp), t["segment_samples"]))
        self.check = common.RenderCheck(cell, self.blocks, t["block_pixels"])
        self.keep = random.Random(rnd.getrandbits(64))
        self.keep_share = 1.0 / t["keep_every"]
        self.kept, self.last = [], None
        common.fresh_peak(device)

        self.scene, self.cfg = common.program_scene(cell, device)
        self.job = lambda: driver.render_progressive(
            self.scene, self.cfg, self.job_spp, samples_per_step=self.step_spp,
            backend="auto")
        before = profiling.counts()
        calls = self.record_launches()  # builds and loads the kernels, warms this shape
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            after = profiling.counts()

            def went_up(name):
                return after.get(name, 0) > before.get(name, 0)

            if not calls or not went_up("launch.wide_bvh") or went_up("launch.bvh"):
                raise RuntimeError("the auto backend did not take the 8-wide BVH kernel")
        self.per_job = sum(int(segs) for _, _, segs in calls)
        self.launch_args = calls[0][:2]

    def record_launches(self) -> list:
        """Run one job with the 8-wide kernel's entry wrapped; its launches as
        (positional arguments before the sample range, keyword arguments, segments)."""
        from oclpathtracer_tpu_torch.kernels import wide_bvh as wb

        orig, calls = wb.render_samples_wide_bvh_stats, []

        def launch(table, wn_f, wn_i, cfg, start, n, **kw):
            img, segs = orig(table, wn_f, wn_i, cfg, start, n, **kw)
            calls.append(((table, wn_f, wn_i, cfg), kw, segs))
            return img, segs

        wb.render_samples_wide_bvh_stats = launch
        try:
            self.job()
        finally:
            wb.render_samples_wide_bvh_stats = orig
        self.launcher = orig
        return calls

    def unit(self, i: int) -> None:
        img = self.job()
        if self.keep.random() < self.keep_share:
            self.kept.append(img)
        self.last = img

    def counts(self, units: int) -> dict:
        """Traced segments and paths of `units` jobs: every job renders the same
        samples on the same build as set-up's."""
        return {"segments": units * self.per_job,
                "paths": units * self.job_spp * self.cfg.n_pixels}

    def outputs(self, units: int) -> dict:
        """The program's compared answers, on the CPU; frees the program."""
        ids = common.block_ids(self.blocks, self.check.size, self.device)
        out = {"images": [img[ids].double().cpu() for img in self.kept + [self.last]],
               "segments": {s: int(self.launcher(*self.launch_args[0], s, 1,
                                                 **self.launch_args[1])[1])
                            for s in self.samples}}
        self.kept, self.last, self.job, self.scene = [], None, None, None
        self.launch_args = self.launcher = None
        common.free(self.device)
        return out

    def reference(self, dtype=torch.float32) -> dict:
        """The reference's mean over the job's samples at the blocks, and its segment
        count over the whole image at each compared sample."""
        sums, _ = self.check.sums(self.device, dtype, 0, self.job_spp)
        r = self.check.render
        every = torch.arange(r.width * r.height, device=self.device)
        return {"image": (sums / self.job_spp).cpu(),
                "segments": {s: self.check.sums(self.device, dtype, s, 1, every)[1]
                             for s in self.samples}}

    def numbers(self, outputs: dict) -> dict:
        ref = self.reference()
        return {"image_rel_l2": max(compare.rel_l2(rows, ref["image"])
                                    for rows in outputs["images"]),
                "segments_gap": compare.count_gap(sum(outputs["segments"].values()),
                                                  sum(ref["segments"].values()))}

    def control_outputs(self, outputs: dict) -> dict:
        """`outputs` with the program's answers replaced by the reference's in
        bfloat16."""
        low = self.reference(torch.bfloat16)
        return {"images": [low["image"] for _ in outputs["images"]],
                "segments": low["segments"]}


def fault_patches(fault: str) -> list:
    """The port's functions a planted fault replaces (`faults.py`). "half" leaves the
    second half of each launch's image out (the kernel has no pixel window)."""
    from oclpathtracer_tpu_torch.kernels import wide_bvh
    from oclpathtracer_tpu_torch.render import driver

    if fault == "unchanged":
        orig = driver.make_kernel_render_step

        def make(*a, **kw):
            step = orig(*a, **kw)

            def same(acc, start):
                step(acc, start)  # the launches run; the state is not updated
                return acc

            return same

        return [(driver, "make_kernel_render_step", make)]
    orig = wide_bvh.render_samples_wide_bvh_stats

    def launch(table, wn_f, wn_i, cfg, start, n, *a, **kw):
        if fault == "altered":
            return orig(table, wn_f, wn_i, cfg, start + faults.FAR, n, *a, **kw)
        img, segs = orig(table, wn_f, wn_i, cfg, start, n, *a, **kw)
        half = cfg.n_pixels // 2
        return torch.cat([img[:half], torch.zeros_like(img[half:])]), segs

    return [(wide_bvh, "render_samples_wide_bvh_stats", launch)]
