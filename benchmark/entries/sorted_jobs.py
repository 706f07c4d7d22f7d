"""Sorted-wavefront render jobs through the public call: each unit is one
`render_sorted(scene, cfg, total_spp=job_spp, samples_per_call=samples_per_step)`,
the CLI's call for `--integrator sorted`, samples 0 .. job_spp - 1, with the
skip-link build (leaf 32) that every call makes, and the client waits for each image.
Set-up builds the scene with the port's generator, runs one job and requires that
its calls made the bounce kernel's launches, `bounces` a call, and no other kernel's.

Checked as `progressive_jobs` checks (whose Entry this one extends): the last image
and those kept against the reference's mean over the job's samples, and the program's
segment count over the whole image at `segment_samples` single samples drawn from the
seed, against the reference's. The compared pixels are `check_blocks` × `block_pixels`
pixels (all of them, where there are fewer) drawn from the seed among those whose
centre ray meets a triangle in the reference (`scene_pixels`): from the default eye
most rays escape, and a pixel of the constant environment sees nothing of what the
bounce kernel shades. The program's counts are its own: set-up's job runs with
`render_samples_sorted_stats` wrapped, which records the tables and arguments
`render_sorted` passes and the segments its calls return; every job renders the same
samples on the same build, so that is each job's count, and the compared single
samples are launched on the tables it recorded.
"""

from __future__ import annotations

import random

import torch

from benchmark import common, faults
from benchmark.entries import progressive_jobs
from benchmark.reference import culled
from benchmark.reference import pathtrace as pt


def scene_pixels(check: common.RenderCheck, device) -> list:
    """The pixels whose centre ray meets a triangle in the reference's nearest hit."""
    sd, r = check.scene, check.render
    every = torch.arange(r.width * r.height, device=device)
    centre = torch.full(every.shape, 0.5, device=device)
    o, d = pt.camera(r, every, centre, centre, torch.float32)
    hit, _, _ = culled.nearest(pt.geometry(sd, device), o, d, sd.balls)
    return every[hit].tolist()


class Entry(progressive_jobs.Entry):
    def __init__(self, cell, seed: int, device: torch.device):
        from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw
        from oclpathtracer_tpu_torch.runtime import profiling

        t = cell.traffic
        rnd = random.Random(seed)
        self.device = device
        self.job_spp, self.step_spp = t["job_spp"], t["samples_per_step"]
        self.check = common.RenderCheck(cell, [], 1)
        hits = scene_pixels(self.check, device)
        if not hits:
            raise RuntimeError("no camera ray of the cell meets the scene")
        wanted = min(t["check_blocks"] * t["block_pixels"], len(hits))
        self.blocks = sorted(rnd.sample(hits, wanted))
        self.check.starts = self.blocks  # runs of one pixel
        self.samples = sorted(rnd.sample(range(self.job_spp), t["segment_samples"]))
        self.keep = random.Random(rnd.getrandbits(64))
        self.keep_share = 1.0 / t["keep_every"]
        self.kept, self.last = [], None
        common.fresh_peak(device)

        self.scene, self.cfg = common.program_scene(cell, device)
        self.job = lambda: sw.render_sorted(self.scene, self.cfg, self.job_spp,
                                            samples_per_call=self.step_spp)
        before = profiling.counts()
        calls = self.record_launches()  # builds and loads the kernel, warms this shape
        n_calls = -(-self.job_spp // self.step_spp)
        if len(calls) != n_calls:
            raise RuntimeError(f"a sorted job made {len(calls)} calls, not {n_calls}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            rose = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
                    if k.startswith("launch.") and v != before.get(k, 0)}
            if rose != {"launch.sorted": self.cfg.bounces * n_calls}:
                raise RuntimeError(f"a sorted job's {n_calls} calls launched {rose}, not "
                                   f"{self.cfg.bounces} bounce launches a call")
        self.per_job = sum(int(segs) for _, _, segs in calls)
        self.launch_args = calls[0][:2]

    def record_launches(self) -> list:
        """Run one job with the sorted wavefront's entry wrapped; its calls as
        (positional arguments before the sample range, keyword arguments, segments)."""
        from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw

        orig, calls = sw.render_samples_sorted_stats, []

        def launch(table, nodes_f, nodes_i, cfg, start, n, **kw):
            img, segs = orig(table, nodes_f, nodes_i, cfg, start, n, **kw)
            calls.append(((table, nodes_f, nodes_i, cfg), kw, segs))
            return img, segs

        sw.render_samples_sorted_stats = launch
        try:
            self.job()
        finally:
            sw.render_samples_sorted_stats = orig
        self.launcher = orig
        return calls


def fault_patches(fault: str) -> list:
    """The port's function a planted fault replaces (`faults.py`): the sorted
    wavefront's call of `samples_per_call` samples. "unchanged" runs the call and adds
    nothing of it to the job's sum; "half" leaves the second half of each call's image
    out; "altered" traces a sample range 2^20 samples off its own."""
    from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw

    orig = sw.render_samples_sorted_stats

    def launch(table, nodes_f, nodes_i, cfg, start, n, *a, **kw):
        if fault == "altered":
            return orig(table, nodes_f, nodes_i, cfg, start + faults.FAR, n, *a, **kw)
        img, segs = orig(table, nodes_f, nodes_i, cfg, start, n, *a, **kw)
        if fault == "unchanged":
            return torch.zeros_like(img), segs
        half = cfg.n_pixels // 2
        return torch.cat([img[:half], torch.zeros_like(img[half:])]), segs

    return [(sw, "render_samples_sorted_stats", launch)]
