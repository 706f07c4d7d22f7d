"""AO or direct-illumination render jobs through the public call: each unit is one
`render_ao(scene, cfg, job_spp, samples_per_call=..., radius=ao_radius)` or
`render_direct(scene, cfg, job_spp, samples_per_call=...)` (the traffic's
`integrator`), the CLI's `ao-pallas` and `direct-pallas`, samples 0 .. job_spp - 1,
with the tables packed on every call, and the client waits for each image. Set-up
runs one job and requires that its calls launched that pass's kernel once a call and
no other kernel.

Checked: the last image and those kept (one in `keep_every`, drawn from the seed), at
pixel blocks drawn from the seed, against `reference/fast.py`'s mean over the job's
samples; and the rays the program casts over those blocks (its stats entry's count
on each block's pixel window, every sample of the job) against the reference's. The
program's count of a job is its own: set-up's job runs with the pass's stats entry
wrapped, which records the tables and arguments the call passes and the rays its
launches return; every job renders the same samples on the same tables, so that is
each job's count, and the blocks are launched on the tables it recorded.
"""

from __future__ import annotations

import random

import torch

from benchmark import common, compare, faults
from benchmark.reference import fast as rf
from benchmark.reference import scene as rs

STATS = {"ao": "render_ao_stats", "direct": "render_direct_stats"}


class Entry:
    wait_each = True

    def __init__(self, cell, seed: int, device: torch.device):
        from oclpathtracer_tpu_torch.kernels import fast_integrators as fi
        from oclpathtracer_tpu_torch.runtime import profiling

        t = cell.traffic
        rnd = random.Random(seed)
        self.device = device
        self.kind = t["integrator"]
        self.job_spp, self.call_spp = t["job_spp"], t["samples_per_call"]
        self.radius = cell.config["ao_radius"]
        n_pixels = cell.config["width"] * cell.config["height"]
        self.size = t["block_pixels"]
        self.blocks = common.pixel_blocks(rnd, n_pixels, t["check_blocks"], self.size)
        self.keep = random.Random(rnd.getrandbits(64))
        self.keep_share = 1.0 / t["keep_every"]
        self.kept, self.last = [], None
        self.cell = cell
        common.fresh_peak(device)

        self.scene, self.cfg = common.program_scene(cell, device)
        if self.kind == "ao":
            self.job = lambda: fi.render_ao(self.scene, self.cfg, self.job_spp,
                                            samples_per_call=self.call_spp,
                                            radius=self.radius)
        else:
            self.job = lambda: fi.render_direct(self.scene, self.cfg, self.job_spp,
                                                samples_per_call=self.call_spp)
        before = profiling.counts()
        calls = self.record_launches()  # builds and loads the kernels, warms this shape
        n_calls = -(-self.job_spp // self.call_spp)
        if len(calls) != n_calls:
            raise RuntimeError(f"a {self.kind} job made {len(calls)} calls, not {n_calls}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            rose = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
                    if k.startswith("launch.") and v != before.get(k, 0)}
            if rose != {"launch." + self.kind: n_calls}:
                raise RuntimeError(f"a {self.kind} job's {n_calls} calls launched {rose}")
        self.per_job = sum(int(rays) for _, _, rays in calls)
        self.launch_args = calls[0][:2]

    def record_launches(self) -> list:
        """Run one job with the pass's stats entry wrapped; its calls as (positional
        arguments before the sample range, keyword arguments, rays)."""
        from oclpathtracer_tpu_torch.kernels import fast_integrators as fi

        name = STATS[self.kind]
        orig, calls = getattr(fi, name), []

        def launch(*a, **kw):
            img, rays = orig(*a, **kw)
            calls.append((a[:-2], kw, rays))
            return img, rays

        setattr(fi, name, launch)
        try:
            self.job()
        finally:
            setattr(fi, name, orig)
        self.launcher = orig
        return calls

    def unit(self, i: int) -> None:
        img = self.job()
        if self.keep.random() < self.keep_share:
            self.kept.append(img)
        self.last = img

    def counts(self, units: int) -> dict:
        """Rays cast and paths of `units` jobs: every job renders the same samples on
        the same tables as set-up's. A ray counts as one segment."""
        return {"segments": units * self.per_job,
                "paths": units * self.job_spp * self.cfg.n_pixels}

    def outputs(self, units: int) -> dict:
        """The program's compared answers, on the CPU; frees the program."""
        ids = common.block_ids(self.blocks, self.size, self.device)
        head, kw = self.launch_args
        rays = sum(int(self.launcher(*head, 0, self.job_spp,
                                     **{**kw, "pid_base": b, "n_rays": self.size})[1])
                   for b in self.blocks)
        out = {"images": [img[ids].double().cpu() for img in self.kept + [self.last]],
               "rays": rays}
        self.kept, self.last, self.job, self.scene = [], None, None, None
        self.launch_args = self.launcher = None
        common.free(self.device)
        return out

    def reference(self, dtype=torch.float32) -> dict:
        """The reference's mean over the job's samples at the blocks, and its rays
        cast there."""
        ids = common.block_ids(self.blocks, self.size, self.device)
        sums, counts = rf.pixel_sums(self.kind, rs.scene_data(self.cell),
                                     common.reference_render(self.cell), ids, 0, self.job_spp,
                                     dtype, radius=self.radius)
        return {"image": (sums / self.job_spp).cpu(), "rays": rf.rays_cast(counts)}

    def numbers(self, outputs: dict) -> dict:
        ref = self.reference()
        return {"image_rel_l2": max(compare.rel_l2(rows, ref["image"])
                                    for rows in outputs["images"]),
                "segments_gap": compare.count_gap(outputs["rays"], ref["rays"])}

    def control_outputs(self, outputs: dict) -> dict:
        """`outputs` with the program's answers replaced by the reference's in
        bfloat16."""
        low = self.reference(torch.bfloat16)
        return {"images": [low["image"] for _ in outputs["images"]], "rays": low["rays"]}


def fault_patches(fault: str) -> list:
    """The port's functions a planted fault replaces (`faults.py`): both passes' stats
    entries, each call of `samples_per_call` samples. "unchanged" runs the call and
    adds nothing of it to the job's sum; "half" traces the first half of the image's
    pixels and leaves the rest out; "altered" traces a sample range 2^20 samples off
    its own. A call on a pixel window (the check's own counts) runs unchanged."""
    from oclpathtracer_tpu_torch.kernels import fast_integrators as fi

    def wrap(orig):
        def launch(*a, **kw):
            *head, cfg, start, n = a
            if kw.get("n_rays") is not None:
                return orig(*a, **kw)
            if fault == "altered":
                return orig(*head, cfg, start + faults.FAR, n, **kw)
            if fault == "unchanged":
                img, rays = orig(*a, **kw)
                return torch.zeros_like(img), rays
            half = cfg.n_pixels // 2
            img, rays = orig(*a, **{**kw, "n_rays": half})
            return torch.cat([img, torch.zeros((cfg.n_pixels - half, 3), dtype=img.dtype,
                                               device=img.device)]), rays

        return launch

    return [(fi, name, wrap(getattr(fi, name))) for name in STATS.values()]
