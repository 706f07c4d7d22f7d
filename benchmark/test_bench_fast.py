"""The AO and direct cells' own pieces on the CPU: the plain reference and the frozen
counts load nothing of the program; the frozen eye rows are the rows the program's
kernels keep; a job's counts are the reference's at a small size."""

from __future__ import annotations

import os
import subprocess
import sys

import torch

from benchmark import common, spec, tiny
from benchmark.counts import cornell_fast
from benchmark.reference import fast as rf
from benchmark.reference import scene as rs


def test_the_fast_reference_and_counts_load_nothing_of_the_program():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = spec.ROOT
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import benchmark.reference.fast, benchmark.counts.cornell_fast\n"
         "print(sorted({m.split('.')[0] for m in sys.modules} & {'oclpathtracer_tpu_torch',\n"
         "      'oclpathtracer_tpu', 'jax', 'jaxlib', 'flax'}))\n"],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_the_frozen_eye_rows_are_the_rows_the_kernels_keep():
    from oclpathtracer_tpu_torch.kernels import fast_integrators as fi
    from oclpathtracer_tpu_torch.kernels import megakernel as mk

    cell = spec.load_cell("cornell-ao")
    scene, cfg = common.program_scene(cell, torch.device("cpu"))
    kept = len(fi._eye_rows(mk.pack_scene(scene), mk._Consts.of(cfg).eye))
    sd = rs.scene_data(cell)
    assert kept == cornell_fast.eye_rows(sd, common.reference_render(cell).eye) == 20


def test_a_tiny_jobs_rays_are_the_references():
    """The entry's per-job count (the program's rays, from set-up's job) against the
    reference's rays over the whole tiny image."""
    for name in ("cornell-ao", "cornell-direct"):
        cell = tiny.tiny_cell(name)
        entry = spec.load_module("entries", cell.traffic["entry"]).Entry(cell, 7,
                                                                         torch.device("cpu"))
        c = cell.config
        pixels = torch.arange(c["width"] * c["height"])
        _, counts = rf.pixel_sums(cell.traffic["integrator"], rs.scene_data(cell),
                                  common.reference_render(cell), pixels, 0,
                                  cell.traffic["job_spp"], radius=c["ao_radius"])
        assert entry.counts(3)["segments"] == 3 * rf.rays_cast(counts) > 0
