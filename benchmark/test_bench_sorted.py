"""The spheres-5k-sorted cell's own readers: its two span metrics read `sorted.prepare`
and `kernel.sorted` per job, and nothing where the program has no such span (a
program before `sorted.prepare`); its roofline counts the bounce kernel's work as
`counts/bounds.py` does, over the device time of the port's kernels alone; its frozen
counts load nothing of the program, and their function runs at the tiny cell's size;
the entry compares pixels drawn among those whose centre ray meets the scene. CPU
only, seconds."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import common, spec, tiny
from benchmark.counts import bounds, spheres_5k
from benchmark.entries import sorted_jobs
from benchmark.test_bench_spec import _python
from oclpathtracer_tpu_torch.runtime import profiling

CELL = "spheres-5k-sorted"
CPU = torch.device("cpu")

# {name: (calls, total_s, self_s)} of a window of 2 jobs.
TABLE = {"sorted.prepare": (2, 0.6, 0.6), "kernel.sorted": (256, 0.4, 0.4),
         "driver.prepare": (1, 9.0, 9.0)}


def _run(units: int, counts=None, trace=None):
    return SimpleNamespace(window=SimpleNamespace(units=units, seconds=1.0), trace=trace,
                           counts=counts or {})


@pytest.mark.parametrize("name, want", [("prepare_host_ms.sorted", 300.0),
                                        ("launch_host_ms.sorted", 200.0)])
def test_a_span_reader_gives_its_span_per_job(name, want, monkeypatch):
    read = spec.load_module("metrics", name).read
    monkeypatch.setattr(profiling, "span_stats", lambda: dict(TABLE))
    assert read(_run(2)) == pytest.approx(want, rel=1e-12)
    assert read(_run(0)) is None
    monkeypatch.setattr(profiling, "span_stats",
                        lambda: {k: v for k, v in TABLE.items() if k != "sorted.prepare"})
    assert (read(_run(2)) is None) == (name == "prepare_host_ms.sorted")
    monkeypatch.delattr(profiling, "span_stats")  # a program without spans
    assert read(_run(2)) is None


def test_the_roofline_counts_walks_cameras_and_ray_state(monkeypatch):
    read = spec.load_module("metrics", "kernel_roofline.sorted").read
    monkeypatch.setattr(spheres_5k, "BOXES_PER_SEGMENT", 3.0)
    monkeypatch.setattr(spheres_5k, "TRIS_PER_SEGMENT", 10.0)
    seg, paths = 3_000_000, 2_000_000
    ops = (3.0 * seg * bounds.BOX_OPS + 10.0 * seg * bounds.TRI_OPS["parity"]
           + seg * (bounds.INV_DIR_OPS + bounds.SHADE_OPS) + paths * bounds.CAMERA_OPS)
    nbytes = bounds.RAY_STATE_BYTES * (seg + seg - paths)
    least_s = max(ops / bounds.H100_FP32_OPS, nbytes / bounds.H100_HBM_BYTES)
    device = [("void opt::sorted_bounce(float const*)", 0.0, 2000.0),
              ("at::native::vectorized_elementwise_kernel", 2000.0, 9000.0)]
    tr = SimpleNamespace(device_s=lambda match: sum(e - s for n, s, e in device
                                                    if match(n)) * 1e-6)
    got = read(_run(2, {"segments": seg, "paths": paths}, tr))
    assert got == pytest.approx(100.0 * least_s / 2e-3, rel=1e-12)
    assert read(_run(2, {"segments": seg, "paths": paths}, None)) is None
    assert read(_run(2, {}, tr)) is None


def test_the_frozen_counts_load_nothing_of_the_program():
    out = _python(
        "import sys\n"
        "import benchmark.counts.spheres_5k\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'oclpathtracer_tpu_torch',\n"
        "      'oclpathtracer_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_the_frozen_counts_function_runs_at_the_tiny_cells_size():
    counts = spheres_5k.measure("cpu", tiny.tiny_cell(CELL))
    assert counts["segments"] > 0 and counts["boxes"] > 1 and counts["tris"] > 0


@pytest.mark.parametrize("side, more", [(16, False), (48, True)])
def test_the_compared_pixels_are_drawn_among_scene_pixels(side, more):
    """At 16² the scene has fewer pixels than the cell compares, and all are taken."""
    cell = tiny.tiny_cell(CELL)
    cell.config.update(width=side, height=side)
    hits = sorted_jobs.scene_pixels(common.RenderCheck(cell, [], 1), CPU)
    wanted = cell.traffic["check_blocks"] * cell.traffic["block_pixels"]
    assert 0 < len(hits) < side * side and (len(hits) > wanted) == more
    entry = sorted_jobs.Entry(cell, 2**31 + 977, CPU)
    assert entry.blocks == sorted(set(entry.blocks)) and set(entry.blocks) <= set(hits)
    assert len(entry.blocks) == min(wanted, len(hits))
    assert entry.check.starts == entry.blocks and entry.check.size == 1
