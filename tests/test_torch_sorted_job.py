"""`render_sorted` as the benchmark's spheres-5k-sorted cell drives it: its spans
under a profiler (the skip-link build `sorted.prepare` once a call, `kernel.sorted`
once a chunk), its image and its segments against the benchmark's plain reference
(`benchmark/reference`) on the cell's scene shrunk as `benchmark/tiny.py` shrinks it,
within the cell's limits, and on a card the bounce kernel's launch counter. CPU tests
run the bounce kernel's plain version; the card's test (marker `cuda`) skips without
one, decided in its fixture. This file imports nothing of JAX, and of the benchmark
only its reference and the cell's limits file."""

import functools
import json
import pathlib

import pytest
import torch

from benchmark.reference import culled, procgen
from benchmark.reference import pathtrace as pt
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene.procgen import sphere_field

torch.set_num_threads(1)

EYE = (0.0, 3.0, 9.0)
CAMERA = CameraConfig(eye=EYE)
LIMITS = json.loads((pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "workloads"
                     / "spheres-5k-sorted.json").read_text())["limits"]
# The cell shrunk as benchmark/tiny.py shrinks it: 8 icospheres at subdivision 2,
# 16 x 16, 10 bounces, a job of 8 samples in calls of 4.
N_SPHERES, SUBDIVISIONS, SIDE, BOUNCES, JOB, CALL = 8, 2, 16, 10, 8, 4


def test_a_call_records_its_build_once_and_a_kernel_span_a_chunk():
    scene = sphere_field(3, 1, device="cpu")
    cfg = RenderConfig(width=16, height=16, bounces=4, camera=CAMERA)

    def call():
        return sw.render_sorted(scene, cfg, 6, samples_per_call=2)

    call()  # untraced first, as a benchmark's warm-up before its traced window
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        img = call()
    stats = profiling.span_stats()
    stages = ("bvh.build", "bvh.pack")  # the build's stages, inside sorted.prepare
    assert set(stats) == {"sorted.prepare", "kernel.sorted", *stages}
    assert stats["sorted.prepare"][0] == 1 and stats["kernel.sorted"][0] == 3
    assert all(stats[name][0] == 1 for name in stages)
    parents = {e.name: e.cpu_parent for e in prof.events()
               if e.name in ("sorted.prepare", "kernel.sorted", *stages)}
    assert parents["sorted.prepare"] is None and parents["kernel.sorted"] is None
    assert all(parents[name].name == "sorted.prepare" for name in stages)
    assert torch.equal(img, call())  # the span changes nothing of the image


@pytest.fixture(scope="module")
def tiny_cell():
    """The program's scene and settings, and the reference's float64 sums and segments
    over the job's samples at every pixel."""
    scene = sphere_field(N_SPHERES, SUBDIVISIONS, device="cpu")
    cfg = RenderConfig(width=SIDE, height=SIDE, bounces=BOUNCES, camera=CAMERA)
    sd = procgen.sphere_field(N_SPHERES, SUBDIVISIONS)
    every = torch.arange(SIDE * SIDE)
    sums, segs = pt.pixel_sums(
        pt.geometry(sd, "cpu"), pt.Render(SIDE, SIDE, BOUNCES, eye=EYE), every, 0, JOB,
        torch.as_tensor(sd.albedo), torch.as_tensor(sd.emissive),
        nearest=functools.partial(culled.nearest, balls=sd.balls))
    return scene, cfg, sums, segs


def test_the_image_is_the_references_mean_within_the_cells_limit(tiny_cell):
    scene, cfg, sums, _ = tiny_cell
    img = sw.render_sorted(scene, cfg, JOB, samples_per_call=CALL)
    ref = sums / JOB
    assert float(ref.sum()) > 0
    gap = float((img.double() - ref).norm() / ref.norm())
    assert gap <= LIMITS["image_rel_l2"]


def test_the_segments_are_the_references_within_the_cells_limit(tiny_cell):
    scene, cfg, _, segs = tiny_cell
    assert segs > cfg.n_pixels * JOB
    tb, nf, ni = bk.pack_bvh_scene(scene, leaf_size=32)
    got = sum(int(sw.render_samples_sorted_stats(tb, nf, ni, cfg, s, 1)[1])
              for s in range(JOB))
    assert abs(got - segs) / segs <= LIMITS["segments_gap"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bounce kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_call_on_the_card_makes_sixteen_bounce_launches(card):
    scene = sphere_field(3, 1, device=card)
    cfg = RenderConfig(width=16, height=16, bounces=16, camera=CAMERA)
    tb, nf, ni = bk.pack_bvh_scene(scene, leaf_size=32)
    before = profiling.counts()
    sw.render_samples_sorted_stats(tb, nf, ni, cfg, 0, 2)
    torch.cuda.synchronize(card)
    rose = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
            if k.startswith("launch.") and v != before.get(k, 0)}
    assert rose == {"launch.sorted": 16}
