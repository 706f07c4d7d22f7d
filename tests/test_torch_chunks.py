"""Each kernel backend's progressive render is its `prepare_chunks` and one loop,
`megakernel.mean_of_chunks`; the driver's steps run the same chunks. The AO and
direct-NEE kernels' chunks return the rays they cast where the others return segments.

Cornell box, 8×8, 2 bounces, 5 spp in calls of 2 (samples 0-1, 2-3 and 4), on the
CPU (the kernels' plain versions). The expected images are the stats entries' chunk
images on tables made by the table makers, added in order to zeros: each public
function must give them bit for bit, and each chunk the entry's segment count.
"""

import pytest
import torch

from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import fast_integrators as fi
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw
from oclpathtracer_tpu_torch.kernels import wavefront as wf
from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
from oclpathtracer_tpu_torch.parallel.mesh import Mesh
from oclpathtracer_tpu_torch.parallel.sharded_pallas import (
    make_sharded_kernel_step,
    render_pallas_sharded,
)
from oclpathtracer_tpu_torch.render import driver
from oclpathtracer_tpu_torch.render.accumulate import Accumulator
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)

CFG = RenderConfig(8, 8, bounces=2)
TOTAL, PER_CALL = 5, 2
CHUNKS = [(0, 2), (2, 2), (4, 1)]
MESH = Mesh(("cpu",) * 2)
WIDE_LEAF = 32  # the driver's 8-wide leaf below the auto route's range: the Cornell box's
SORTED_LEAF = 32  # render_sorted's default
DRIVER_BACKENDS = ("pallas", "wavefront", "bvh", "widebvh")


@pytest.fixture(scope="module")
def box():
    return load_cornell_box(device="cpu")


def _entry(scene, backend):
    """(start, n) → (SUM image, segments) of the backend's stats entry."""
    if backend == "ao":
        table = mk.pack_scene(scene)
        return lambda s, n: fi.render_ao_stats(table, CFG, s, n)
    if backend == "direct":
        table = mk.pack_scene(scene)
        lights, area = fi.pack_lights(scene)
        return lambda s, n: fi.render_direct_stats(table, lights, area, CFG, s, n)
    if backend in ("pallas", "sharded", "wavefront"):
        scan, table, emi, classes = mk.prepare_scan(scene)
        fn = (wf.render_samples_wavefront_stats if backend == "wavefront"
              else mk.render_samples_pallas_stats)
        return lambda s, n: fn(table, CFG, s, n, scan=scan, classes=classes, emi_const=emi)
    if backend == "bvh":
        scan, table, nf, ni, emi, classes = bk.prepare_bvh_scan(scene,
                                                                leaf_size=driver.BVH_LEAF)
        return lambda s, n: bk.render_samples_bvh_stats(table, nf, ni, CFG, s, n,
                                                        max_leaf=driver.BVH_LEAF, scan=scan,
                                                        emi_const=emi, classes=classes)
    if backend == "widebvh":
        scan = mk.resolve_scan(scene)
        emi = mk.scene_emissive_const(scene) if scan == "fast" else mk.NO_EMI
        table, wn_f, wn_i, depth, classes = wb.pack_wide_bvh_scene(scene, WIDE_LEAF, scan)
        return lambda s, n: wb.render_samples_wide_bvh_stats(
            table, wn_f, wn_i, CFG, s, n, max_leaf=WIDE_LEAF, max_depth=depth, scan=scan,
            emi_const=emi, classes=classes)
    table, nf, ni = bk.pack_bvh_scene(scene, leaf_size=SORTED_LEAF)
    return lambda s, n: sw.render_samples_sorted_stats(table, nf, ni, CFG, s, n,
                                                       max_leaf=SORTED_LEAF)


def _prepared(scene, backend):
    """The chunk the backend's own preparation makes."""
    if backend == "sharded":
        scan, table, emi, classes = mk.prepare_scan(scene)
        return lambda s, n: make_sharded_kernel_step(CFG, MESH, n, scan=scan, emi_const=emi,
                                                     classes=classes)(table, s)
    return {"pallas": lambda: mk.prepare_chunks(scene, CFG),
            "wavefront": lambda: wf.prepare_chunks(scene, CFG),
            "bvh": lambda: bk.prepare_chunks(scene, CFG, leaf_size=driver.BVH_LEAF),
            "widebvh": lambda: wb.prepare_chunks(scene, CFG, leaf_size=WIDE_LEAF),
            "sorted": lambda: sw.prepare_chunks(scene, CFG),
            "ao": lambda: fi.prepare_chunks(scene, CFG, "ao"),
            "direct": lambda: fi.prepare_chunks(scene, CFG, "direct")}[backend]()


def _public(scene, backend):
    """The public progressive function at TOTAL samples in calls of PER_CALL; the
    8-wide kernel's is the driver's loop on its preparation."""
    if backend == "widebvh":
        return mk.mean_of_chunks(driver.prepare_chunks(scene, CFG, "widebvh"), CFG, TOTAL,
                                 PER_CALL, "cpu")
    return {"pallas": lambda: mk.render_pallas(scene, CFG, TOTAL, samples_per_call=PER_CALL),
            "wavefront": lambda: wf.render_wavefront(scene, CFG, TOTAL,
                                                     samples_per_call=PER_CALL),
            "bvh": lambda: bk.render_bvh(scene, CFG, TOTAL, samples_per_call=PER_CALL,
                                         leaf_size=driver.BVH_LEAF),
            "sorted": lambda: sw.render_sorted(scene, CFG, TOTAL, samples_per_call=PER_CALL),
            "sharded": lambda: render_pallas_sharded(scene, CFG, MESH, TOTAL,
                                                     samples_per_call=PER_CALL),
            "ao": lambda: fi.render_ao(scene, CFG, TOTAL, samples_per_call=PER_CALL),
            "direct": lambda: fi.render_direct(scene, CFG, TOTAL,
                                               samples_per_call=PER_CALL)}[backend]()


@pytest.mark.parametrize("backend", ["pallas", "wavefront", "bvh", "widebvh", "sorted",
                                     "sharded", "ao", "direct"])
def test_progressive_render_is_the_running_sum_of_its_chunks(box, backend):
    entry = _entry(box, backend)
    chunks = [entry(s, n) for s, n in CHUNKS]
    running, sums = torch.zeros((CFG.n_pixels, 3)), []
    for img, _ in chunks:
        running = running + img
        sums.append(running)

    prepared = _prepared(box, backend)
    for (s, n), (img, segs) in zip(CHUNKS, chunks):
        got_img, got_segs = prepared(s, n)
        assert torch.equal(got_img, img) and int(got_segs) == int(segs) > 0
    assert torch.equal(_public(box, backend), sums[-1] / TOTAL)

    if backend not in DRIVER_BACKENDS:
        return
    acc = Accumulator.zeros(CFG.n_pixels, "cpu")
    for (s, n), want in zip(CHUNKS, sums):
        acc = driver.make_kernel_render_step(box, CFG, n, backend=backend)(acc, s)
        assert torch.equal(acc.sum, want)
    assert int(acc.count) == TOTAL
    two_steps = driver.render_progressive(box, CFG, 4, samples_per_step=2, backend=backend)
    assert torch.equal(two_steps, sums[1] / 4)
