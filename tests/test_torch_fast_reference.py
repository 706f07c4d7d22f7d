"""The port's AO and direct-NEE passes (`kernels/fast_integrators.render_ao`,
`render_direct`) against the benchmark's plain reference of them
(benchmark/reference/fast.py, written from the integrators' definition, nothing of
the port) on the CPU, where the kernels run their plain versions, split as the
kernels split: 32×32 at 4 spp on the Cornell box and on a seeded sphere_field(2, 0),
which has one area light (the reference builds it with `reference/procgen.py`), seen
from the procedural scenes' camera.

Tolerance. Both sides trace the same rays on the same LCG streams in float32 and make
the same decisions; they differ in rounding alone (the reference takes its dot
products and its light pick with other operations in another order). Measured here:
the AO images equal, the direct images within 2.5e-8 (rel-L2). A single sample whose
occlusion or light pick flips moves the rel-L2 of these images by more than 1e-3, so
the limit, 1e-5, keeps a wide margin above rounding and none for a changed decision.
The reference in bfloat16 (the benchmark's control) reads 0.077 (AO) and 0.30
(direct) on the Cornell box and 0.10 (direct) on the sphere field: each fails it. On
the sphere field few camera rays hit from this eye (about 30 of 4,096) and the AO
image of the bfloat16 reference equals the float32 one, so that case is left out of
the control's test.
"""

import os

import pytest
import torch

from benchmark.reference import fast as rf
from benchmark.reference import pathtrace as pt
from benchmark.reference import procgen
from benchmark.reference import scene as rs
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.kernels import fast_integrators as fi
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.scene import load_cornell_box
from oclpathtracer_tpu_torch.scene.procgen import sphere_field

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FILE = os.path.join(ROOT, "benchmark", "data", "cornellbox.bin")
SIZE, SPP = 32, 4
LIMIT = 1e-5
SPHERES_SEED = 5
PROCGEN_EYE = (0.0, 3.0, 9.0)
SCENES = ("cornell", "spheres")


@pytest.fixture(scope="module")
def scenes():
    """name → (the port's scene, its RenderConfig, the reference's SceneData, Render)."""
    return {
        "cornell": (load_cornell_box(device="cpu"), RenderConfig(width=SIZE, height=SIZE),
                    rs.read_scene(SCENE_FILE), pt.Render(SIZE, SIZE, 16)),
        "spheres": (sphere_field(2, 0, seed=SPHERES_SEED, device="cpu"),
                    RenderConfig(width=SIZE, height=SIZE,
                                 camera=CameraConfig(eye=PROCGEN_EYE)),
                    procgen.sphere_field(2, 0, seed=SPHERES_SEED),
                    pt.Render(SIZE, SIZE, 16, eye=PROCGEN_EYE)),
    }


def _port(scenes, name, kind):
    """(the port's mean image, its rays cast over the SPP samples)."""
    scene, cfg, _, _ = scenes[name]
    render = fi.render_ao if kind == "ao" else fi.render_direct
    _, rays = fi.prepare_chunks(scene, cfg, kind)(0, SPP)
    return render(scene, cfg, SPP), int(rays)


def _reference(scenes, name, kind, dtype=torch.float32):
    """(the reference's mean image, its rays cast)."""
    _, _, sd, r = scenes[name]
    sums, counts = rf.pixel_sums(kind, sd, r, torch.arange(SIZE * SIZE), 0, SPP, dtype)
    return sums / SPP, rf.rays_cast(counts)


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("kind", rf.KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_the_pass_matches_the_plain_reference_and_casts_its_rays(scenes, name, kind):
    img, rays = _port(scenes, name, kind)
    ref, ref_rays = _reference(scenes, name, kind)
    assert _rel_l2(img, ref) <= LIMIT
    assert rays == ref_rays > SIZE * SIZE * SPP


@pytest.mark.parametrize("name, kind", [("cornell", "ao"), ("cornell", "direct"),
                                        ("spheres", "direct")])
def test_the_bfloat16_reference_fails_the_limit(scenes, name, kind):
    ref, _ = _reference(scenes, name, kind)
    low, _ = _reference(scenes, name, kind, torch.bfloat16)
    assert _rel_l2(low, ref) > 100 * LIMIT


@pytest.mark.parametrize("kind", rf.KINDS)
def test_the_render_is_the_old_single_call_divided_bitwise(scenes, kind):
    """The CLI's images before the seam: one launch of every sample, divided by spp."""
    scene, cfg, _, _ = scenes["cornell"]
    table = mk.pack_scene(scene)
    if kind == "ao":
        old = fi.render_ao_pallas(table, cfg, 0, SPP) / SPP
        new = fi.render_ao(scene, cfg, SPP)
    else:
        lights, area = fi.pack_lights(scene)
        old = fi.render_direct_pallas(table, lights, area, cfg, 0, SPP) / SPP
        new = fi.render_direct(scene, cfg, SPP)
    assert torch.equal(new, old)


@pytest.mark.parametrize("kind", rf.KINDS)
def test_the_rays_are_the_plain_versions_counts_on_a_pixel_window(scenes, kind):
    """The stats entry's count on pixels [100, 100 + 77) is the camera rays and the
    second rays its plain version counted, and the reference's over those pixels."""
    scene, cfg, sd, r = scenes["cornell"]
    table = mk.pack_scene(scene)
    counts = fi._new_counts()
    if kind == "ao":
        _, rays = fi.render_ao_stats(table, cfg, 3, SPP, pid_base=100, n_rays=77)
        fi._render_ao_plain(table, cfg, 3, SPP, pid_base=100, n_rays=77, counts=counts,
                            lanes=fi.ao_lanes(SPP))
    else:
        lights, area = fi.pack_lights(scene)
        _, rays = fi.render_direct_stats(table, lights, area, cfg, 3, SPP, pid_base=100,
                                         n_rays=77)
        fi._render_direct_plain(table, lights, area, cfg, 3, SPP, pid_base=100, n_rays=77,
                                counts=counts)
    _, ref = rf.pixel_sums(kind, sd, r, torch.arange(100, 177), 3, SPP)
    assert rays.dtype == torch.int64 and rays.shape == ()
    assert int(rays) == fi.rays_cast(counts) == rf.rays_cast(ref)
    assert {k: counts[k] for k in ("camera", "hits", "rays", "tris", "lit")} == ref
