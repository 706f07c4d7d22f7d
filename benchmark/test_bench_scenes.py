"""The harness's generated scenes: the reference's numpy `sphere_field` is the port's
bit for bit; the culled nearest hit is the full scan's, bit for bit; a cell's scene
comes from its file or its generator. CPU only, seconds."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference import culled, procgen
from benchmark.reference import pathtrace as pt
from benchmark.reference import scene as rs

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("args", [dict(n_spheres=3, subdivisions=1, seed=2), {},
                                  dict(n_spheres=80, subdivisions=3)])
def test_the_reference_sphere_field_is_the_ports_bitwise(args):
    from oclpathtracer_tpu_torch.scene import procgen as port

    ref = procgen.sphere_field(**args)
    got = port.sphere_field(**args, device="cpu")
    g, m = got.geometry, got.materials
    pairs = [(ref.p1, g.p1), (ref.p2, g.p2), (ref.p3, g.p3), (ref.albedo, m.albedo),
             (ref.emissive, m.emissive), (ref.roughness, m.roughness)]
    for a, b in pairs:
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    assert np.array_equal(ref.mat, g.mat_id.numpy()) and np.array_equal(ref.mtype,
                                                                         m.mtype.numpy())
    b = ref.balls
    assert b.first + b.center.shape[0] * b.per == ref.p1.shape[0]
    for j in range(b.center.shape[0]):  # each run's corners lie on its sphere
        run = np.stack([ref.p1, ref.p2, ref.p3], 1)[b.first + j * b.per:][:b.per]
        dist = np.linalg.norm(run.astype(np.float64) - b.center[j], axis=-1)
        assert np.abs(dist / b.radius[j] - 1).max() < 1e-5


def _rays(sd: rs.SceneData, n: int, seed: int):
    """n rays in four kinds: from anywhere over the field, aimed at a sphere's centre
    from outside, from a point on a sphere's triangle, from inside a sphere; each
    direction unit length in float32."""
    rnd = np.random.RandomState(seed)
    b = sd.balls
    k = n // 4
    anywhere = rnd.uniform([-6, -1, -6], [6, 9, 6], (k, 3))
    ball = rnd.randint(0, b.center.shape[0], 3 * k)
    aimed_from = b.center[ball[:k]] + rnd.normal(size=(k, 3)) * 3.0
    tri = b.first + ball[k:2 * k] * b.per + rnd.randint(0, b.per, k)
    w = rnd.dirichlet([1, 1, 1], k)
    on = (w[:, :1] * sd.p1[tri] + w[:, 1:2] * sd.p2[tri] + w[:, 2:] * sd.p3[tri])
    inside = b.center[ball[2 * k:]] + (rnd.uniform(-0.5, 0.5, (k, 3))
                                       * b.radius[ball[2 * k:], None])
    o = np.concatenate([anywhere, aimed_from, on, inside])
    d = np.concatenate([rnd.normal(size=(k, 3)), b.center[ball[:k]] - aimed_from,
                        rnd.normal(size=(2 * k, 3))])
    o, d = torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)
    return o, d / d.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("args", [dict(n_spheres=3, subdivisions=1, seed=2), {}])
def test_the_culled_nearest_is_the_full_scans_bitwise(args):
    sd = procgen.sphere_field(**args)
    g = pt.geometry(sd, "cpu")
    o, d = _rays(sd, 4096, 5)
    want = [torch.cat(x) for x in zip(*(pt.nearest(g, o[i:i + 256], d[i:i + 256])
                                         for i in range(0, 4096, 256)))]
    got = culled.nearest(g, o, d, sd.balls, block_tests=1 << 16)
    assert 0.2 < float(want[0].float().mean()) < 0.95  # both hits and misses
    for w, x in zip(want, got):
        assert w.dtype == x.dtype and torch.equal(w, x)


def test_a_file_scene_reads_as_before():
    cell = spec.load_cell("cornell-converge")
    sd = rs.scene_data(cell)
    want = rs.read_scene(os.path.join(spec.HERE, "data", "cornellbox.bin"))
    assert sd.p1.shape[0] == 36 and sd.albedo.shape[0] == 18 and sd.balls is None
    assert int(rs.material_classes(sd).max()) + 1 == 5  # five distinct material records
    assert all(np.array_equal(a, b) for a, b in zip(sd[:8], want[:8]))


def test_a_generator_scene_cell_added_as_files_only_is_found(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((here / "configs" / "spheres-102k-b16.json").read_text())
    config["scene"] = {"generator": "sphere_field", "seed": 3}
    (here / "configs" / "spheres-5k-b16.json").write_text(json.dumps(config))
    (here / "workloads" / "spheres-5k-converge.json").write_text(
        json.dumps({"limits": {"image_rel_l2": 1e-3, "segments_gap": 1e-3}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "spheres-5k-converge", "config": "spheres-5k-b16",
                               "traffic": "bvh-jobs", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "spheres-102k-converge" in m.get("workloads", []):
            m["workloads"].append("spheres-5k-converge")
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    cell = spec.load_cell("spheres-5k-converge", str(path), str(here))
    sd = rs.scene_data(cell)
    want = procgen.sphere_field(seed=3)
    assert sd.p1.shape[0] == 5124 and np.array_equal(sd.p1, want.p1)
    assert "render_mrays_s.bvh" in [m["name"] for m in cell.end_to_end]
    assert callable(spec.load_module("entries", cell.traffic["entry"], str(here)).Entry)


@pytest.mark.parametrize("name, eye", [("cornell-converge", (0.0, 2.75, 4.0)),
                                       ("spheres-102k-converge", (0.0, 3.0, 9.0))])
def test_the_configurations_camera_reaches_both_sides(name, eye):
    from benchmark import common, tiny

    cell = tiny.tiny_cell(name)
    _, cfg = common.program_scene(cell, "cpu")
    r = common.reference_render(cell)
    cam = cfg.camera
    assert cam.eye == r.eye == eye
    assert (cam.look, cam.up, cam.vfov_degrees) == (r.look, r.up, r.vfov)


def test_a_jobs_segment_count_is_the_drivers_and_the_references():
    from benchmark import common, compare, spec, tiny

    cell = tiny.tiny_cell("spheres-102k-converge")
    entry = spec.load_module("entries", "progressive_jobs").Entry(cell, 7, torch.device("cpu"))
    job = entry.job_spp
    assert entry.counts(3)["segments"] == 3 * entry.per_job
    every = torch.arange(cell.config["width"] * cell.config["height"])
    _, ref = common.RenderCheck(cell, [0], 1).sums("cpu", torch.float32, 0, job, every)
    assert compare.count_gap(entry.per_job, ref) <= cell.limits["segments_gap"]
