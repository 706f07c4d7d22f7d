"""The harness finds what belongs to a cell by name, from files alone; its frozen
operation counts are the program's today; nothing it runs loads JAX or the JAX
package, and its reference loads nothing of the program. CPU only, seconds."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.reference import scene as rs

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = spec.load_cell(name)
    assert callable(spec.load_module("entries", cell.traffic["entry"]).Entry)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert rs.scene_data(cell).p1.shape[0] >= 1 and cell.limits


def test_a_cell_added_as_files_only_is_found(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((here / "configs" / "cornell-512-b16.json").read_text())
    (here / "configs" / "cornell-256-b16.json").write_text(json.dumps({**config, "width": 256}))
    (here / "traffic" / "short-jobs.json").write_text(json.dumps(
        {**json.loads((here / "traffic" / "converge-jobs.json").read_text()), "job_spp": 128}))
    (here / "workloads" / "cornell-256-short.json").write_text(
        json.dumps({"limits": {"image_rel_l2": 1e-3, "segments_gap": 1e-3}}))
    (here / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return run.window.units\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cornell-256-short", "config": "cornell-256-b16",
                               "traffic": "short-jobs", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("render_mrays_s", "kernel_roofline.render"):
            m["workloads"].append("cornell-256-short")
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "driver",
                               "moves": "render_mrays_s", "workloads": ["cornell-256-short"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    cell = spec.load_cell("cornell-256-short", str(path), str(here))
    assert cell.config["width"] == 256 and cell.traffic["job_spp"] == 128
    assert [m["name"] for m in cell.per_layer] == ["kernel_roofline.render", "jobs_done"]
    assert spec.load_module("metrics", "jobs_done", str(here)).read(
        type("R", (), {"window": type("W", (), {"units": 7})})) == 7
    assert "render_mrays_s" in [m["name"] for m in cell.end_to_end]


def test_frozen_counts_are_the_programs_today():
    from benchmark.counts import bounds as frozen
    from oclpathtracer_tpu_torch.kernels import bounds as program

    names = [n for n in dir(program) if n.isupper()]
    assert names and all(getattr(frozen, n) == getattr(program, n) for n in names)
    for scan in ("parity", "fast", "tp"):
        for tp0 in (False, True):
            args = (scan, 36, 109_570_969, 16_777_216, tp0, 5)
            assert frozen.linear_ops(*args) == program.linear_ops(*args)
        assert frozen.bvh_ops(scan, 1e9, 2e9, 3_000_000, 4) == program.bvh_ops(
            scan, 1e9, 2e9, 3_000_000, 4)
    assert frozen.adjoint_ops(5, 12_345_678) == program.adjoint_ops(5, 12_345_678)
    counts = {"camera": 10, "eye_rows": 20, "tris": 300, "rays": 9, "hits": 8, "lit": 7}
    for kind in ("ao", "direct"):
        assert frozen.fast_ops(kind, counts, 2) == program.fast_ops(kind, counts, 2)
    assert frozen.bound_ms(1e12, 1e9) == program.bound_ms(1e12, 1e9)


def _python(code: str, cwd=spec.ROOT):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(cwd)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of a small cell on the CPU, then the harness's own check of
    sys.modules: top-level names compared whole (the port's name begins with the JAX
    package's)."""
    out = _python(
        "import sys, torch\n"
        "from benchmark import run, tiny\n"
        "res = run.run_cell(tiny.tiny_cell('inverse-kernel'), 7, 0.2, False,\n"
        "                   torch.device('cpu'), clock=lambda: 0.0)\n"
        "assert res['correct'], res\n"
        "assert 'oclpathtracer_tpu_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_nothing_of_the_program():
    out = _python(
        "import sys\n"
        "import benchmark.reference.pathtrace, benchmark.reference.streams\n"
        "import benchmark.reference.scene, benchmark.compare, benchmark.counts.bounds\n"
        "import benchmark.reference.procgen, benchmark.reference.culled\n"
        "import benchmark.counts.spheres_102k\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'oclpathtracer_tpu_torch',\n"
        "      'oclpathtracer_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def _cli(cwd):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(cwd)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "cornell-converge", "--seed", "2147483999", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_without_a_card_it_prints_no_result_and_fails():
    out = _cli(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_with_the_benchmark_alone_it_prints_no_result_and_fails(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
