"""The port's examples (`oclpathtracer_tpu_torch/examples/`) and bench_scaling on the
CPU: each example's main() at a tiny size on `--device cpu` (the kernels' plain
versions), and bench_scaling's line there; without a card its default exits 2, as
the CLI's `bench` does. On the card chip_smoke.py drives the functions the examples
call (phases 4b, 4c and the sharded phase)."""

import json
import math

import pytest
import torch

from oclpathtracer_tpu_torch import bench_scaling
from oclpathtracer_tpu_torch.examples import (
    inverse_albedo,
    multi_device,
    train_kernel,
    train_vertices,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_scene_cpu():
    from oclpathtracer_tpu_torch.scene import load_cornell_box

    return load_cornell_box(device="cpu")


def test_multi_device_is_bitwise_and_writes_the_png(tmp_path, capsys):
    out = tmp_path / "md.png"
    assert multi_device.main(["--device", "cpu", "--size", "12", "--bounces", "2",
                              "--spp", "2", "--samples-per-step", "1", "--entries", "8",
                              "-o", str(out)]) == 0
    text = capsys.readouterr().out
    assert "mesh: 8 entries over ['cpu']" in text
    assert "sharded == single-device bitwise: True" in text
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_inverse_albedo_runs(capsys):
    assert inverse_albedo.main(["--device", "cpu", "--size", "8", "--steps", "2",
                                "--spp", "1", "--target-spp", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("albedo error: 0.2000 -> ")
    assert lines[-1].startswith("image MSE vs truth: init ")


def test_train_kernel_runs(capsys):
    assert train_kernel.main(["--device", "cpu", "--size", "8", "--steps", "3", "--spp", "1",
                              "--target-spp", "2", "--bounces", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [x.split()[1] for x in lines[:-1]] == ["0", "2"]
    assert lines[-1].startswith("class-albedo error: 0.2")


def test_train_vertices_defaults_to_sgd_and_runs(monkeypatch, capsys):
    """The default run is SGD at 2e-4, the one that recovers in both packages."""
    made = []

    def recording(cls):
        return lambda tensors, lr: made.append((cls, lr)) or cls(tensors, lr=lr)

    monkeypatch.setattr(train_vertices, "OPTIMIZERS",
                        {k: recording(v) for k, v in train_vertices.OPTIMIZERS.items()})
    assert train_vertices.main(["--device", "cpu", "--size", "8", "--steps", "10",
                                "--spp", "1"]) == 0
    assert made == [(torch.optim.SGD, 2e-4)]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "initial light-vertex error: 0.1000 world units"
    assert lines[1].startswith("step  10  loss ")
    assert "light-vertex error 0.1000 -> " in lines[2]


def test_train_vertices_setup_moves_only_the_light(port_scene_cpu):
    step, init, params, target, key, true_v = train_vertices.setup(
        port_scene_cpu, 8, 1, torch.optim.SGD, 0.3)
    moved = [(v - t).abs().sum(dim=1) > 0 for v, t in zip(params.vertices, true_v)]
    assert all(m.nonzero().flatten().tolist() == list(train_vertices.LIGHT_TRIS)
               for m in moved)
    assert train_vertices.light_error(params, true_v) == pytest.approx(0.1, abs=1e-6)
    assert target.shape == (64, 3) and key.device.type == "cpu"


def test_bench_scaling_on_the_host(capsys):
    assert bench_scaling.main(["--device", "cpu", "--width", "8", "--height", "8",
                               "--spp", "1", "--bounces", "2"]) == 0
    (line,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert tuple(line) == ("devices", "mrays_per_s", "efficiency_vs_1")
    assert line["devices"] == 1 and line["efficiency_vs_1"] == 1.0
    assert math.isfinite(line["mrays_per_s"]) and line["mrays_per_s"] > 0


def test_bench_scaling_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_scaling.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
