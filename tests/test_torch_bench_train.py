"""The port's training-step benchmark (`oclpathtracer_tpu_torch/bench_train.py`) on
the CPU at 8×8, 1 bounce, 2 spp, 1 timed step: its five JSON lines, with the root
`bench_train.py`'s metric names and keys, and its segment window against the JAX
package's megakernel count."""

import json
import math

import torch

from oclpathtracer_tpu_torch import bench_train
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)

RATE_KEYS = ("metric", "value", "unit", "step_seconds", "loss", "speedup_vs_jnp")
VERTEX_KEYS = ("metric", "value", "unit", "loss", "speedup_vs_vertex_jnp")


def test_run_prints_the_five_lines(capsys):
    lines = bench_train.run(size=8, bounces=1, spp=2, steps=1, device="cpu")
    printed = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert printed == lines
    assert [x["metric"] for x in lines] == [
        "train_step_kernel", "train_step_hybrid", "train_step_jnp",
        "train_step_vertex_jnp", "train_step_vertex_kernel"]
    for x in lines[:3]:
        assert tuple(x) == RATE_KEYS and x["unit"] == "Mrays/s"
    for x in lines[3:]:
        assert tuple(x) == VERTEX_KEYS and x["unit"] == "ms/step"
    for x in lines:
        assert all(math.isfinite(v) for k, v in x.items() if k not in ("metric", "unit"))
        assert x["value"] > 0


def test_segments_per_window_is_the_jax_megakernel_count(scene):
    """bench_train.py:56-60's count (the JAX megakernel's tally, interpret mode) at
    8×8, 1 bounce, 2 frames."""
    from oclpathtracer_tpu import RenderConfig as JCfg
    from oclpathtracer_tpu.kernels import megakernel as jmk

    scan, table, emi, classes = jmk.prepare_scan(scene, "auto")
    _, want = jmk.render_samples_pallas_stats(table, JCfg(width=8, height=8, bounces=1), 0, 2,
                                              scan=scan, emi_const=emi, classes=classes)
    got = bench_train.segments_per_window(load_cornell_box(device="cpu"),
                                          RenderConfig(width=8, height=8, bounces=1), 2)
    assert got == int(want) > 0
