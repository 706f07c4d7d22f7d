"""The readers of the program's spans (`metrics/_spans.py`): each reads its spans of
`runtime.profiling.span_stats()` per unit of the window, and gives None where the
table holds none of them, the window holds no unit, or the program keeps no table."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from oclpathtracer_tpu_torch.runtime import profiling

# {name: (calls, total_s, self_s)} of a window of 4 units.
TABLE = {
    "driver.prepare": (4, 0.008, 0.002),
    "driver.step": (4, 0.004, 0.001),
    "kernel.wavefront": (4, 0.003, 0.003),
    "kernel.grad": (16, 0.0024, 0.0024),
    "train.step": (4, 0.0040, 0.0004),
    "train.forward": (4, 0.0020, 0.0008),
    "train.backward": (4, 0.0012, 0.0002),
    "train.update": (4, 0.0004, 0.0004),
    "build.nvcc": (1, 9.0, 9.0),
}
# metric → its value in ms a unit from TABLE.
WANT = {
    "prepare_host_ms.render": 2.0,
    "driver_step_ms.frames": 1.0,
    "launch_host_ms.frames": (0.003 + 0.0024) / 4 * 1e3,
    "launch_host_ms.train": (0.003 + 0.0024) / 4 * 1e3,
    "step_self_ms.train": (0.0004 + 0.0008 + 0.0002 + 0.0004) / 4 * 1e3,
    "forward_host_ms.twin": 0.5,
    "backward_host_ms.twin": 0.3,
}


def _run(units: int):
    return SimpleNamespace(window=SimpleNamespace(units=units, seconds=1.0), trace=None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_gives_its_spans_per_unit(name, monkeypatch):
    read = spec.load_module("metrics", name).read
    monkeypatch.setattr(profiling, "span_stats", lambda: dict(TABLE))
    assert read(_run(4)) == pytest.approx(WANT[name], rel=1e-12)
    assert read(_run(0)) is None
    monkeypatch.setattr(profiling, "span_stats", lambda: {"build.nvcc": (1, 9.0, 9.0)})
    assert read(_run(4)) is None
    monkeypatch.delattr(profiling, "span_stats")  # a program without spans
    assert read(_run(4)) is None
