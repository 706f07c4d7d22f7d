"""The readers of the program's counters (`metrics/_counters.py`): each reads its two
counters of `runtime.profiling.counts()` after the window, and gives None where a
counter is missing, the denominator is 0, the window holds no unit, or the program
keeps no counters; and the reader of the BVH build's span (`metrics/_spans.py`) per
unit of the window."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from oclpathtracer_tpu_torch.runtime import profiling

# The 8-wide kernel's counters over a window (and a host counter beside them).
COUNTS = {
    "wide_bvh.walk_pops": 750, "wide_bvh.walk_slots": 1000,
    "wide_bvh.leaf_rows": 300, "wide_bvh.leaf_row_slots": 1200,
    "wide_bvh.expand_pops": 90, "wide_bvh.expand_slots": 320,
    "wide_bvh.boxes": 2500, "wide_bvh.shade_slots": 64, "wide_bvh.segments": 50,
    "launch.wide_bvh": 16,
}
# metric → (its value from COUNTS, the counters it reads)
WANT = {
    "walk_busy.widebvh": (75.0, ("wide_bvh.walk_pops", "wide_bvh.walk_slots")),
    "leaf_busy.widebvh": (25.0, ("wide_bvh.leaf_rows", "wide_bvh.leaf_row_slots")),
    "expand_busy.widebvh": (28.125, ("wide_bvh.expand_pops", "wide_bvh.expand_slots")),
    "shade_busy.widebvh": (78.125, ("wide_bvh.segments", "wide_bvh.shade_slots")),
    "boxes_seg.widebvh": (50.0, ("wide_bvh.boxes", "wide_bvh.segments")),
    "tris_seg.widebvh": (6.0, ("wide_bvh.leaf_rows", "wide_bvh.segments")),
}


def _run(units: int):
    return SimpleNamespace(window=SimpleNamespace(units=units, seconds=1.0), trace=None)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_gives_its_counters_ratio(name, monkeypatch):
    read = spec.load_module("metrics", name).read
    value, (num, den) = WANT[name]
    monkeypatch.setattr(profiling, "counts", lambda: dict(COUNTS))
    assert read(_run(4)) == pytest.approx(value, rel=1e-12)
    assert read(_run(0)) is None
    for missing in (num, den):
        monkeypatch.setattr(profiling, "counts",
                            lambda m=missing: {k: v for k, v in COUNTS.items() if k != m})
        assert read(_run(4)) is None
    monkeypatch.setattr(profiling, "counts", lambda: {**COUNTS, den: 0})
    assert read(_run(4)) is None
    monkeypatch.delattr(profiling, "counts")  # a program without counters
    assert read(_run(4)) is None


def test_the_build_reader_gives_the_build_span_per_unit(monkeypatch):
    read = spec.load_module("metrics", "build_host_ms.bvh").read
    table = {"driver.prepare": (4, 0.120, 0.004), "bvh.build": (4, 0.064, 0.064),
             "bvh.widen": (4, 0.008, 0.008), "bvh.pack": (4, 0.044, 0.044)}
    monkeypatch.setattr(profiling, "span_stats", lambda: dict(table))
    assert read(_run(4)) == pytest.approx(16.0, rel=1e-12)
    assert read(_run(0)) is None
    monkeypatch.setattr(profiling, "span_stats", lambda: {"driver.prepare": (4, 0.1, 0.1)})
    assert read(_run(4)) is None
    monkeypatch.delattr(profiling, "span_stats")
    assert read(_run(4)) is None
