"""Each cell's run at a small size on the CPU (the port's kernels as their plain
versions): sound, it comes out correct; with each planted fault (`faults.py`), and
with the control (the reference in bfloat16 in the program's place), it does not.
One test runs a small cell on the card (marker `cuda`; it skips without one)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import control, faults, run, spec, tiny

BENCH = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 977  # more than 32 signed bits hold
CPU = torch.device("cpu")


def _units(cell) -> int:
    """Enough units for a finished image and one in progress."""
    return 2 * cell.traffic.get("frames_per_image", 1) + 1


def _fails(cell, numbers: dict) -> bool:
    return any(not (v <= cell.limits[k]) for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    cell = tiny.tiny_cell(name)
    res = run.run_cell(cell, SEED, 0.5, False, CPU, clock=lambda: 1.0)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    assert res["metrics"]["setup_s"]["value"] == 1.0
    assert set(res["metrics"]) <= {m["name"] for m in cell.end_to_end}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny.tiny_cell(name)
    r = control.readings(cell, SEED, 0.0, CPU, fault, units=_units(cell))
    numbers = {k: v for k, v in r.items() if k in cell.limits}
    assert _fails(cell, numbers), numbers


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny.tiny_cell(name)
    r = control.readings(cell, SEED, 0.0, CPU, "control", units=_units(cell))
    numbers = {k: v for k, v in r.items() if k in cell.limits}
    assert _fails(cell, numbers), numbers


def test_a_traced_run_reads_its_per_layer_metrics():
    cell = tiny.tiny_cell("inverse-kernel")
    res = run.run_cell(cell, SEED, 0.2, True, CPU, clock=lambda: 1.0)
    assert res["correct"]
    assert res["window_s"] > 0 and "breakdown" in res
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode here")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_cell_on_the_card_is_correct(card, name):
    cell = tiny.tiny_cell(name)
    res = run.run_cell(cell, SEED, 0.5, True, card, clock=lambda: 1.0)
    assert res["correct"], res["checks"]
    assert res["busy_s"] > 0
