"""The port's bench (`oclpathtracer_tpu_torch/bench.py`, `python -m
oclpathtracer_tpu_torch bench`) on the CPU: its JSON line at 8×8, and its anchor
configurations against the JAX package's parity megakernel in interpret mode.

The auto configurations are held against JAX in tests/test_torch_bench_auto.py (a
file of its own, so that the two sets of interpret-mode calls, about 25-35 s each,
run on different workers). The bench's line on the card: tests/test_torch_cuda.py.
"""

import json
import math

import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu_torch import bench, cli
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)

# make_runs at 8×8: 2 bounces (the 4-bounce pair's stand-in) and 3 (the 16-bounce
# pair's), frames 1 and 2 (one warm-up frame, two timed).
W = H = 8
BOUNCES, BOUNCES_DEEP = 2, 3
SPP_WARM, SPP, SPP_DEEP = 1, 2, 2
KEYS = ("metric", "value", "unit", "anchor_value", "ratio_vs_anchor", "value_16b",
        "anchor_16b", "ratio_vs_anchor_16b")


@pytest.fixture(scope="module")
def runs():
    return bench.make_runs(load_cornell_box(device="cpu"), W, H, BOUNCES, BOUNCES_DEEP,
                           SPP_WARM, SPP, SPP_DEEP)


def test_run_prints_the_line_with_finite_rates(capsys):
    line = bench.run(W, H, BOUNCES, BOUNCES_DEEP, SPP_WARM, SPP, SPP_DEEP, pairs=2,
                     device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert tuple(line) == KEYS
    assert line["metric"] == "cornell_4bounce_path_trace" and line["unit"] == "Mrays/s"
    for key in KEYS[1:]:
        if key != "unit":
            assert math.isfinite(line[key]) and line[key] > 0, key


def test_make_runs_has_the_four_configurations(runs):
    assert tuple(runs) == ("anchor", "auto", "anchor16", "auto16")


@pytest.mark.parametrize("name,bounces,n", [("anchor", BOUNCES, SPP),
                                            ("anchor16", BOUNCES_DEEP, SPP_DEEP)])
def test_anchor_matches_jax_parity_megakernel(scene, runs, name, bounces, n):
    """The anchor against JAX's parity megakernel (interpret mode) on the same frames:
    segments equal, images rtol = atol = 1e-4 (tests/test_torch_megakernel.py's
    parity contract). The root bench runs JAX's anchor at interleave=8, a scheduling
    knob that moves no bit and needs 8 frames; 1 is used here, at 2 frames."""
    _, table, emi, classes = jmk.prepare_scan(scene, "parity")
    want, want_segs = jmk.render_samples_pallas_stats(
        table, JCfg(width=W, height=H, bounces=bounces), SPP_WARM, n, scan="parity",
        emi_const=emi, classes=classes, interleave=1, scan_chunks=1)
    img, segs = runs[name]()
    assert int(segs) == int(want_segs) > 0
    np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cli_bench_without_a_card_exits_2(capsys):
    assert cli.main(["bench"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
