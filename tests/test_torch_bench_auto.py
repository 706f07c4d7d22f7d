"""The port bench's auto configurations (the tp megakernel with the tp0 peel at the
shallow depth, the tp path-regeneration kernel at the deep one) against the JAX
package's tp wavefront (interpret mode) on the same frames, at 8×8: segments equal,
images rtol = atol = 1e-4 (tests/test_torch_megakernel.py's contract). The anchor
configurations and the bench's line: tests/test_torch_bench.py.
"""

import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu.kernels import wavefront as jwf
from oclpathtracer_tpu_torch import bench
from oclpathtracer_tpu_torch.scene import load_cornell_box

torch.set_num_threads(1)

W = H = 8
BOUNCES, BOUNCES_DEEP = 2, 3
SPP_WARM, SPP, SPP_DEEP = 1, 2, 2


@pytest.fixture(scope="module")
def runs():
    return bench.make_runs(load_cornell_box(device="cpu"), W, H, BOUNCES, BOUNCES_DEEP,
                           SPP_WARM, SPP, SPP_DEEP)


@pytest.mark.parametrize("name,bounces,n", [("auto", BOUNCES, SPP),
                                            ("auto16", BOUNCES_DEEP, SPP_DEEP)])
def test_auto_matches_jax_tp_wavefront(scene, runs, name, bounces, n):
    scan, table, emi, classes = jmk.prepare_scan(scene, "auto")
    assert scan == "tp"
    want, want_segs = jwf.render_samples_wavefront_stats(
        table, JCfg(width=W, height=H, bounces=bounces), SPP_WARM, n, scan=scan,
        emi_const=emi, classes=classes, interleave=1)
    img, segs = runs[name]()
    assert int(segs) == int(want_segs) > 0
    np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
