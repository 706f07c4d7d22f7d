"""The path-regeneration kernel's plain version: k=1 is the megakernel bit for bit,
k=4 only reorders the sum, and it matches the JAX Pallas wavefront kernel
(interpret mode) at rtol=atol=1e-4 with equal segments; with the fast scan it meets
the JAX package's fast-vs-parity contract against the JAX parity twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu.kernels import wavefront as jwf
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wavefront as wf

torch.set_num_threads(1)

CFG = RenderConfig(width=24, height=20, bounces=5)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.mark.parametrize("scan", ["parity", "tp"])
def test_k1_equals_megakernel_bitwise(port_scene, scan):
    _, table, _, classes = mk.prepare_scan(port_scene, scan)
    img_m, segs_m = mk.render_samples_pallas_stats(table, CFG, 2, 3, scan=scan,
                                                   classes=classes, tp0=False)
    img_w, segs_w = wf.render_samples_wavefront_stats(table, CFG, 2, 3, interleave=1,
                                                      scan=scan, classes=classes)
    assert torch.equal(img_w, img_m)
    assert int(segs_w) == int(segs_m)


@pytest.mark.parametrize("k", [2, 4])
def test_interleave_only_reorders_the_sum(port_scene, k):
    table = mk.pack_scene(port_scene)
    img_1, segs_1 = wf.render_samples_wavefront_stats(table, CFG, 0, 6, interleave=1)
    img_k, segs_k = wf.render_samples_wavefront_stats(table, CFG, 0, 6, interleave=k)
    np.testing.assert_allclose(img_k.numpy(), img_1.numpy(), rtol=1e-5, atol=1e-5)
    assert int(segs_k) == int(segs_1)


def test_interleave_must_be_positive(port_scene):
    with pytest.raises(ValueError):
        wf.render_samples_wavefront_stats(mk.pack_scene(port_scene), CFG, 0, 1, interleave=0)


def test_plain_matches_jax_pallas_wavefront(scene, port_scene):
    jcfg = JCfg(width=32, height=32, bounces=2)
    cfg = RenderConfig(width=32, height=32, bounces=2)
    img_j, segs_j = jwf.render_samples_wavefront_stats(jmk.pack_scene(scene), jcfg, 0, 2,
                                                       interleave=1, scan="parity")
    img_t, segs_t = wf.render_samples_wavefront_stats(mk.pack_scene(port_scene), cfg, 0, 2,
                                                      interleave=1, scan="parity")
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)
    assert int(segs_t) == int(segs_j)
    assert wf.LAUNCHES == 0


@pytest.mark.parametrize("k", [1, 2])
def test_plain_fast_meets_jax_parity_contract(scene, port_scene, k):
    """The fast scan through the path-regeneration kernel's plain version against the
    JAX parity twin (32×32, 2 bounces, frames 0-2): |Δsegments| ≤ 2 and
    rtol = atol = 1e-4, the JAX package's fast-vs-parity contract."""
    jcfg = JCfg(width=32, height=32, bounces=2)
    ref = sum(np.asarray(jparity.render_sample_ref(scene, jcfg, f)) for f in range(3))
    ref_segs = int(jparity.count_segments_ref(scene, jcfg, jnp.arange(0, 3)))
    scan, table, emi, _ = mk.prepare_scan(port_scene, "fast")
    img, segs = wf.render_samples_wavefront_stats(table, RenderConfig(32, 32, bounces=2), 0, 3,
                                                  interleave=k, scan=scan, emi_const=emi)
    assert abs(int(segs) - ref_segs) <= 2
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-4, atol=1e-4)
