"""The arbitrary-ray kernel's plain PyTorch version (kernel 2, trace_rays) against
the JAX package: its Pallas kernel in interpret mode and its twin.

On CPU tensors `trace_rays_pallas_stats` runs the plain version; the CUDA kernel is
held against it on the card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances:
parity rtol=atol=1e-4 and segments equal (the JAX tests' rule for the kernel against
its twin); fast and tp under the JAX contract (megakernel.py's scan docstring:
hit decisions may move at ulp comparison boundaries), |Δsegments| ≤ 2 and
rtol=atol=1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.integrators.parity import ref_uniforms
from oclpathtracer_tpu.integrators.path import trace_paths
from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.kernels import megakernel as mk

torch.set_num_threads(1)

START = 1 << 20  # the vertex step's probe range
ROW_BASE = 7


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


def _rays(n: int, seed: int = 0):
    """Rays from the eye and from a point inside the box, in seeded random
    directions (tests/test_kernels.py's spread), as numpy (o, d) f32."""
    g = np.random.default_rng(seed)
    o = np.where((np.arange(n) % 2 == 0)[:, None], np.array([[0.0, 2.75, 4.0]]),
                 np.array([[0.3, 1.0, -1.0]])).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _port(port_scene, o, d, cfg, n_samples, scan="parity", **kw):
    _, table, emi, classes = mk.prepare_scan(port_scene, scan)
    img, segs = mk.trace_rays_pallas_stats(table, torch.from_numpy(o), torch.from_numpy(d), cfg,
                                           n_samples, scan=scan, classes=classes,
                                           emi_const=emi, **kw)
    return img.numpy(), int(segs)


def test_plain_matches_jax_interpret_kernel(scene, port_scene):
    """300 rows (no block multiple), row_base 7, samples from 2^20, 2 bounces, 1 spp:
    the JAX Pallas kernel in interpret mode (about 17 s on a CPU, so one call)."""
    o, d = _rays(300, seed=1)
    jimg, jsegs = jmk.trace_rays_pallas_stats(jmk.pack_scene(scene), jnp.asarray(o),
                                              jnp.asarray(d), JCfg(width=8, height=8,
                                                                   bounces=2),
                                              1, row_base=ROW_BASE, start_sample=START)
    img, segs = _port(port_scene, o, d, RenderConfig(width=8, height=8, bounces=2), 1,
                      row_base=ROW_BASE, start_sample=START)
    np.testing.assert_allclose(img, np.asarray(jimg), rtol=1e-4, atol=1e-4)
    assert segs == int(jsegs)


@pytest.mark.parametrize("scan", ["parity", "fast", "tp"])
def test_plain_matches_jax_twin(scene, port_scene, scan):
    """1,500 rows, 3 bounces, 2 spp against the JAX twin of kernel 2: trace_paths on
    ref_uniforms(row_base + row, START + s, 2·bounces), summed over samples."""
    n, b, spp = 1500, 3, 2
    o, d = _rays(n)
    rows = jnp.arange(n, dtype=jnp.int32) + ROW_BASE
    ref = np.zeros((n, 3), np.float32)
    ref_segs = 0
    for s in range(spp):
        us = ref_uniforms(rows, START + s, 2 * b)
        rad, stats = trace_paths(jnp.asarray(o), jnp.asarray(d), scene, us.reshape(n, b, 2),
                                 JCfg(width=8, height=8, bounces=b))
        ref = ref + np.asarray(rad)
        ref_segs += int(stats["segments"])
    img, segs = _port(port_scene, o, d, RenderConfig(width=8, height=8, bounces=b), spp,
                      scan=scan, row_base=ROW_BASE, start_sample=START)
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4)
    assert segs > n
    if scan == "parity":
        assert segs == ref_segs
    else:
        assert abs(segs - ref_segs) <= 2


def test_equal_rows_share_streams(port_scene):
    """Two calls with the same rows give the same bits (the CRN pairing of the ±
    probes); moving row_base moves the streams."""
    o, d = _rays(257, seed=2)
    cfg = RenderConfig(width=4, height=4, bounces=3)
    a = _port(port_scene, o, d, cfg, 2, row_base=3, start_sample=START)
    b = _port(port_scene, o, d, cfg, 2, row_base=3, start_sample=START)
    c = _port(port_scene, o, d, cfg, 2, row_base=4, start_sample=START)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert not np.array_equal(a[0], c[0])


def test_wrapper_checks_its_inputs(port_scene):
    table = mk.pack_scene(port_scene)
    o, d = (torch.from_numpy(x) for x in _rays(8))
    cfg = RenderConfig(width=4, height=4, bounces=2)
    with pytest.raises(ValueError):
        mk.trace_rays_pallas_stats(table, o.t().contiguous().t(), d, cfg, 1)
    with pytest.raises(ValueError):
        mk.trace_rays_pallas_stats(table, o[:4], d, cfg, 1)
    with pytest.raises(ValueError):
        mk.trace_rays_pallas_stats(table, o, d, cfg, 1, scan="bogus")
