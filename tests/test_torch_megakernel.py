"""The megakernel's plain PyTorch version against the JAX parity twin.

On CPU tensors `render_samples_pallas_stats` runs the plain version (the CUDA kernel
is held against it on the card: tests/test_torch_cuda.py, chip_smoke.py). Parity:
rtol=atol=1e-4 as tests/test_kernels.py holds the Pallas kernel, and segments
exactly equal. tp (tp0 on and off) and fast: the JAX package's tp/fast-vs-parity
contract, |Δsegments| ≤ 2 and rtol=atol=1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.kernels import megakernel as mk

torch.set_num_threads(1)

W, H, B = 32, 32, 3
START, N = 5, 2
JCFG = JCfg(width=W, height=H, bounces=B)
CFG = RenderConfig(width=W, height=H, bounces=B)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.fixture(scope="module")
def reference(scene):
    """JAX render_sample_ref summed over frames START..START+N-1, and its segments."""
    img = sum(np.asarray(jparity.render_sample_ref(scene, JCFG, f))
              for f in range(START, START + N))
    segs = int(jparity.count_segments_ref(scene, JCFG, jnp.arange(START, START + N)))
    return img, segs


def test_plain_parity_matches_jax_twin(port_scene, reference):
    img, segs = mk.render_samples_pallas_stats(mk.pack_scene(port_scene), CFG, START, N,
                                               scan="parity")
    np.testing.assert_allclose(img.numpy(), reference[0], rtol=1e-4, atol=1e-4)
    assert int(segs) == reference[1]
    assert segs.dtype == torch.int64


def test_plain_parity_sub_range(scene, port_scene):
    """pid_base/n_rays render a slice keyed on absolute pixel ids."""
    base, n = 100, 300
    pids = jnp.arange(base, base + n, dtype=jnp.int32)
    ref, segs_ref = np.zeros((n, 3), np.float32), 0
    for f in range(START, START + N):
        r, st = jparity.render_sample_ref(scene, JCFG, f, pixel_ids=pids, with_stats=True)
        ref = ref + np.asarray(r)
        segs_ref += int(st["segments"])
    img, segs = mk.render_samples_pallas_stats(mk.pack_scene(port_scene), CFG, START, N,
                                               pid_base=base, n_rays=n, scan="parity")
    assert img.shape == (n, 3)
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert int(segs) == segs_ref


@pytest.mark.parametrize("tp0", [True, False])
def test_plain_tp_meets_parity_contract(port_scene, reference, tp0):
    scan, table, _, classes = mk.prepare_scan(port_scene, "tp")
    assert mk.tp0_enabled(scan, tp0, table.shape[0], CFG.bounces) == tp0
    img, segs = mk.render_samples_pallas_stats(table, CFG, START, N, scan="tp",
                                               classes=classes, tp0=tp0)
    assert abs(int(segs) - reference[1]) <= 2
    np.testing.assert_allclose(img.numpy(), reference[0], rtol=1e-4, atol=1e-4)


def test_plain_fast_meets_parity_contract(port_scene, reference):
    """The division-free fast scan against the JAX parity twin: the JAX package's
    fast-vs-parity contract (tests/test_kernels.py), |Δsegments| ≤ 2 and
    rtol = atol = 1e-4."""
    scan, table, emi, classes = mk.prepare_scan(port_scene, "fast")
    assert scan == "fast" and emi == (30.0, 30.0, 30.0) and classes == ()
    img, segs = mk.render_samples_pallas_stats(table, CFG, START, N, scan=scan, emi_const=emi)
    assert abs(int(segs) - reference[1]) <= 2
    np.testing.assert_allclose(img.numpy(), reference[0], rtol=1e-4, atol=1e-4)


def test_plain_fast_matches_jax_fast_megakernel(scene, port_scene):
    """Against the JAX package's own fast-scan kernel (interpret mode; 16×16,
    2 bounces, 1 spp), whose fused-code decode rounds the roughness as the port's
    does: segments equal, rtol = atol = 1e-4."""
    jscan, jtable, jemi, _ = jmk.prepare_scan(scene, "fast")
    img_j, segs_j = jmk.render_samples_pallas_stats(jtable, JCfg(width=16, height=16,
                                                                 bounces=2),
                                                    0, 1, scan=jscan, emi_const=jemi)
    scan, table, emi, _ = mk.prepare_scan(port_scene, "fast")
    assert emi == jemi
    img, segs = mk.render_samples_pallas_stats(table, RenderConfig(width=16, height=16,
                                                                   bounces=2),
                                               0, 1, scan=scan, emi_const=emi)
    assert int(segs) == int(segs_j)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)


def test_cpu_tensors_never_launch(port_scene):
    before = mk.LAUNCHES
    mk.render_samples_pallas_stats(mk.pack_scene(port_scene), RenderConfig(8, 8, bounces=1),
                                   0, 1)
    assert mk.LAUNCHES == before == 0


def test_tp0_gate():
    assert mk.tp0_enabled("tp", True, 36, 8)
    assert not mk.tp0_enabled("tp", True, 36, 9)
    assert not mk.tp0_enabled("tp", True, 129, 4)
    assert not mk.tp0_enabled("parity", True, 36, 4)
    assert not mk.tp0_enabled("tp", False, 36, 4)


def test_tp0_table_made_once_is_what_each_launch_would_make(port_scene):
    """A render passes tp0_table_for's table to every launch; the result is bitwise
    the launch that augments the table itself. Outside the gate there is none."""
    cfg = RenderConfig(width=8, height=6, bounces=2)
    scan, table, _, classes = mk.prepare_scan(port_scene, "tp")
    tp0_table = mk.tp0_table_for(table, cfg, scan)
    assert torch.equal(tp0_table, mk.augment_table_tp0(table, cfg.camera.eye))
    own = mk.render_samples_pallas_stats(table, cfg, 1, 2, scan=scan, classes=classes)
    given = mk.render_samples_pallas_stats(table, cfg, 1, 2, scan=scan, classes=classes,
                                           tp0_table=tp0_table)
    assert torch.equal(own[0], given[0]) and int(own[1]) == int(given[1])
    assert mk.tp0_table_for(table, RenderConfig(8, 6, bounces=9), scan) is None
    assert mk.tp0_table_for(mk.pack_scene(port_scene), cfg, "parity") is None
    with pytest.raises(ValueError):
        mk.render_samples_pallas_stats(table, cfg, 1, 1, scan=scan, classes=classes,
                                       tp0_table=tp0_table[:, :20].contiguous())


@pytest.mark.parametrize("bad", ["dtype", "shape", "fast", "classes", "big", "samples"])
def test_wrapper_rejects_bad_calls(port_scene, bad):
    """Calls the kernels do not take raise ValueError. "fast" and "big" were such
    calls until the fast scan and tables past shared memory were ported; those two
    cases now pin that the wrapper takes them: the fast scan within the JAX
    package's contract against parity, and a table past the 227 KB of shared
    memory (read from global memory on the card) rendering as the small one."""
    cfg = RenderConfig(8, 8, bounces=2)
    table = mk.pack_scene(port_scene)
    if bad in ("fast", "big"):
        ref, ref_segs = mk.render_samples_pallas_stats(table, cfg, 0, 1, scan="parity")
        if bad == "fast":
            scan, table, emi, _ = mk.prepare_scan(port_scene, "fast")
            img, segs = mk.render_samples_pallas_stats(table, cfg, 0, 1, scan=scan,
                                                       emi_const=emi)
            assert abs(int(segs) - int(ref_segs)) <= 2
            np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)
        else:
            # Zero rows are never hit (det = 0 fails the backface cull).
            rows = mk.SMEM_TABLE_MAX_BYTES // (4 * 24) + 1 - table.shape[0]
            big = torch.cat([table, torch.zeros((rows, 24))])
            assert not mk.table_in_shared(big) and mk.table_in_shared(table)
            img, segs = mk.render_samples_pallas_stats(big, cfg, 0, 1, scan="parity")
            assert torch.equal(img, ref) and int(segs) == int(ref_segs)
        return
    kw = dict(scan="parity", classes=())
    if bad == "dtype":
        table = table.double()
    elif bad == "shape":
        table = table[:, :20].contiguous()
    elif bad == "classes":
        kw["scan"] = "tp"
    n = 0 if bad == "samples" else 1
    with pytest.raises(ValueError):
        mk.render_samples_pallas_stats(table, RenderConfig(8, 8, bounces=1), 0, n, **kw)


def test_render_pallas_is_mean_of_chunks(port_scene):
    cfg = RenderConfig(width=8, height=6, bounces=2)
    img = mk.render_pallas(port_scene, cfg, 3, samples_per_call=2, scan="parity")
    table = mk.pack_scene(port_scene)
    total = (mk.render_samples_pallas(table, cfg, 0, 2) + mk.render_samples_pallas(table, cfg, 2, 1))
    np.testing.assert_allclose(img.numpy(), (total / 3).numpy(), rtol=1e-6, atol=1e-6)
