"""The BVH kernels' plain PyTorch versions (skip-link walk and 8-wide walk) against
the JAX package, on CPU tensors.

Contract (the JAX package's fast-vs-parity rule, tests/test_kernels.py):
|Δsegments| ≤ 2 and images allclose at rtol = atol = 1e-4, against
  * JAX `render_sample_ref` / `count_segments_ref`, the linear parity reference, at
    32×32 and 2 bounces, for every leaf test (parity, fast, tp);
  * JAX's own `render_samples_bvh_stats` and `render_samples_wide_bvh_stats`, run in
    interpret mode, at 32×32, 2 bounces, leaf 4, 1 spp.
The per-ray walks visit fewer leaves than the TPU's tile-wide walk; an extra visit
cannot win a best hit except where a slab and a triangle test disagree by an ulp.
Between the port's own two walks the rule is bit for bit: the 8-wide walk gives
each popped child the skip walk's box test at the same point of the same sequence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.config import CameraConfig as JCam
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.kernels import bvh_megakernel as jbk
from oclpathtracer_tpu.kernels import wide_bvh as jwb
from oclpathtracer_tpu.scene import procgen as jprocgen
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
from oclpathtracer_tpu_torch.runtime import profiling

torch.set_num_threads(1)

EYE = (0.0, 3.0, 9.0)
W = H = 32
B = 2
SCANS = ["parity", "fast", "tp"]


def _port(jscene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in jscene], device="cpu")


@pytest.fixture(scope="module")
def scenes(scene):
    """name → (JAX scene, port scene, JAX cfg, port cfg): the Cornell box with its own
    camera, and sphere_field(3, 1, seed=2) (244 triangles) with the JAX package's
    camera for procedural scenes."""
    jsf = jprocgen.sphere_field(3, 1, seed=2)
    return {"cornell": (scene, _port(scene), JCfg(width=W, height=H, bounces=B),
                        RenderConfig(width=W, height=H, bounces=B)),
            "spheres244": (jsf, _port(jsf),
                           JCfg(width=W, height=H, bounces=B, camera=JCam(eye=EYE)),
                           RenderConfig(width=W, height=H, bounces=B,
                                        camera=CameraConfig(eye=EYE)))}


@pytest.fixture(scope="module")
def references(scenes):
    """JAX render_sample_ref frame 0 and count_segments_ref, per scene."""
    out = {}
    for name, (jscene, _, jcfg, _) in scenes.items():
        img = np.asarray(jparity.render_sample_ref(jscene, jcfg, 0))
        segs = int(jparity.count_segments_ref(jscene, jcfg, jnp.arange(0, 1)))
        out[name] = (img, segs)
    return out


def _render(kernel, tscene, cfg, scan, leaf, start=0, n=1):
    if kernel == "bvh":
        scan, table, nf, ni, emi, classes = bk.prepare_bvh_scan(tscene, scan, leaf_size=leaf)
        return bk.render_samples_bvh_stats(table, nf, ni, cfg, start, n, max_leaf=leaf,
                                           scan=scan, emi_const=emi, classes=classes)
    emi = mk.scene_emissive_const(tscene) if scan == "fast" else mk.NO_EMI
    table, wn_f, wn_i, depth, classes = wb.pack_wide_bvh_scene(tscene, leaf, scan)
    return wb.render_samples_wide_bvh_stats(table, wn_f, wn_i, cfg, start, n, max_leaf=leaf,
                                            max_depth=depth, scan=scan, emi_const=emi,
                                            classes=classes)


def _meets_contract(img, segs, ref_img, ref_segs):
    assert abs(int(segs) - int(ref_segs)) <= 2
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("kernel", ["bvh", "widebvh"])
@pytest.mark.parametrize("name", ["cornell", "spheres244"])
def test_plain_matches_jax_reference(scenes, references, name, kernel, scan):
    _, tscene, _, cfg = scenes[name]
    img, segs = _render(kernel, tscene, cfg, scan, leaf=8)
    _meets_contract(img, segs, *references[name])
    launches = profiling.counts()
    assert launches.get("launch.bvh", 0) == launches.get("launch.wide_bvh", 0) == 0


@pytest.mark.parametrize("scan", SCANS)
def test_plain_skip_walk_matches_jax_kernel(scenes, scan):
    jscene, tscene, jcfg, cfg = scenes["spheres244"]
    jscan, table, nf, ni, emi, classes = jbk.prepare_bvh_scan(jscene, scan, leaf_size=4)
    ref_img, ref_segs = jbk.render_samples_bvh_stats(table, nf, ni, jcfg, 0, 1, max_leaf=4,
                                                     scan=jscan, emi_const=emi,
                                                     classes=classes)
    _meets_contract(*_render("bvh", tscene, cfg, scan, leaf=4), ref_img, float(ref_segs))


@pytest.mark.parametrize("scan", SCANS)
def test_plain_wide_walk_matches_jax_kernel(scenes, scan):
    jscene, tscene, jcfg, cfg = scenes["spheres244"]
    emi = mk.scene_emissive_const(tscene) if scan == "fast" else mk.NO_EMI
    table, wn_f, wn_i, depth, classes = jwb.pack_wide_bvh_scene(jscene, 4, scan)
    ref_img, ref_segs = jwb.render_samples_wide_bvh_stats(
        table, wn_f, wn_i, jcfg, 0, 1, max_leaf=4, max_depth=depth, scan=scan,
        emi_const=emi, classes=classes)
    _meets_contract(*_render("widebvh", tscene, cfg, scan, leaf=4), ref_img, float(ref_segs))


@pytest.mark.parametrize("leaf", [4, 32])
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("name", ["cornell", "spheres244"])
def test_plain_wide_walk_is_the_skip_walk_bitwise(scenes, name, scan, leaf):
    _, tscene, _, cfg = scenes[name]
    cfg = cfg.with_(width=24, height=20, bounces=4)
    skip = _render("bvh", tscene, cfg, scan, leaf, start=3, n=2)
    wide = _render("widebvh", tscene, cfg, scan, leaf, start=3, n=2)
    assert torch.equal(skip[0], wide[0]) and int(skip[1]) == int(wide[1])


@pytest.mark.parametrize("scan", SCANS)
def test_plain_bvh_matches_plain_linear_scan_on_cornell(scenes, scan):
    """Every ray of the Cornell box hits: the walk against the brute-force scan of
    the same arithmetic (tp without the tp0 peel, which the BVH kernels lack)."""
    _, tscene, _, cfg = scenes["cornell"]
    cfg = cfg.with_(bounces=4)
    scan, table, emi, classes = mk.prepare_scan(tscene, scan)
    lin = mk.render_samples_pallas_stats(table, cfg, 1, 2, scan=scan, emi_const=emi,
                                         classes=classes, tp0=False)
    walk = _render("bvh", tscene, cfg, scan, leaf=4, start=1, n=2)
    assert int(walk[1]) == int(lin[1])
    np.testing.assert_allclose(walk[0].numpy(), lin[0].numpy(), rtol=1e-5, atol=1e-5)


def test_wide_wrapper_rejects_a_tree_deeper_than_its_stack(scenes):
    _, tscene, _, cfg = scenes["spheres244"]
    table, wn_f, wn_i, depth, _ = wb.pack_wide_bvh_scene(tscene, 4, "parity")
    assert depth <= wb.WIDE_MAX_DEPTH
    for bad in (wb.WIDE_MAX_DEPTH + 1, 0):
        with pytest.raises(ValueError, match="deep"):
            wb.render_samples_wide_bvh_stats(table, wn_f, wn_i, cfg, 0, 1, max_leaf=4,
                                             max_depth=bad)


def test_bvh_wrappers_reject_bad_tables(scenes):
    _, tscene, _, cfg = scenes["spheres244"]
    table, nf, ni = bk.pack_bvh_scene(tscene, leaf_size=4)
    with pytest.raises(ValueError):
        bk.render_samples_bvh_stats(table, nf, ni.float(), cfg, 0, 1, max_leaf=4)
    with pytest.raises(ValueError):
        bk.render_samples_bvh_stats(table, nf[:, :6].contiguous(), ni, cfg, 0, 1, max_leaf=4)
    with pytest.raises(ValueError):
        bk.render_samples_bvh_stats(table, nf, ni, cfg, 0, 1, max_leaf=4, scan="tp")
    wtable, wn_f, wn_i, depth, _ = wb.pack_wide_bvh_scene(tscene, 4, "parity")
    with pytest.raises(ValueError):
        wb.render_samples_wide_bvh_stats(wtable, wn_f.reshape(-1, 6), wn_i, cfg, 0, 1,
                                         max_depth=depth)
    with pytest.raises(ValueError):
        bk.prepare_bvh_scan(tscene, "bogus")
