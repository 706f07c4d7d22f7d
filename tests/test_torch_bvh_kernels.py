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
from oclpathtracer_tpu_torch.render import driver
from oclpathtracer_tpu_torch.runtime import profiling
from oclpathtracer_tpu_torch.scene import procgen

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


@pytest.mark.parametrize("leaf", [4, driver.WIDE_BVH_LEAF, driver.WIDE_BVH_SMALL_LEAF, 32])
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("name", ["cornell", "spheres244"])
def test_plain_wide_walk_is_the_skip_walk_bitwise(scenes, name, scan, leaf):
    _, tscene, _, cfg = scenes[name]
    cfg = cfg.with_(width=24, height=20, bounces=4)
    skip = _render("bvh", tscene, cfg, scan, leaf, start=3, n=2)
    wide = _render("widebvh", tscene, cfg, scan, leaf, start=3, n=2)
    assert torch.equal(skip[0], wide[0]) and int(skip[1]) == int(wide[1])


@pytest.mark.parametrize("leaf, pops", [(driver.WIDE_BVH_LEAF, 286), (32, 253)])
@pytest.mark.parametrize("scan", SCANS)
def test_plain_wide_walk_counts_its_pops(scenes, scan, leaf, pops):
    """WALK_COUNTS["pops"], the children the plain 8-wide walk pops (the kernel's
    `wide_bvh.walk_pops` on the same frames), pinned on sphere_field(3, 1, seed=2) at
    16², 4 bounces, samples 3-4: the same in each leaf form, and each pop is one of
    the box tests counted."""
    _, tscene, _, cfg = scenes["spheres244"]
    cfg = cfg.with_(width=16, height=16, bounces=4)
    bk.WALK_COUNTS.update(boxes=0, tris=0, pops=0)
    _, segs = _render("widebvh", tscene, cfg, scan, leaf, start=3, n=2)
    assert int(segs) == 519
    assert bk.WALK_COUNTS["pops"] == pops
    assert bk.WALK_COUNTS["pops"] < bk.WALK_COUNTS["boxes"]


@pytest.mark.parametrize("leaf, expands, boxes, tris",
                         [(driver.WIDE_BVH_LEAF, 30, 4636, 647), (32, 23, 4451, 1050)])
@pytest.mark.parametrize("scan", SCANS)
def test_plain_wide_walk_counts_its_expansions(scenes, scan, leaf, expands, boxes, tris):
    """WALK_COUNTS["expands"], the popped groups the plain 8-wide walk expands (the
    kernel's `wide_bvh.expand_pops`), with its box tests and leaf rows (the kernel's
    `.boxes`, `.leaf_rows`), pinned on the frames of test_plain_wide_walk_counts_its_pops
    at both leaves: the same in each leaf form, each expansion one of the pops."""
    _, tscene, _, cfg = scenes["spheres244"]
    cfg = cfg.with_(width=16, height=16, bounces=4)
    bk.WALK_COUNTS.update(boxes=0, tris=0, pops=0, expands=0)
    _render("widebvh", tscene, cfg, scan, leaf, start=3, n=2)
    assert bk.WALK_COUNTS["expands"] == expands
    assert (bk.WALK_COUNTS["boxes"], bk.WALK_COUNTS["tris"]) == (boxes, tris)
    assert bk.WALK_COUNTS["expands"] < bk.WALK_COUNTS["pops"]


@pytest.mark.parametrize("spheres, scan", [((7, 1), scan) for scan in SCANS]
                         + [((16, 2), scan) for scan in ("parity", "fast")])
def test_the_leaf_only_schedules_the_plain_wide_walk(spheres, scan):
    """sphere_field(7, 1) (564 triangles) and sphere_field() (5,124; 18 material
    classes, so no tp scan) at 16², 2 bounces, samples 3-4: the plain 8-wide walk
    gives the same image and segments, bit for bit, at both of the auto driver's
    leaves, at 32 and at 64."""
    scene = procgen.sphere_field(*spheres, device="cpu")
    cfg = RenderConfig(width=16, height=16, bounces=2, camera=CameraConfig(eye=EYE))
    leaves = (driver.WIDE_BVH_LEAF, driver.WIDE_BVH_SMALL_LEAF, 32, 64)
    (img, segs), *others = [_render("widebvh", scene, cfg, scan, leaf, start=3, n=2)
                            for leaf in leaves]
    assert int(segs) > cfg.n_pixels * 2  # some paths bounce
    for other_img, other_segs in others:
        assert torch.equal(other_img, img) and int(other_segs) == int(segs)


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


def _with_material_0(scene, **fields):
    """The scene with material 0's `fields` replaced."""
    m = scene.materials
    changed = {k: getattr(m, k).clone() for k in fields}
    for k, v in fields.items():
        changed[k][0] = v
    return scene._replace(materials=m._replace(**changed))


@pytest.mark.parametrize("prepare", ["linear", "bvh", "widebvh"])
@pytest.mark.parametrize("change,scan", [({"mtype": 3}, "tp"), ({"mtype": 3}, "fast"),
                                         ({"roughness": 5.0}, "fast")])
def test_every_prepare_refuses_an_explicit_scan_the_scene_cannot_encode(scenes, prepare,
                                                                        change, scan):
    """prepare_scan, prepare_bvh_scan and the driver's widebvh route resolve an explicit
    scan in one place (megakernel.checked_scan): where prepare_scan raises ValueError on
    the Cornell box with material 0 changed, each of them raises it."""
    bad = _with_material_0(scenes["cornell"][1], **change)
    supported = mk.tp_scan_supported if scan == "tp" else mk.fast_scan_supported
    assert supported(scenes["cornell"][1]) and not supported(bad)
    with pytest.raises(ValueError, match=f"scan='{scan}' requested"):
        mk.prepare_scan(bad, scan)
    run = {"linear": lambda: mk.prepare_scan(bad, scan),
           "bvh": lambda: bk.prepare_bvh_scan(bad, scan, leaf_size=4),
           "widebvh": lambda: driver.render_progressive(bad, RenderConfig(4, 4, bounces=1), 1,
                                                        backend="widebvh", scan=scan)}[prepare]
    with pytest.raises(ValueError, match=f"scan='{scan}' requested"):
        run()
