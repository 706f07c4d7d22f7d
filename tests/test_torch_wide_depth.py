"""The 8-wide walk on a tree deeper than 12 levels, and render/driver.py's routing by depth.

`selfcheck.deep_scene` peels one triangle a split off a chain at exponentially
growing distances, so its leaf-16 tree (render/driver.py's leaf at this size) and its
leaf-32 tree are 14 levels deep. On that tree the plain wide walk, whose stack is sized
from the tree's depth, equals the plain skip-link walk bit for bit, and both take the
linear scan's hit decisions.
A tree deeper than the kernel's shared-memory stack (WIDE_MAX_DEPTH levels) goes to
the skip-link kernel on the same build, before any launch; here the cap is lowered
to 13 to make the 14-level tree such a tree.
"""

import numpy as np
import pytest
import torch

from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import selfcheck
from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
from oclpathtracer_tpu_torch.render import driver
from oclpathtracer_tpu_torch.runtime import profiling

torch.set_num_threads(1)

SCANS = ["parity", "fast", "tp"]
DEEP_LEVELS = 14
CFG = selfcheck.scene_cfg("deep", 16, 16, 2)


@pytest.fixture(scope="module")
def deep():
    return selfcheck.deep_scene("cpu")


def _wide(scene, scan, leaf=32):
    emi = mk.scene_emissive_const(scene) if scan == "fast" else mk.NO_EMI
    table, wn_f, wn_i, depth, classes = wb.pack_wide_bvh_scene(scene, leaf, scan)
    return table, wn_f, wn_i, depth, emi, classes


def test_the_deep_tree_is_deeper_than_twelve_levels(deep):
    assert deep.num_triangles > driver.LINEAR_KERNEL_MAX_TRIS  # auto takes the wide kernel
    for leaf in (driver.WIDE_BVH_SMALL_LEAF, 32, 64):
        depth = _wide(deep, "parity", leaf)[3]
        assert depth == DEEP_LEVELS > 12
    table = _wide(deep, "tp")[0]
    assert bool(torch.isfinite(table).all())


@pytest.mark.parametrize("scan", SCANS)
def test_plain_wide_walk_is_the_skip_walk_bitwise_on_the_deep_tree(deep, scan):
    table, wn_f, wn_i, depth, emi, classes = _wide(deep, scan)
    wide = wb.render_samples_wide_bvh_stats(table, wn_f, wn_i, CFG, 1, 2, max_leaf=32,
                                            max_depth=depth, scan=scan, emi_const=emi,
                                            classes=classes)
    _, tb, nf, ni, emi_s, cl_s = bk.prepare_bvh_scan(deep, scan, leaf_size=32)
    assert torch.equal(tb, table)
    skip = bk.render_samples_bvh_stats(tb, nf, ni, CFG, 1, 2, max_leaf=32, scan=scan,
                                       emi_const=emi_s, classes=cl_s)
    assert torch.equal(wide[0], skip[0]) and int(wide[1]) == int(skip[1])
    assert int(wide[1]) > CFG.n_pixels * 2  # some paths bounce
    assert bool(torch.isfinite(wide[0]).all())


@pytest.mark.parametrize("scan", SCANS)
def test_both_walks_take_the_linear_scans_hit_decisions(deep, scan):
    """Camera rays and seeded rays from inside the chain's boxes: the decoded best
    hit of the wide walk, the skip walk and the megakernel's linear scan on the same
    table, bit for bit."""
    table, wn_f, wn_i, depth, emi, classes = _wide(deep, scan)
    _, tb, nf, ni, _, _ = bk.prepare_bvh_scan(deep, scan, leaf_size=32)
    ps = mk._PlainScene(table, classes, scan, emi)
    k = mk._Consts.of(CFG)
    pid = torch.arange(CFG.n_pixels, dtype=torch.int64)
    o_cam, d_cam, *_ = mk._camera_path(k, CFG, pid, 0)
    g = np.random.default_rng(1)
    n = 256
    o_in = torch.from_numpy(g.uniform(-0.05, 0.05, (n, 3)).astype(np.float32))
    d_in = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    d_in = d_in / torch.linalg.vector_norm(d_in, dim=1, keepdim=True)
    o = tuple(torch.cat([o_cam[c], o_in[:, c]]) for c in range(3))
    d = tuple(torch.cat([d_cam[c], d_in[:, c]]) for c in range(3))
    active = torch.ones_like(o[0], dtype=torch.bool)
    hits = [fn(0, o, d, active) for fn in (mk.linear_nearest(ps),
                                          bk._skip_walk_nearest(ps, nf, ni),
                                          wb._wide_walk_nearest(ps, wn_f, wn_i, depth))]
    flat = [torch.stack([x if isinstance(x, torch.Tensor) else torch.tensor(x)
                         for part in h for x in (part if isinstance(part, tuple) else (part,))])
            for h in hits]
    assert torch.equal(flat[0], flat[1]) and torch.equal(flat[0], flat[2])
    assert int((hits[0][0] < mk.T_MAX).sum()) > 0


def test_the_wrapper_takes_any_depth_its_stack_holds(deep):
    table, wn_f, wn_i, depth, emi, classes = _wide(deep, "parity")
    img, segs = wb.render_samples_wide_bvh_stats(table, wn_f, wn_i, CFG.with_(width=4, height=4),
                                                 0, 1, max_depth=wb.WIDE_MAX_DEPTH)
    assert img.shape == (16, 3) and int(segs) >= 16
    assert wb.WIDE_MAX_DEPTH == 454
    with pytest.raises(ValueError, match="deep"):
        wb.render_samples_wide_bvh_stats(table, wn_f, wn_i, CFG, 0, 1,
                                         max_depth=wb.WIDE_MAX_DEPTH + 1)


def _render(scene, backend):
    return driver.render_progressive(scene, CFG, total_spp=2, samples_per_step=2,
                                     backend=backend)


def _wide_leaf_counts() -> dict:
    return {k: v for k, v in profiling.counts().items() if k.startswith("wide_leaf.")}


def test_auto_renders_the_deep_tree_with_the_wide_kernel(deep, monkeypatch):
    calls = []
    wide = wb.render_samples_wide_bvh_stats
    monkeypatch.setattr(wb, "render_samples_wide_bvh_stats",
                        lambda *a, **kw: calls.append(kw["max_depth"]) or wide(*a, **kw))
    key = f"wide_leaf.{driver.wide_leaf(deep.num_triangles)}"
    before = _wide_leaf_counts()
    img = _render(deep, "auto")
    assert calls == [DEEP_LEVELS]
    after = _wide_leaf_counts()
    assert after == {**before, key: before.get(key, 0) + 1}
    assert torch.equal(img, _render(deep, "bvh"))


@pytest.mark.parametrize("backend", ["auto", "widebvh"])
def test_a_tree_deeper_than_the_stack_goes_to_the_skip_link_kernel(deep, monkeypatch,
                                                                   backend):
    def refuse(*a, **kw):
        raise AssertionError("the wide kernel was given a tree deeper than its stack")

    monkeypatch.setattr(wb, "WIDE_MAX_DEPTH", DEEP_LEVELS - 1)
    monkeypatch.setattr(wb, "render_samples_wide_bvh_stats", refuse)
    before = _wide_leaf_counts()
    img = _render(deep, backend)
    assert _wide_leaf_counts() == before  # the counter reads only the 8-wide kernel's trees
    assert torch.equal(img, _render(deep, "bvh"))
