"""The sorted wavefront's plain version (kernel 9, the bounce step) against the
port's skip-link kernel and the JAX package's sorted wavefront.

On CPU tensors `render_samples_sorted_stats` runs the bounce kernel's plain
version; the CUDA kernel is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py). The port's image is the skip-link kernel's (parity, same leaf) bit
for bit, sort on or off: every path is traced by the same operations and the
samples are added in the same order. The JAX package's own sorted wavefront agrees
with its BVH kernel only within 1e-5 (its camera in jnp, a scatter-add), so the
port is held to it at rtol = atol = 1e-5 with equal segments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.kernels import bvh_megakernel as jbk
from oclpathtracer_tpu.kernels import sorted_wavefront as jsw
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import rng as krng
from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw
from oclpathtracer_tpu_torch.kernels.selfcheck import PROCGEN_EYE
from oclpathtracer_tpu_torch.scene.procgen import sphere_field

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.fixture(scope="module")
def packed(port_scene):
    return {leaf: bk.pack_bvh_scene(port_scene, leaf_size=leaf) for leaf in (8, 32)}


def _same(a, b):
    return torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("leaf", [8, 32])
def test_plain_is_the_skip_link_plain_bitwise(packed, sort, leaf):
    tb, nf, ni = packed[leaf]
    cfg = RenderConfig(width=24, height=20, bounces=4)
    want = bk.render_samples_bvh_stats(tb, nf, ni, cfg, 5, 2, max_leaf=leaf)
    got = sw.render_samples_sorted_stats(tb, nf, ni, cfg, 5, 2, max_leaf=leaf, sort=sort)
    assert _same(got, want) and int(got[1]) > cfg.n_pixels * 2


@pytest.mark.parametrize("sort", [False, True])
def test_plain_is_the_skip_link_plain_on_a_sphere_field(sort):
    scene = sphere_field(3, 1, seed=2, device="cpu")
    tb, nf, ni = bk.pack_bvh_scene(scene, leaf_size=8)
    cfg = RenderConfig(width=24, height=16, bounces=3, camera=CameraConfig(eye=PROCGEN_EYE))
    want = bk.render_samples_bvh_stats(tb, nf, ni, cfg, 0, 2, max_leaf=8)
    got = sw.render_samples_sorted_stats(tb, nf, ni, cfg, 0, 2, max_leaf=8, sort=sort)
    assert _same(got, want)


@pytest.mark.parametrize("sort", [False, True])
def test_plain_matches_jax_interpret_sorted_wavefront(scene, packed, sort):
    """32×32, 3 bounces, 1 spp, leaf 8: the JAX Pallas bounce kernel in interpret
    mode (about 7 s a call on a CPU)."""
    jtb, jnf, jni = jbk.pack_bvh_scene(scene, leaf_size=8)
    jimg, jsegs = jsw.render_samples_sorted_stats(jtb, jnf, jni, JCfg(width=32, height=32,
                                                                      bounces=3),
                                                  0, 1, max_leaf=8, sort=sort)
    tb, nf, ni = packed[8]
    assert np.array_equal(tb.numpy(), np.asarray(jtb))
    img, segs = sw.render_samples_sorted_stats(tb, nf, ni, RenderConfig(width=32, height=32,
                                                                         bounces=3),
                                               0, 1, max_leaf=8, sort=sort)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-5, atol=1e-5)
    assert int(segs) == int(jsegs)


def test_start_offset_is_additive(packed):
    tb, nf, ni = packed[8]
    cfg = RenderConfig(width=16, height=12, bounces=3)
    a, _ = sw.render_samples_sorted_stats(tb, nf, ni, cfg, 0, 2, max_leaf=8)
    b, _ = sw.render_samples_sorted_stats(tb, nf, ni, cfg, 2, 2, max_leaf=8)
    ab, _ = sw.render_samples_sorted_stats(tb, nf, ni, cfg, 0, 4, max_leaf=8)
    np.testing.assert_allclose((a + b).numpy(), ab.numpy(), rtol=1e-5, atol=1e-5)


def test_sort_key_matches_jax_bitwise():
    g = np.random.default_rng(0)
    n = 5000
    o = g.uniform(-3.0, 4.0, (3, n)).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    live = (g.uniform(size=n) > 0.3).astype(np.float32)
    lo = np.array([-2.5, -0.5, -3.0], np.float32)
    hi = np.array([2.5, 5.5, 3.0], np.float32)
    want = np.asarray(jsw._sort_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(live),
                                    jnp.asarray(lo), jnp.asarray(hi)))
    got = sw._sort_key(*(torch.from_numpy(x) for x in (o, d, live, lo, hi)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(np.argsort(want, kind="stable"),
                          torch.argsort(got, stable=True).numpy())


def _full_batch_bounce(ctx, state, first):
    """The bounce over the whole batch, as the plain version ran before the live
    lists: every ray computed, the dead ones' old state kept by a select."""
    k = mk._Consts.of(ctx.cfg)
    n = state.live.shape[0]
    vecs = (state.o, state.d, state.mask, state.rad)
    if first:
        r = torch.arange(n, dtype=torch.int64)
        path = mk._camera_path(k, ctx.cfg, r % ctx.n_pix, ctx.start_sample + r // ctx.n_pix)
    else:
        path = (*(tuple(x) for x in vecs), state.live > 0.5,
                state.rng.to(torch.int64) & krng.MASK32)
    live = path[4]
    nearest = bk._skip_walk_nearest(mk._PlainScene(ctx.table, (), "parity"), ctx.nodes_f,
                                    ctx.nodes_i)
    new = mk._shade(k, path, nearest(0, path[0], path[1], live))
    for dst, old, val in zip(vecs, path[:4], new[:4]):
        dst.copy_(torch.stack(mk._where3(live, val, old)))
    state.live.copy_(torch.where(live, new[4].to(torch.float32), state.live))
    state.rng.copy_(torch.where(live, new[5], path[5]).to(torch.int32))
    return int(live.sum())


def _bits(state):
    """The state rows' bits (column 13 holds the rng's, which can read as a NaN)."""
    return state.rows.view(torch.int32)


def _start(packed, cfg, n_samples, start=0, sort=False):
    tb, nf, ni = packed[8]
    n = cfg.n_pixels * n_samples
    ctx = sw.Bounce.of(tb, nf, ni, cfg, start, n, cfg.n_pixels)
    return (ctx, sw.RayState.empty(n, "cpu"), sw.LiveLists.empty(n, "cpu", sort),
            torch.zeros((1,), dtype=torch.int64))


@pytest.mark.parametrize("mode", ["list", "sort"])
def test_live_list_bounces_are_the_full_batch_bounces_bitwise(packed, mode):
    """Bounce by bounce, the plain version tracing only the live list (or, with the
    sort on, the list the keys' argsort makes) leaves the state of the full-batch
    bounce bit for bit, its list holds exactly the live slots, and its keys are
    _sort_key of the state."""
    cfg = RenderConfig(width=16, height=12, bounces=5)
    ctx, state, lists, segs = _start(packed, cfg, 2, start=3, sort=mode == "sort")
    ref = sw.RayState.empty(state.live.shape[0], "cpu")
    lo, hi = ctx.nodes_f[0, 0:3], ctx.nodes_f[0, 3:6]
    traced = 0
    for b in range(cfg.bounces):
        if b > 0 and mode == "sort":
            lists.slots[1 - b % 2] = torch.argsort(lists.keys, stable=True)
        sw._bounce_step(ctx, state, lists, segs, sw.MODE_FIRST if b == 0 else sw.MODE_LIST,
                        b % 2)
        traced += _full_batch_bounce(ctx, ref, b == 0)
        used = slice(0, sw._RNG + 1)  # the row's last two columns are never read
        assert torch.equal(_bits(state)[:, used], _bits(ref)[:, used]) and int(segs) == traced
        count = int(lists.count(b % 2))
        listed = lists.slots[b % 2, :count].sort().values
        assert torch.equal(listed, (state.live > 0.5).nonzero().squeeze(1).to(torch.int32))
        if mode == "sort":
            assert torch.equal(lists.keys, sw._sort_key(state.o, state.d, state.live, lo, hi))
    assert 0 < count < cfg.n_pixels  # some rays still live after the last bounce


@pytest.mark.parametrize("mode", ["list", "sort"])
def test_bounce_step_leaves_dead_rays_alone(packed, mode):
    """After the first launch every dead ray's state is what it was, bit for bit, and
    the counter gains exactly the live rays: from the live list, or from the list
    the sort keys' argsort makes."""
    cfg = RenderConfig(width=16, height=8, bounces=4)
    ctx, state, lists, segs = _start(packed, cfg, 2, sort=mode == "sort")
    n = cfg.n_pixels * 2
    sw._bounce_step(ctx, state, lists, segs, sw.MODE_FIRST, 0)
    assert int(segs) == n
    if mode == "sort":
        lists.slots[0] = torch.argsort(lists.keys, stable=True)
    before = state.rows.clone()
    live = state.live > 0.5
    sw._bounce_step(ctx, state, lists, segs, sw.MODE_LIST, 1)
    assert int(segs) == n + int(live.sum())
    assert 0 < int(live.sum()) < n
    assert torch.equal(before.view(torch.int32)[~live], _bits(state)[~live])


def test_render_sorted_is_render_bvh_parity(port_scene):
    cfg = RenderConfig(width=16, height=16, bounces=3)
    got = sw.render_sorted(port_scene, cfg, 3, leaf_size=32)
    want = bk.render_bvh(port_scene, cfg, 3, samples_per_call=3, leaf_size=32, scan="parity")
    assert torch.equal(got, want) and got.shape == (256, 3) and float(got.mean()) > 0.1


def test_wrapper_checks_its_inputs(packed):
    tb, nf, ni = packed[8]
    cfg = RenderConfig(width=8, height=8, bounces=2)
    with pytest.raises(ValueError):
        sw.render_samples_sorted_stats(tb, nf, ni.long(), cfg, 0, 1, max_leaf=8)
    with pytest.raises(ValueError):
        sw.render_samples_sorted_stats(tb, nf, ni, cfg, 0, 0, max_leaf=8)
    with pytest.raises(ValueError):
        sw.render_samples_sorted_stats(tb, nf, ni, cfg, 0, 1, max_leaf=0)
