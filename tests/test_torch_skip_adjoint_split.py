"""The redesigned skip-link and adjoint kernels' layouts and work split, on CPU tensors.

The skip-link kernel (csrc/bvh_megakernel.cu) reads a node as nodes_f's two float4s
and nodes_i's int4, and both it and the adjoint kernel (csrc/grad_megakernel.cu) run
one thread per (pixel, sample) path, each path's max(rad, 0) into a
(n_samples, n, 3) scratch buffer added in sample order (csrc/split.cuh). So:

  * those 16-byte reads hold exactly the node rows' values, and a table off a
    16-byte boundary is refused;
  * the adjoint's split plain version gives the unsplit one's image and segments bit
    for bit and its gradients within selfcheck.compare_grads' rule, at the true, an
    interior and a clamp-binding point;
  * on a ragged pixel range the split plain adjoint equals jax.grad through the JAX
    parity twin with the weight zero off the range, at tests/test_grad_kernel.py's
    tolerance;
  * the adjoint stages the table in shared memory only where its threads' carries
    still fit beside it.
(The skip walk's split render against its unsplit sum is a case of
test_torch_kernel_layouts.py's split test.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core.camera import generate_rays as jgenerate_rays
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.integrators.path import trace_paths as jtrace_paths
from oclpathtracer_tpu.kernels import grad_megakernel as jgk
from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import selfcheck
from oclpathtracer_tpu_torch.scene.procgen import sphere_field

torch.set_num_threads(1)

SIZE = 16
BOUNCES = 3
CFG = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES)
JCFG = JCfg(width=SIZE, height=SIZE, bounces=BOUNCES)
TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_grad_kernel.py's


@pytest.fixture(scope="module")
def tables():
    return selfcheck.Tables("cpu")


def test_node_float4_reads_hold_the_node_rows():
    scene = sphere_field(3, 1, seed=2, device="cpu")
    for leaf in (4, 32):
        _, nodes_f, nodes_i = bk.pack_bvh_scene(scene, leaf_size=leaf)
        assert nodes_f.is_contiguous() and nodes_i.is_contiguous()
        assert nodes_f.element_size() * nodes_f.shape[1] == 32  # two float4s a node
        assert nodes_i.element_size() * nodes_i.shape[1] == 16  # one int4 a node
        lo, hi = nodes_f.view(-1, 2, 4)[:, 0], nodes_f.view(-1, 2, 4)[:, 1]
        box = torch.cat([lo, hi[:, :2]], dim=1)  # bvh.cuh skip_walk's b[6]
        assert torch.equal(box, nodes_f[:, 0:6])
        link = nodes_i.view(-1, 4)
        assert torch.equal(link[:, 0], nodes_i[:, 0])  # skip
        assert torch.equal(link[:, 1], nodes_i[:, 1])  # tri_start
        assert torch.equal(link[:, 2], nodes_i[:, 2])  # tri_count


def test_tables_off_a_16_byte_boundary_are_refused():
    scene = sphere_field(3, 1, seed=2, device="cpu")
    table, nodes_f, nodes_i = bk.pack_bvh_scene(scene, leaf_size=8)
    bk.check_aligned16(table=table, nodes_f=nodes_f, nodes_i=nodes_i)
    off = torch.zeros(nodes_f.numel() + 1)[1:].view(nodes_f.shape)
    with pytest.raises(ValueError, match="nodes_f"):
        bk.check_aligned16(table=table, nodes_f=off, nodes_i=nodes_i)


@pytest.mark.parametrize("point", ["true", "interior", "clamp binds"])
def test_adjoint_split_plain_is_the_unsplit_plain(tables, point):
    table, _, n_classes, _ = tables.grad("cornell")
    ct = selfcheck.grad_points(tables)[point]
    w = selfcheck.grad_weight(CFG.n_pixels, "cpu")
    kw = dict(weight=w, with_grads=True)
    got = gk._render_grads_plain(table, ct, CFG, 5, 3, n_classes, split=True, **kw)
    want = gk._render_grads_plain(table, ct, CFG, 5, 3, n_classes, split=False, **kw)
    r = selfcheck.compare_grads(got, want)
    assert r["ok"] and r["image_bitwise"] and r["segments_equal"], r
    assert float(got[1].abs().max()) > 0
    fwd = gk._render_grads_plain(table, ct, CFG, 5, 3, n_classes, with_grads=False)
    assert fwd[1] is None and torch.equal(fwd[0], got[0]) and int(fwd[2]) == int(got[2])


def test_adjoint_split_plain_on_a_ragged_range_matches_twin_ad(scene, tables):
    """Pixels [37, 37 + 150) at an interior point: jax.grad of sum(w · twin image)
    with w zero off the range."""
    table, ct, n_classes, _ = tables.grad("cornell")
    ct = ct.clone()
    ct[:, 0:3] = ct[:, 0:3].clamp(0.12, 0.95)
    ct[:, 3:6] += 0.3
    base, n = 37, 150
    w = np.random.default_rng(1).normal(size=(SIZE * SIZE, 3)).astype(np.float32)
    w[:base] = 0.0
    w[base + n:] = 0.0
    _, g, _ = gk._render_grads_plain(table, ct, CFG, 0, 2, n_classes,
                                     weight=torch.from_numpy(w[base:base + n]),
                                     pid_base=base, n_rays=n)
    mc = jgk.prepare_grad_scene(scene)[3]

    def twin_image(c):
        mats = scene.materials._replace(albedo=c[:, 0:3][mc], emissive=c[:, 3:6][mc])
        sc = scene._replace(materials=mats)
        ids = jnp.arange(JCFG.n_pixels, dtype=jnp.int32)
        acc = jnp.zeros((JCFG.n_pixels, 3), jnp.float32)
        for f in range(2):
            us = jparity.ref_uniforms(ids, f, 2 + 2 * BOUNCES)
            o, d = jgenerate_rays(ids % SIZE, ids // SIZE, SIZE, SIZE, us[:, 0], us[:, 1],
                                  JCFG.camera)
            rad, _ = jtrace_paths(o, d, sc, us[:, 2:].reshape(-1, BOUNCES, 2), JCFG)
            acc = acc + rad
        return acc

    want = jax.grad(lambda c: jnp.sum(w * twin_image(c)))(jnp.asarray(ct.numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(want)[:, 0:6], **TOL)


def test_adjoint_stages_the_table_only_where_the_carries_fit(tables):
    table = tables.grad("cornell")[0]
    assert gk.grad_table_in_shared(table)
    room = mk.SMEM_TABLE_MAX_BYTES - gk.STATIC_SMEM_BYTES - gk.CARRY_SMEM_BYTES
    assert gk.CARRY_SMEM_BYTES == 9 * mk.TP_CLASS_CAP * gk.BLOCK * 4
    fits = torch.zeros((room // (4 * mk.TABLE_COLS), mk.TABLE_COLS))
    assert gk.grad_table_in_shared(fits)
    assert not gk.grad_table_in_shared(torch.zeros((fits.shape[0] + 1, mk.TABLE_COLS)))
