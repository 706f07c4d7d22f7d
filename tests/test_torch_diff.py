"""The port's diff/ against the JAX package's: losses, parameters, gradients through
autograd against jax.grad of the same losses on the same sample streams, the
hybrid kernel-forward/twin-backward renderer, and the train steps."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.diff import fast as jfast
from oclpathtracer_tpu.diff import inverse as jinv
from oclpathtracer_tpu.diff import losses as jlosses
from oclpathtracer_tpu.kernels import megakernel as jmk
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy, scene_params_from_numpy
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import fast, inverse, losses
from oclpathtracer_tpu_torch.kernels import megakernel as mk

torch.set_num_threads(1)

SIZE = 16
BOUNCES = 3
SPP = 2
CFG = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES)
JCFG = JCfg(width=SIZE, height=SIZE, bounces=BOUNCES)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.fixture(scope="module")
def target(scene):
    """A 2-spp render of the true scene on another key (JAX), as numpy."""
    return np.asarray(jinv.render_spp(scene, JCFG, SPP, jrng.make_key(3)))


def _both_params(scene, **kw):
    jp = jinv.extract_params(scene, **kw)
    leaves = [None if x is None else (tuple(np.asarray(v) for v in x) if isinstance(x, tuple)
                                      else np.asarray(x)) for x in jp]
    return jp, scene_params_from_numpy(*leaves, device="cpu")


def _assert_params_close(got, want, **tol):
    for a, b in zip(inverse.params_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


def test_losses_match_jax():
    r = np.random.default_rng(0)
    a, b = (r.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    for fn, jfn in ((losses.mse_loss, jlosses.mse_loss), (losses.l2_loss, jlosses.l2_loss)):
        np.testing.assert_allclose(float(fn(torch.from_numpy(a), torch.from_numpy(b))),
                                   float(jfn(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def test_extract_and_apply_params(port_scene):
    p = inverse.extract_params(port_scene, albedo=True, emissive=True, vertices=True,
                               roughness=True)
    assert len(inverse.params_leaves(p)) == 6
    doubled = inverse.params_from_leaves(p, [x * 2 for x in inverse.params_leaves(p)])
    sc = inverse.apply_params(port_scene, doubled)
    assert torch.equal(sc.materials.albedo, port_scene.materials.albedo * 2)
    assert torch.equal(sc.materials.roughness, port_scene.materials.roughness * 2)
    assert torch.equal(sc.geometry.p3, port_scene.geometry.p3 * 2)
    assert sc.geometry.mat_id is port_scene.geometry.mat_id
    assert inverse.extract_params(port_scene).emissive is None


@pytest.mark.parametrize("loss_name", ["make_loss_fn", "make_unbiased_loss_fn"])
def test_twin_gradients_match_jax_grad(scene, port_scene, target, loss_name):
    """Albedo and emissive gradients by autograd against jax.grad of the same loss
    with the same key (CRN; the unbiased loss splits it the same way). Emissive
    gradients of non-emitting materials pass through max(rad, 0) at rad == 0
    exactly, where both take jnp.maximum's subgradient 1/2."""
    jp, tp = _both_params(scene, albedo=True, emissive=True)
    l_j, g_j = jax.value_and_grad(getattr(jinv, loss_name)(scene, JCFG, SPP))(
        jp, jnp.asarray(target), jrng.make_key(7))
    l_t, g_t = inverse.value_and_grad(getattr(inverse, loss_name)(port_scene, CFG, SPP), tp,
                                       torch.tensor(target), rng.make_key(7, device="cpu"))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)
    _assert_params_close(g_t, g_j, **GRAD_TOL)


def test_train_step_matches_jax_and_reduces_loss(scene, port_scene):
    """One SGD step equals JAX's (new params at 1e-4); ten cut the CRN loss below 0.7×
    its first value. The target is the true scene on the training key's own
    samples, so the loss can fall to 0."""
    key_j, key_t = jrng.make_key(11), rng.make_key(11, device="cpu")
    target = np.asarray(jinv.render_spp(scene, JCFG, SPP, jax.random.fold_in(key_j, 0)))
    jp = jinv.SceneParams(albedo=jnp.clip(jinv.extract_params(scene).albedo + 0.2, 0.0, 1.0))
    tp = scene_params_from_numpy(np.asarray(jp.albedo), device="cpu")
    p_j, l_j = jinv.make_train_step(scene, JCFG, SPP, lr=3e-3)(jp, jnp.asarray(target),
                                                               jnp.int32(0), key_j)
    step = inverse.make_train_step(port_scene, CFG, SPP, lr=3e-3)
    tt = torch.tensor(target)
    p_t, l_t = step(tp, tt, 0, key_t)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-5)
    _assert_params_close(p_t, p_j, rtol=1e-4, atol=1e-4)
    losses_ = [float(l_t)]
    for _ in range(9):
        p_t, l_t = step(p_t, tt, 0, key_t)
        losses_.append(float(l_t))
    assert np.isfinite(losses_).all() and losses_[-1] < 0.7 * losses_[0], losses_


def test_optax_train_step_reduces_loss(scene, port_scene):
    """torch.optim.Adam(5e-2) on the unbiased loss: ten steps cut the loss below 0.7×
    its first value, and the projection holds albedo in [0, 1]. The target is the
    true scene on the first of the step's two sample sets, so the loss is 0 there."""
    tp = scene_params_from_numpy(
        np.clip(np.asarray(jinv.extract_params(scene).albedo) + 0.2, 0.0, 1.0), device="cpu")
    key = rng.make_key(11, device="cpu")
    target = inverse.render_spp(port_scene, CFG, SPP, rng.split(rng.fold_in(key, 0))[0])
    step, opt_init = inverse.make_optax_train_step(
        port_scene, CFG, SPP, functools.partial(torch.optim.Adam, lr=5e-2))
    state = opt_init(tp)
    losses_ = []
    for _ in range(10):
        tp, state, loss = step(tp, state, target, 0, key)
        losses_.append(float(loss))
    assert np.isfinite(losses_).all() and losses_[-1] < 0.7 * losses_[0], losses_
    assert 0.0 <= float(tp.albedo.min()) and float(tp.albedo.max()) <= 1.0


def test_pack_scene_table_bitwise(scene, port_scene):
    """The port's one packer (megakernel.pack_scene, torch on the scene's device,
    under both names) equals the JAX megakernel.pack_scene (numpy) bit for bit. The
    JAX jnp mirror (whose XLA norm may round an element of the normal the other
    way) agrees to an ulp on the columns it fills."""
    assert fast.pack_scene_table is mk.pack_scene
    got = fast.pack_scene_table(port_scene).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmk.pack_scene(scene)))
    np.testing.assert_allclose(got[:, :20], np.asarray(jfast.pack_scene_table(scene))[:, :20],
                               rtol=1e-6, atol=0)


def test_fast_renderer_forward_and_gradient_match_jax_twin(scene, port_scene):
    """The hybrid's forward (the parity megakernel's plain version here) against the
    JAX twin at 1e-4, and its gradient against the JAX twin's at 1e-3
    (tests/test_diff_fast.py's tolerances)."""
    jp, tp = _both_params(scene, albedo=True)
    _, jtwin = jfast.make_fast_renderer(scene, JCFG, SPP)
    render, _ = fast.make_fast_renderer(port_scene, CFG, SPP)
    np.testing.assert_allclose(render(tp, 0).numpy(), np.asarray(jtwin(jp, 0)),
                               rtol=1e-4, atol=1e-4)
    g_j = jax.grad(lambda p: jnp.sum(jtwin(p, jnp.int32(0)) ** 2))(jp)
    _, g_t = inverse.value_and_grad(lambda p: torch.sum(render(p, 0) ** 2), tp)
    np.testing.assert_allclose(g_t.albedo.numpy(), np.asarray(g_j.albedo), rtol=1e-3,
                               atol=1e-3)


def test_fast_loss_fn_matches_jax_twin_loss(scene, port_scene, target):
    """make_fast_loss_fn's value and gradient against the same pairwise loss through
    the JAX twin (the JAX hybrid's backward), step index 1."""
    jp, tp = _both_params(scene, albedo=True, emissive=True)
    jp = jp._replace(emissive=jp.emissive + 0.3)
    tp = tp._replace(emissive=tp.emissive + 0.3)
    _, jtwin = jfast.make_fast_renderer(scene, JCFG, SPP)

    def jloss(p):
        a, b = jtwin(p, 2 * SPP), jtwin(p, 3 * SPP)
        return jnp.mean((a - target) * (b - target))

    l_j, g_j = jax.value_and_grad(jloss)(jp)
    l_t, g_t = inverse.value_and_grad(fast.make_fast_loss_fn(port_scene, CFG, SPP), tp,
                                       torch.tensor(target), 1)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
    _assert_params_close(g_t, g_j, rtol=1e-3, atol=1e-3)


def test_class_params_round_trip(scene, port_scene):
    cp = fast.extract_class_params(port_scene)
    jcp = jfast.extract_class_params(scene)
    for a, b in zip(cp, jcp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sp = fast.class_params_to_materials(port_scene, cp)
    assert torch.equal(sp.albedo, port_scene.materials.albedo)
    assert torch.equal(sp.emissive, port_scene.materials.emissive)


@pytest.mark.parametrize("uses", ["albedo", "nothing"])
def test_value_and_grad_gives_zeros_where_the_loss_does_not_use_a_leaf(scene, port_scene,
                                                                        uses):
    """jax.value_and_grad gives zeros for a leaf the loss does not use, and for every
    leaf of a loss that uses none (a 1-bounce render's loss and the vertices); the
    port's value_and_grad too, rather than raising."""
    def loss(p):
        return torch.sum(p.albedo ** 2) if uses == "albedo" else torch.tensor(2.0)

    def jloss(p):
        return jnp.sum(p.albedo ** 2) if uses == "albedo" else jnp.float32(2.0)

    params = inverse.extract_params(port_scene, albedo=True, emissive=True)
    value, g = inverse.value_and_grad(loss, params)
    jvalue, jg = jax.value_and_grad(jloss)(jinv.extract_params(scene, albedo=True,
                                                               emissive=True))
    assert float(value) == pytest.approx(float(jvalue), rel=1e-6)
    for name in ("albedo", "emissive"):
        np.testing.assert_allclose(getattr(g, name).numpy(), np.asarray(getattr(jg, name)),
                                   rtol=1e-6)
    assert not bool(g.emissive.any())
