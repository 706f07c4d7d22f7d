"""The adjoint kernel's host side and plain version against the JAX package, and the
kernel train steps (kernels/grad_megakernel.py, diff/fast.py).

Pins, as tests/test_grad_kernel.py does for the JAX kernel: the dynamic-class
forward is bit for bit the tp megakernel's (tp0 off); the adjoint equals jax.grad
through the JAX parity twin at an interior point and, where the max(rad, 0) clamp
binds, the gradient of the UNCLAMPED twin; at the true (boundary) parameters it is
the right derivative, against upward finite differences; the kernel steps reduce
the loss. The JAX Pallas grad kernel in interpret mode takes minutes here even at
8×8, so the JAX side is its twin, which the JAX package's own tests hold the
kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core.camera import generate_rays as jgenerate_rays
from oclpathtracer_tpu.diff import fast as jfast
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.integrators.path import trace_paths as jtrace_paths
from oclpathtracer_tpu.kernels import grad_megakernel as jgk
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import class_params_from_numpy, scene_from_numpy
from oclpathtracer_tpu_torch.diff import fast
from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.runtime import profiling

torch.set_num_threads(1)

SIZE = 16
BOUNCES = 3
CFG = RenderConfig(width=SIZE, height=SIZE, bounces=BOUNCES)
JCFG = JCfg(width=SIZE, height=SIZE, bounces=BOUNCES)
TOL = dict(rtol=5e-3, atol=5e-3)  # tests/test_grad_kernel.py's


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.fixture(scope="module")
def grad_scene(port_scene):
    return gk.prepare_grad_scene(port_scene)


@pytest.fixture(scope="module")
def weights():
    return np.random.default_rng(0).normal(size=(SIZE * SIZE, 3)).astype(np.float32)


def _twin_image(scene, mat_class, ct, clamp=True, n_frames=2):
    """The JAX parity twin's SUM image over frames 0..n_frames-1 with class
    attributes `ct` broadcast to the materials."""
    mats = scene.materials._replace(albedo=ct[:, 0:3][mat_class],
                                    emissive=ct[:, 3:6][mat_class])
    sc = scene._replace(materials=mats)
    pixel_ids = jnp.arange(JCFG.n_pixels, dtype=jnp.int32)
    acc = jnp.zeros((JCFG.n_pixels, 3), jnp.float32)
    for f in range(n_frames):
        us = jparity.ref_uniforms(pixel_ids, f, 2 + 2 * BOUNCES)
        o, d = jgenerate_rays(pixel_ids % SIZE, pixel_ids // SIZE, SIZE, SIZE, us[:, 0],
                              us[:, 1], JCFG.camera)
        rad, _ = jtrace_paths(o, d, sc, us[:, 2:].reshape(-1, BOUNCES, 2), JCFG, clamp=clamp)
        acc = acc + rad
    return acc


def _twin_grad(scene, ct, w, clamp=True):
    """jax.grad of sum(w · twin image) w.r.t. the class attributes (C, 6)."""
    mc = jgk.prepare_grad_scene(scene)[3]
    return np.asarray(jax.grad(lambda c: jnp.sum(w * _twin_image(scene, mc, c, clamp)))(
        jnp.asarray(ct))[:, 0:6])


def _port_grad(grad_scene, ct: np.ndarray, w: np.ndarray):
    table, _, n_classes, _ = grad_scene
    return gk.render_grads_pallas(table, torch.from_numpy(ct), CFG, 0, 2, n_classes,
                                  weight=torch.from_numpy(w))[1].numpy()


def test_prepare_grad_scene_bitwise(scene, grad_scene):
    jt, jct, jc, jmc = jgk.prepare_grad_scene(scene)
    table, ct, n_classes, mat_class = grad_scene
    assert n_classes == jc == 5
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(jct))
    np.testing.assert_array_equal(mat_class.numpy(), np.asarray(jmc))
    classes = mk.material_classes(scene_from_numpy(
        *[[np.asarray(x) for x in part] for part in scene], device="cpu"))[0]
    np.testing.assert_array_equal(gk.pack_class_table(classes).numpy(),
                                  np.asarray(jgk.pack_class_table(classes)))


@pytest.mark.parametrize("sub", [None, (37, 150)], ids=["full", "sub-range"])
def test_forward_plain_bitwise_matches_tp_megakernel(port_scene, grad_scene, sub):
    """with_grads=False (and the image of a with_grads launch) == the tp megakernel's
    plain version with tp0 off, bit for bit, segments equal; also on a
    (pid_base, n_rays) range."""
    table, ct, n_classes, _ = grad_scene
    base, n = sub or (0, None)
    img, grads, segs = gk.render_grads_pallas_stats(table, ct, CFG, 3, 2, n_classes,
                                                    with_grads=False, pid_base=base, n_rays=n)
    assert grads is None
    _, t2, _, classes = mk.prepare_scan(port_scene, "tp")
    img2, segs2 = mk.render_samples_pallas_stats(t2, CFG, 3, 2, pid_base=base, n_rays=n,
                                                 scan="tp", classes=classes, tp0=False)
    assert torch.equal(img, img2) and int(segs) == int(segs2)
    w = torch.ones((img.shape[0], 3))
    img3, _, segs3 = gk.render_grads_pallas_stats(table, ct, CFG, 3, 2, n_classes, weight=w,
                                                  pid_base=base, n_rays=n)
    assert torch.equal(img3, img2) and int(segs3) == int(segs2)


def test_adjoint_matches_twin_ad_at_interior_point(scene, grad_scene, weights):
    """Strictly positive attributes: the clamp is inert, and the adjoint equals
    jax.grad through the JAX parity twin."""
    ct = grad_scene[1].numpy().copy()
    ct[:, 0:3] = np.clip(ct[:, 0:3], 0.12, 0.95)
    ct[:, 3:6] += 0.3
    np.testing.assert_allclose(_port_grad(grad_scene, ct, weights),
                               _twin_grad(scene, ct, weights), **TOL)


def test_adjoint_semantics_where_clamp_binds(scene, grad_scene, weights):
    """A class with negative albedo makes per-sample radiance negative, so the clamp
    binds: the adjoint is the gradient of the UNCLAMPED twin and differs from the
    clamped twin's by more than 1e-2."""
    ct = grad_scene[1].numpy().copy()
    ct[0, 0:3] = [-0.4, -0.3, -0.35]
    mc = jgk.prepare_grad_scene(scene)[3]
    assert float(_twin_image(scene, mc, jnp.asarray(ct), clamp=False).min()) < -1e-3
    g = _port_grad(grad_scene, ct, weights)
    np.testing.assert_allclose(g, _twin_grad(scene, ct, weights, clamp=False), **TOL)
    assert np.abs(g - _twin_grad(scene, ct, weights, clamp=True)).max() > 1e-2


def test_adjoint_is_right_derivative_at_boundary(grad_scene, weights):
    """At the true parameters (many zero attributes) the adjoint equals the UPWARD
    one-sided finite difference of sum(w · forward image), where FD can resolve it."""
    table, ct, n_classes, _ = grad_scene
    w = torch.from_numpy(weights)
    g = gk.render_grads_pallas(table, ct, CFG, 0, 2, n_classes, weight=w)[1].numpy()

    def loss(c):
        img, _ = gk.render_grads_pallas(table, c, CFG, 0, 2, n_classes, with_grads=False)
        return float(torch.sum(w * img))

    l0 = loss(ct)
    checked = 0
    for c, k in [(0, 0), (0, 4), (1, 3), (2, 1), (3, 0), (4, 2)]:
        eps = 1e-3
        e = torch.zeros_like(ct)
        e[c, k] = eps
        fd = (loss(ct + e) - l0) / eps
        floor = 4.0 * float(np.spacing(np.float32(abs(l0)))) / eps
        if abs(g[c, k]) > 4 * floor:
            assert np.isclose(g[c, k], fd, rtol=5e-2, atol=2 * floor), (c, k, g[c, k], fd)
            checked += 1
    assert checked >= 4


def test_cpu_tensors_never_launch(grad_scene):
    table, ct, n_classes, _ = grad_scene
    before = profiling.counts().get("launch.grad", 0)
    gk.render_grads_pallas(table, ct, RenderConfig(4, 4, bounces=1), 0, 1, n_classes)
    assert profiling.counts().get("launch.grad", 0) == before


@pytest.mark.parametrize("bad", ["classes", "n_classes", "weight", "device"])
def test_wrapper_rejects_bad_calls(grad_scene, bad):
    table, ct, n_classes, _ = grad_scene
    cfg = RenderConfig(4, 4, bounces=1)
    kw = dict(weight=torch.zeros((16, 3)))
    if bad == "classes":
        ct = ct[:, :6].contiguous()
    elif bad == "n_classes":
        n_classes = 4
    elif bad == "weight":
        kw["weight"] = torch.zeros((15, 3))
    else:
        ct = ct.to("meta")
    with pytest.raises(ValueError):
        gk.render_grads_pallas(table, ct, cfg, 0, 1, n_classes, **kw)


def _target(grad_scene, spp=4):
    table, ct, n_classes, _ = grad_scene
    img, _ = gk.render_grads_pallas(table, ct, CFG, 0, spp, n_classes, with_grads=False)
    return img / spp


def _perturbed(port_scene):
    true = fast.extract_class_params(port_scene)
    return true, fast.ClassParams(albedo=torch.clamp(true.albedo + 0.2, 0.0, 1.0),
                                  emissive=true.emissive)


def test_kernel_train_step_reduces_loss(port_scene, grad_scene):
    _, params = _perturbed(port_scene)
    target = _target(grad_scene)
    step = fast.make_kernel_train_step(port_scene, CFG, spp=2, lr=2e-3)
    losses = []
    for _ in range(10):
        params, loss = step(params, target, 0)  # fixed frames
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.7, losses


def test_kernel_optax_step_reduces_loss(port_scene, grad_scene):
    import functools

    _, params = _perturbed(port_scene)
    target = _target(grad_scene)
    step, opt_init = fast.make_kernel_optax_step(
        port_scene, CFG, spp=2, optimizer=functools.partial(torch.optim.Adam, lr=5e-2))
    opt_state = opt_init(params)
    losses = []
    for _ in range(10):
        params, opt_state, loss = step(params, opt_state, target, 0)
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.7, losses
    assert float(params.albedo.max()) <= 1.0 and float(params.emissive.min()) >= 0.0


def test_kernel_step_launches_four_times(port_scene, grad_scene, monkeypatch):
    """Two forward-only calls, then two adjoint calls."""
    calls = []
    real = gk.render_grads_pallas

    def spy(*args, **kw):
        calls.append(kw.get("with_grads", True))
        return real(*args, **kw)

    monkeypatch.setattr(gk, "render_grads_pallas", spy)
    step = fast.make_kernel_train_step(port_scene, RenderConfig(8, 8, bounces=2), spp=1,
                                       lr=1e-3)
    step(fast.extract_class_params(port_scene), torch.zeros((64, 3)), 3)
    assert calls == [False, False, True, True]


def test_kernel_sgd_step_matches_jax_step(scene, port_scene, grad_scene):
    """One kernel SGD step against JAX's step rule (_project_class(params − lr·g)) with
    g from jax.grad of the same pairwise loss through the JAX parity twin, at an
    interior point (where the twin's clamp is inert): new ClassParams within 1e-4,
    loss within 1e-4 relative."""
    spp, lr, step_idx = 2, 1e-2, 1
    jtrue = jfast.extract_class_params(scene)
    jparams = jfast.ClassParams(albedo=jnp.clip(jtrue.albedo + 0.2, 0.12, 0.95),
                                emissive=jtrue.emissive + 0.3)
    target = np.asarray(_target(grad_scene)) * 0.7
    render_twin = jfast.make_fast_renderer(scene, JCFG, spp)[1]

    def jloss(p):
        sp = jfast.class_params_to_materials(scene, p)
        a = render_twin(sp, (2 * step_idx) * spp)
        b = render_twin(sp, (2 * step_idx + 1) * spp)
        return jnp.mean((a - target) * (b - target))

    l_j, g_j = jax.value_and_grad(jloss)(jparams)
    want = jfast._project_class(jfast.ClassParams(albedo=jparams.albedo - lr * g_j.albedo,
                                                  emissive=jparams.emissive - lr * g_j.emissive))

    params = class_params_from_numpy(np.asarray(jparams.albedo), np.asarray(jparams.emissive),
                                     device="cpu")
    step = fast.make_kernel_train_step(port_scene, CFG, spp, lr)
    got, l_t = step(params, torch.from_numpy(target), step_idx)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_adam_step_matches_optax_on_the_same_gradients(port_scene):
    """The torch.optim.Adam the optimizer steps take against optax.adam, one update
    from the same parameters and gradients, within 1e-6."""
    import functools

    rng = np.random.default_rng(3)
    p0 = fast.extract_class_params(port_scene)
    g = [rng.normal(size=(5, 3)).astype(np.float32) * s for s in (10.0, 0.1)]
    opt = functools.partial(torch.optim.Adam, lr=5e-2)(
        [x.detach().clone() for x in p0])
    for t, gt in zip(opt.param_groups[0]["params"], g):
        t.grad = torch.from_numpy(gt)
    opt.step()
    jp = jfast.ClassParams(*(jnp.asarray(x.numpy()) for x in p0))
    tx = optax.adam(5e-2)
    updates, _ = tx.update(jfast.ClassParams(*(jnp.asarray(x) for x in g)), tx.init(jp), jp)
    for t, p, u in zip(opt.param_groups[0]["params"], jp, updates):
        np.testing.assert_allclose(t.numpy(), np.asarray(p + u), rtol=1e-6, atol=1e-6)


def test_compare_grads_holds_each_class_row_to_its_own_scale(grad_scene, weights):
    from oclpathtracer_tpu_torch.kernels import selfcheck

    table, ct, n_classes, _ = grad_scene
    img, g, segs = gk._render_grads_plain(table, ct, CFG, 0, 2, n_classes, with_grads=True,
                                          weight=torch.from_numpy(weights))
    want = (img, g, segs)
    assert selfcheck.compare_grads((img, g * (1 + 1e-6), segs), want)["ok"]
    rows = g.abs().amax(dim=1)
    small = int(torch.where(rows > 0, rows, torch.inf).argmin())  # the smallest class hit
    zeroed = g.clone()
    zeroed[small] = 0.0
    result = selfcheck.compare_grads((img, zeroed, segs), want)
    assert not result["ok"] and result["grad_worst_row"] > 1.0
