"""The port's two sharded train steps and the multi-device dry run on CPU meshes.

`diff.inverse.make_sharded_train_step` (autograd of the batched integrator, entry by
entry) against its own 1-entry step and against JAX's `make_sharded_train_step` on
the conftest's 8-device CPU mesh, on the same params, target and key: loss rtol
1e-5, params after a step of lr 1 (so they carry the gradient) at
tests/test_torch_diff.py's GRAD_TOL. `diff.fast.make_sharded_kernel_train_step` (the
adjoint kernel's plain version per entry): every entry's forward images bit for bit
the single call's rows, the 8-entry step against the 1-entry step and
make_kernel_train_step, and against JAX's step rule on jax.grad of the JAX parity
twin (as tests/test_torch_grad_kernel.py holds the unsharded step; JAX's Pallas grad
kernel in interpret mode takes minutes). `parallel.dryrun.dryrun_multichip` on 8 ×
`cpu`: its loss against JAX's sharded train step at rtol 1e-5, its hashes equal on 2
and 8 entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.diff import fast as jfast
from oclpathtracer_tpu.diff import inverse as jinv
from oclpathtracer_tpu.parallel.mesh import default_mesh as jdefault_mesh
from oclpathtracer_tpu.parallel.sharded import render_progressive_sharded as jrender_sharded
from oclpathtracer_tpu.parallel.sharded import shard_pixels as jshard_pixels
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import (
    class_params_from_numpy,
    scene_from_numpy,
)
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import fast, inverse, make_sharded_train_step
from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk
from oclpathtracer_tpu_torch.parallel import shard_pixels
from oclpathtracer_tpu_torch.parallel.dryrun import dryrun_multichip
from oclpathtracer_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

# The dry run's shape: 16×16, 2 bounces, 2 spp, key 0, step 0.
CFG = RenderConfig(width=16, height=16, bounces=2)
JCFG = JCfg(width=16, height=16, bounces=2)
SPP = 2
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_torch_diff.py's
KCFG = RenderConfig(width=16, height=16, bounces=3)  # tests/test_torch_grad_kernel.py's
KJCFG = JCfg(width=16, height=16, bounces=3)


def cpu_mesh(n: int) -> Mesh:
    return Mesh(("cpu",) * n)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.fixture(scope="module")
def jax_mesh(cpu_devices):
    return jdefault_mesh(cpu_devices)


@pytest.fixture(scope="module")
def jax_target(scene, jax_mesh):
    """The dry run's target through JAX: the sharded jnp render at 2 spp, seed 0."""
    return np.asarray(jrender_sharded(scene, JCFG, jax_mesh, total_spp=2, samples_per_step=2))


@pytest.fixture(scope="module")
def jax_steps(scene, jax_mesh, jax_target):
    """JAX's make_sharded_train_step on the 8-device mesh from the true albedo and
    emissive, at lr 1e-3 (the dry run's) and lr 1: {lr: (loss, params)}."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(jax_mesh, P("tiles"))
    pixel_ids = jax.device_put(jshard_pixels(JCFG, jax_mesh), sh)
    target = jax.device_put(jnp.asarray(jax_target), sh)
    out = {}
    for lr in (1e-3, 1.0):
        params = jinv.extract_params(scene, albedo=True, emissive=True)
        step = jinv.make_sharded_train_step(scene, JCFG, jax_mesh, spp=SPP, lr=lr)
        p, loss = step(params, target, pixel_ids, jnp.int32(0), jrng.make_key(0))
        out[lr] = (float(loss), [np.asarray(p.albedo), np.asarray(p.emissive)])
    return out


def _port_step(port_scene, n_dev: int, target: np.ndarray, lr: float):
    mesh = cpu_mesh(n_dev)
    params = inverse.extract_params(port_scene, albedo=True, emissive=True)
    step = make_sharded_train_step(port_scene, CFG, mesh, spp=SPP, lr=lr)
    p, loss = step(params, torch.tensor(target), shard_pixels(CFG, mesh), 0,
                   rng.make_key(0, device="cpu"))
    return float(loss), [p.albedo.numpy(), p.emissive.numpy()]


@pytest.mark.parametrize("n_dev", [1, 8])
def test_sharded_train_step_matches_jax(port_scene, jax_target, jax_steps, n_dev):
    loss, params = _port_step(port_scene, n_dev, jax_target, lr=1.0)
    want_loss, want_params = jax_steps[1.0]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for got, want in zip(params, want_params):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_sharded_train_step_8_entries_against_1(port_scene, jax_target):
    loss8, params8 = _port_step(port_scene, 8, jax_target, lr=1.0)
    loss1, params1 = _port_step(port_scene, 1, jax_target, lr=1.0)
    np.testing.assert_allclose(loss8, loss1, rtol=1e-5)
    for a, b in zip(params8, params1):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_sharded_train_step_leaves_unused_leaves_zero(port_scene):
    """A leaf the loss does not use gets a zero gradient (jax.grad's), so it stays."""
    mesh = cpu_mesh(2)
    cfg = RenderConfig(width=4, height=4, bounces=1)
    params = inverse.extract_params(port_scene, albedo=True, vertices=True)
    step = make_sharded_train_step(port_scene, cfg, mesh, spp=1, lr=1.0)
    p, _ = step(params, torch.zeros((16, 3)), shard_pixels(cfg, mesh), 0,
                rng.make_key(0, device="cpu"))
    for a, b in zip(p.vertices, params.vertices):
        assert torch.equal(a, b)


def test_dryrun_multichip_loss_matches_jax_and_hashes_agree(capsys, jax_steps):
    line8 = dryrun_multichip(8, device="cpu")
    line2 = dryrun_multichip(2, device="cpu")
    assert capsys.readouterr().out.splitlines() == [line8, line2]
    fields = [dict(kv.split("=") for kv in line.split(": ok, ")[1].split(", "))
              for line in (line8, line2)]
    assert line8.startswith("dryrun_multichip(8): ok, ")
    np.testing.assert_allclose(float(fields[0]["loss"]), jax_steps[1e-3][0], rtol=1e-5)
    for key in ("jnp_hash", "kernel_hash", "kernel_mean", "kernel_segs", "scan"):
        assert fields[0][key] == fields[1][key], key
    assert fields[0]["scan"] == "tp" and int(fields[0]["kernel_segs"]) > 0


@pytest.fixture(scope="module")
def kernel_case(scene, port_scene):
    """An interior point (the twin's clamp inert) and a target: (JAX ClassParams,
    port ClassParams, target numpy), as tests/test_torch_grad_kernel.py's SGD case."""
    jtrue = jfast.extract_class_params(scene)
    jparams = jfast.ClassParams(albedo=jnp.clip(jtrue.albedo + 0.2, 0.12, 0.95),
                                emissive=jtrue.emissive + 0.3)
    table, ct, n_classes, _ = gk.prepare_grad_scene(port_scene)
    img, _ = gk.render_grads_pallas(table, ct, KCFG, 1000, 4, n_classes, with_grads=False)
    target = (img / 4).numpy() * 0.7
    params = class_params_from_numpy(np.asarray(jparams.albedo), np.asarray(jparams.emissive),
                                     device="cpu")
    return jparams, params, target


def _spy_forwards(monkeypatch):
    """Record the images of the adjoint wrapper's forward-only calls."""
    images = []
    real = gk.render_grads_pallas

    def spy(*args, **kw):
        out = real(*args, **kw)
        if not kw.get("with_grads", True):
            images.append(out[0])
        return out

    monkeypatch.setattr(gk, "render_grads_pallas", spy)
    return images


def test_sharded_kernel_step_forwards_bitwise_and_agree(port_scene, kernel_case,
                                                        monkeypatch):
    """8 entries: each entry's two forwards are bit for bit those rows of the 1-entry
    step's; the loss and the new params agree with the 1-entry step and with
    make_kernel_train_step (rtol 1e-6; params 1e-6)."""
    _, params, target = kernel_case
    images = _spy_forwards(monkeypatch)
    lr, step_idx = 1e-2, 1
    t = torch.from_numpy(target)
    got8, loss8 = fast.make_sharded_kernel_train_step(port_scene, KCFG, cpu_mesh(8), 2,
                                                      lr)(params, t, step_idx)
    fwd8 = [torch.cat(images[k::2]) for k in range(2)]
    images.clear()
    got1, loss1 = fast.make_sharded_kernel_train_step(port_scene, KCFG, cpu_mesh(1), 2,
                                                      lr)(params, t, step_idx)
    assert len(images) == 2 and all(torch.equal(a, b) for a, b in zip(fwd8, images))
    got, loss = fast.make_kernel_train_step(port_scene, KCFG, 2, lr)(params, t, step_idx)
    for other_loss, other in ((loss1, got1), (loss, got)):
        np.testing.assert_allclose(float(loss8), float(other_loss), rtol=1e-6)
        for a, b in zip(got8, other):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_sharded_kernel_step_matches_jax_step(scene, port_scene, kernel_case):
    """One sharded kernel SGD step (8 entries) against JAX's step rule
    (_project_class(params − lr·g)) with g from jax.grad of the same pairwise loss
    through the JAX parity twin: ClassParams within 1e-4, loss within 1e-4 relative."""
    jparams, params, target = kernel_case
    spp, lr, step_idx = 2, 1e-2, 1
    render_twin = jfast.make_fast_renderer(scene, KJCFG, spp)[1]

    def jloss(p):
        sp = jfast.class_params_to_materials(scene, p)
        a = render_twin(sp, (2 * step_idx) * spp)
        b = render_twin(sp, (2 * step_idx + 1) * spp)
        return jnp.mean((a - target) * (b - target))

    l_j, g_j = jax.value_and_grad(jloss)(jparams)
    want = jfast._project_class(jfast.ClassParams(albedo=jparams.albedo - lr * g_j.albedo,
                                                  emissive=jparams.emissive - lr * g_j.emissive))
    step = fast.make_sharded_kernel_train_step(port_scene, KCFG, cpu_mesh(8), spp, lr)
    got, l_t = step(params, torch.from_numpy(target), step_idx)
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=1e-4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_sharded_kernel_step_rejects_a_mesh_that_does_not_divide(port_scene):
    with pytest.raises(ValueError, match="not divisible"):
        fast.make_sharded_kernel_train_step(port_scene, RenderConfig(33, 9, bounces=2),
                                            cpu_mesh(8), 2, 1e-2)
