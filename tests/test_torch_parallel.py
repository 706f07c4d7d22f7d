"""The port's distribution layer (`oclpathtracer_tpu_torch/parallel/`) on CPU meshes.

The port's counterparts of tests/test_parallel.py: a mesh of 8 × `cpu` stands for the
conftest's 8-device virtual CPU mesh. The north-star invariant holds bit for bit: a
sharded render (the batched integrator, and the megakernel's and the wavefront's plain
versions) is the port's single-device render on any mesh, because every RNG stream
keys on the absolute pixel id. Against the JAX package: the sharded twin render
against JAX's `render_progressive_sharded` on the 8-device mesh (rtol = atol = 1e-4),
and the sharded kernels against the JAX parity twin under the tp contract
(tests/test_torch_megakernel.py: rtol = atol = 1e-4, |Δsegments| ≤ 2; parity: equal
segments). JAX's own sharded kernel tests are `slow` (interpret-mode Pallas under
shard_map), so the kernels' single call is the port's own.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.core import rng as jrng
from oclpathtracer_tpu.diff.inverse import render_spp as jrender_spp
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.parallel.mesh import default_mesh as jdefault_mesh
from oclpathtracer_tpu.parallel.sharded import render_progressive_sharded as jrender_sharded
from oclpathtracer_tpu.parallel.sharded import shard_pixels as jshard_pixels
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.core import rng
from oclpathtracer_tpu_torch.diff import extract_params, make_sharded_train_step
from oclpathtracer_tpu_torch.diff.inverse import render_spp
from oclpathtracer_tpu_torch.kernels import megakernel as mk
from oclpathtracer_tpu_torch.kernels import wavefront as wf
from oclpathtracer_tpu_torch.parallel import (
    default_mesh,
    multihost,
    make_sharded_render_step,
    render_progressive_sharded,
    shard_pixels,
    tile_sharding,
)
from oclpathtracer_tpu_torch.parallel.mesh import Mesh, replicated
from oclpathtracer_tpu_torch.parallel.sharded_pallas import (
    make_sharded_kernel_step,
    render_pallas_sharded,
)
from oclpathtracer_tpu_torch.render.accumulate import Accumulator
from oclpathtracer_tpu_torch.render.driver import render_progressive
from oclpathtracer_tpu_torch.runtime import make_mesh

torch.set_num_threads(1)

CFG = RenderConfig(width=32, height=32, bounces=4)
RAGGED = RenderConfig(width=33, height=9, bounces=2)  # 297 px: 8 entries pad to 304
KCFG = RenderConfig(width=64, height=32, bounces=4)   # 2048 px / 8 entries = 256


def cpu_mesh(n: int) -> Mesh:
    return Mesh(("cpu",) * n)


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


def test_shard_pixels_pads_and_masks(cpu_devices):
    mesh = cpu_mesh(8)
    ids = shard_pixels(CFG, mesh)
    assert ids.shape == (CFG.n_pixels,) and torch.equal(ids, torch.arange(CFG.n_pixels))
    bad = RenderConfig(width=33, height=7)  # 231 px on 8 entries → 232
    ids = shard_pixels(bad, mesh)
    assert ids.shape == (232,) and ids.dtype == torch.int64
    assert torch.equal(ids[:231], torch.arange(231)) and int(ids[231]) == 230
    want = jshard_pixels(JCfg(width=33, height=7), jdefault_mesh(cpu_devices))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))


def test_sharded_render_non_divisible_bitwise(port_scene):
    """33×9 (297 px, not divisible by 8) is bit for bit the single-device render: the
    pad tail is dropped at assembly."""
    img_sharded = render_progressive_sharded(port_scene, RAGGED, cpu_mesh(8), total_spp=2,
                                             samples_per_step=2)
    img_single = render_progressive(port_scene, RAGGED, total_spp=2, samples_per_step=2)
    assert img_sharded.shape == (RAGGED.n_pixels, 3)
    assert torch.equal(img_sharded, img_single)


@pytest.fixture(scope="module")
def single_image(port_scene):
    return render_progressive(port_scene, CFG, total_spp=4, samples_per_step=2)


@pytest.fixture(scope="module")
def sharded_images(port_scene):
    return {n: render_progressive_sharded(port_scene, CFG, cpu_mesh(n), total_spp=4,
                                          samples_per_step=2) for n in (2, 8)}


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single_device_bitwise(single_image, sharded_images, n_dev):
    assert torch.equal(sharded_images[n_dev], single_image), (
        "sharded render must be bit for bit the single-device one")


def test_sharded_layouts_agree(sharded_images):
    """2- and 8-entry meshes agree with each other bit for bit too."""
    assert torch.equal(sharded_images[2], sharded_images[8])


def test_sharded_render_matches_jax_sharded(scene, port_scene, cpu_devices):
    """Against JAX's render_progressive_sharded on the 8-device CPU mesh, same seed."""
    cfg = RenderConfig(width=16, height=16, bounces=2)
    want = jrender_sharded(scene, JCfg(width=16, height=16, bounces=2),
                           jdefault_mesh(cpu_devices), total_spp=2, samples_per_step=2)
    got = render_progressive_sharded(port_scene, cfg, cpu_mesh(8), total_spp=2,
                                     samples_per_step=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_sharded_render_step_accumulates_per_entry(port_scene):
    """make_sharded_render_step keeps one Accumulator per entry over its block."""
    cfg = RenderConfig(width=8, height=4, bounces=1)
    mesh = cpu_mesh(4)
    step = make_sharded_render_step(cfg, mesh, 2)
    accs = step([Accumulator.zeros(8, "cpu") for _ in range(4)], port_scene,
                shard_pixels(cfg, mesh), 0, rng.make_key(0, device="cpu"))
    assert [a.sum.shape for a in accs] == [(8, 3)] * 4 and all(int(a.count) == 2 for a in accs)
    whole = render_progressive(port_scene, cfg, 2, samples_per_step=2, seed=0)
    assert torch.equal(torch.cat([a.mean() for a in accs]), whole)


def _jax_twin(scene, cfg: RenderConfig, start: int, n: int):
    jcfg = JCfg(width=cfg.width, height=cfg.height, bounces=cfg.bounces)
    img = sum(np.asarray(jparity.render_sample_ref(scene, jcfg, f))
              for f in range(start, start + n))
    segs = int(jparity.count_segments_ref(scene, jcfg, jnp.arange(start, start + n)))
    return img, segs


@pytest.fixture(scope="module")
def jax_kernel_reference(scene):
    return _jax_twin(scene, KCFG, 0, 2)


@pytest.mark.parametrize("scan_req", ["parity", "fast", "tp"])
def test_sharded_megakernel_bitwise_matches_single(port_scene, jax_kernel_reference,
                                                   scan_req):
    """render_pallas_sharded (8 entries, absolute pid_base each) is bit for bit the
    single call, for every scan, and within the tp contract of the JAX parity twin."""
    img_sh = render_pallas_sharded(port_scene, KCFG, cpu_mesh(8), total_spp=2, scan=scan_req)
    scan, table, emi, classes = mk.prepare_scan(port_scene, scan_req)
    img_1 = mk.render_samples_pallas(table, KCFG, 0, 2, scan=scan, emi_const=emi,
                                     classes=classes) / 2
    assert torch.equal(img_sh, img_1)
    np.testing.assert_allclose(img_sh.numpy() * 2, jax_kernel_reference[0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kernel", ["megakernel", "wavefront"])
@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_kernel_step_bitwise_and_segments(port_scene, jax_kernel_reference, kernel,
                                                  n_dev):
    """make_sharded_kernel_step, tp (auto): image and segments bit for bit the single
    call's (the wavefront at interleave 1), segments within 2 of the JAX twin's."""
    scan, table, emi, classes = mk.prepare_scan(port_scene, "auto")
    step = make_sharded_kernel_step(KCFG, cpu_mesh(n_dev), 2, scan=scan, emi_const=emi,
                                    classes=classes, kernel=kernel, interleave=1)
    img_sh, segs_sh = step(table, 0)
    single = (mk.render_samples_pallas_stats if kernel == "megakernel"
              else wf.render_samples_wavefront_stats)
    img_1, segs_1 = single(table, KCFG, 0, 2, scan=scan, emi_const=emi, classes=classes)
    assert torch.equal(img_sh, img_1)
    assert segs_sh.dtype == torch.int64 and int(segs_sh) == int(segs_1)
    assert abs(int(segs_sh) - jax_kernel_reference[1]) <= 2
    np.testing.assert_allclose(img_sh.numpy(), jax_kernel_reference[0], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kernel", ["megakernel", "wavefront"])
@pytest.mark.parametrize("scan_req", ["parity", "tp"])
@pytest.mark.parametrize("n_dev", [3, 9])
def test_sharded_kernels_on_odd_ranges_bitwise(port_scene, kernel, scan_req, n_dev):
    """33×9 over 3 and 9 entries: ranges of 99 and 33 pixels at odd offsets."""
    scan, table, emi, classes = mk.prepare_scan(port_scene, scan_req)
    step = make_sharded_kernel_step(RAGGED, cpu_mesh(n_dev), 2, scan=scan, emi_const=emi,
                                    classes=classes, kernel=kernel)
    img_sh, segs_sh = step(table, 5)
    single = (mk.render_samples_pallas_stats if kernel == "megakernel"
              else wf.render_samples_wavefront_stats)
    img_1, segs_1 = single(table, RAGGED, 5, 2, scan=scan, emi_const=emi, classes=classes)
    assert torch.equal(img_sh, img_1) and int(segs_sh) == int(segs_1)


def test_parity_sharded_segments_equal_jax_twin(scene, port_scene):
    """The parity megakernel's sharded segment count is the JAX twin's exactly."""
    want_img, want_segs = _jax_twin(scene, RAGGED, 5, 2)
    scan, table, emi, classes = mk.prepare_scan(port_scene, "parity")
    img, segs = make_sharded_kernel_step(RAGGED, cpu_mesh(9), 2, scan=scan)(table, 5)
    assert int(segs) == want_segs
    np.testing.assert_allclose(img.numpy(), want_img, rtol=1e-4, atol=1e-4)


def test_kernel_step_rejects_bad_calls():
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_kernel_step(RAGGED, cpu_mesh(8), 2)
    with pytest.raises(ValueError, match="kernel must be"):
        make_sharded_kernel_step(KCFG, cpu_mesh(8), 2, kernel="bvh")
    with pytest.raises(ValueError, match="1-D 'tiles' mesh"):
        make_sharded_kernel_step(KCFG, Mesh(("cpu",) * 4, ("hosts", "tiles"), (2, 2)), 2)


def test_render_pallas_sharded_short_trailing_chunk(port_scene):
    """total_spp not a multiple of samples_per_call: chunks of 2, 2, 1 samples, the
    same bits as the single-device render_pallas with those chunks."""
    cfg = RenderConfig(width=16, height=16, bounces=3)
    got = render_pallas_sharded(port_scene, cfg, cpu_mesh(8), total_spp=5,
                                samples_per_call=2)
    want = mk.render_pallas(port_scene, cfg, 5, samples_per_call=2)
    assert torch.equal(got, want)


def test_make_mesh_and_its_value_error():
    mesh = make_mesh((8,), ("tiles",), ["cpu"] * 8)
    assert mesh.shape == {"tiles": 8} and mesh.devices == (torch.device("cpu"),) * 8
    grid = make_mesh((2, 4), ("hosts", "tiles"), ["cpu"] * 9)
    assert grid.shape == {"hosts": 2, "tiles": 4} and grid.size == 8
    with pytest.raises(ValueError, match="need 16 devices"):
        make_mesh((16,), ("tiles",), ["cpu"] * 8)


def test_default_mesh_needs_a_card_or_devices(monkeypatch):
    assert default_mesh(["cpu"] * 8, n=3).shape == {"tiles": 3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()


def test_tile_sharding_and_replicated():
    mesh = cpu_mesh(4)
    x = torch.arange(24.0).reshape(8, 3)
    parts = tile_sharding(mesh)(x)
    assert len(parts) == 4 and all(torch.equal(p, x[2 * i:2 * i + 2])
                                   for i, p in enumerate(parts))
    with pytest.raises(ValueError, match="not divisible"):
        tile_sharding(mesh)(x[:6])
    copies = replicated(mesh)(x)
    assert len(copies) == 4 and all(c is x for c in copies)  # one device: no copy


def test_multihost_two_process(scene, port_scene, tmp_path):
    """A REAL torch.distributed bring-up: 2 processes (gloo, one CPU device each).

    Each worker renders its host_local_pixel_slice strip and all-reduces the strip's
    sum, then takes one sharded twin train step on its strip. The assembled strips
    must be bit for bit the port's single-process render_spp and within 1e-4 of
    JAX's; both workers must agree on the sum, and on a step that is the
    single-process step's (rtol 1e-5)."""
    with socket.socket() as s:  # a free port for rank 0's store
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = str(Path(__file__).resolve().parents[1])
    worker = str(Path(__file__).with_name("_torch_multihost_worker.py"))
    env = {k: v for k, v in os.environ.items()
           if not (k.startswith(("XLA_", "JAX_", "TPU_", "PALLAS_")) or k == "PYTHONPATH")}
    env.update(PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", str(port), str(tmp_path)],
                              env=env, cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"

    img = np.concatenate([np.load(tmp_path / f"strip_{r}.npy") for r in range(2)])
    cfg = RenderConfig(width=32, height=16, bounces=2)
    ref = render_spp(port_scene, cfg, 2, rng.make_key(5, device="cpu")).numpy()
    np.testing.assert_array_equal(img, ref)
    want = jrender_spp(scene, JCfg(width=32, height=16, bounces=2), 2, jrng.make_key(5))
    np.testing.assert_allclose(img, np.asarray(want), rtol=1e-4, atol=1e-4)
    sums = [float(np.load(tmp_path / f"psum_{r}.npy")) for r in range(2)]
    assert sums[0] == sums[1]
    np.testing.assert_allclose(sums[0], img.sum(), rtol=1e-5)

    steps = [np.load(tmp_path / f"step_{r}.npz") for r in range(2)]
    for key in ("loss", "albedo", "emissive"):
        assert np.array_equal(steps[0][key], steps[1][key]), key
    one = make_sharded_train_step(port_scene, cfg, cpu_mesh(1), spp=2, lr=1.0)
    params, loss = one(extract_params(port_scene, albedo=True, emissive=True),
                       torch.full((cfg.n_pixels, 3), 0.5), torch.arange(cfg.n_pixels), 0,
                       rng.make_key(0, device="cpu"))
    np.testing.assert_allclose(steps[0]["loss"], loss.numpy(), rtol=1e-5)
    np.testing.assert_allclose(steps[0]["albedo"], params.albedo.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(steps[0]["emissive"], params.emissive.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_multihost_helpers_single_process():
    devices = ["cpu"] * 8
    mesh = multihost.global_mesh(devices)
    assert mesh.shape["tiles"] == 8
    s = multihost.host_local_pixel_slice(1024, devices)
    assert (s.start, s.stop) == (0, 1024)  # a single process owns everything
    s = multihost.host_local_pixel_slice(1001, devices)  # non-divisible: clipped pad
    assert (s.start, s.stop) == (0, 1001)
    assert multihost.process_count() == 1 and multihost.is_coordinator()
    multihost.initialize()  # one process: a no-op
    multihost.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    x = [torch.ones(3)]
    assert multihost.all_reduce_sum(x)[0] is x[0]
    with pytest.raises(ValueError, match="needs coordinator_address"):
        multihost.initialize(num_processes=2)
