"""The slice as a whole: the port's progressive driver against the JAX package's,
checkpoints shared between the two, the CLI, and that the port never imports JAX.

The JAX side runs its Pallas kernels in interpret mode (two calls, about 35 s)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oclpathtracer_tpu import RenderConfig as JCfg
from oclpathtracer_tpu.render import accumulate as jaccumulate
from oclpathtracer_tpu.render import driver as jdriver
from oclpathtracer_tpu_torch import cli
from oclpathtracer_tpu_torch.config import RenderConfig
from oclpathtracer_tpu_torch.convert import scene_from_numpy
from oclpathtracer_tpu_torch.render import accumulate
from oclpathtracer_tpu_torch.render import checkpoint as ckpt
from oclpathtracer_tpu_torch.render import driver

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def port_scene(scene):
    return scene_from_numpy(*[[np.asarray(x) for x in part] for part in scene], device="cpu")


@pytest.fixture(scope="module")
def jax_pallas_run(scene, tmp_path_factory):
    """JAX render_progressive(backend="pallas", scan="parity") at 32×32, 3 bounces,
    4 spp in steps of 2, leaving its checkpoint behind."""
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    img = jdriver.render_progressive(scene, JCfg(width=32, height=32, bounces=3), 4,
                                     samples_per_step=2, backend="pallas", scan="parity",
                                     checkpoint_path=path)
    return np.asarray(img), path


def test_render_progressive_pallas_matches_jax(port_scene, jax_pallas_run):
    img = driver.render_progressive(port_scene, RenderConfig(width=32, height=32, bounces=3),
                                    4, samples_per_step=2, backend="pallas", scan="parity")
    np.testing.assert_allclose(img.numpy(), jax_pallas_run[0], rtol=1e-4, atol=1e-4)


def test_jax_checkpoint_resumes_in_port(port_scene, jax_pallas_run, tmp_path):
    cfg = RenderConfig(width=32, height=32, bounces=3)
    path = str(tmp_path / "resume.npz")
    with open(jax_pallas_run[1], "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    acc, next_sample = ckpt.load(path)
    assert next_sample == 4 and int(acc.count) == 4
    resumed = driver.render_progressive(port_scene, cfg, 6, samples_per_step=2,
                                        backend="pallas", scan="parity", checkpoint_path=path)
    straight = driver.render_progressive(port_scene, cfg, 6, samples_per_step=2,
                                         backend="pallas", scan="parity")
    np.testing.assert_allclose(resumed.numpy(), straight.numpy(), rtol=1e-4, atol=1e-4)
    acc, next_sample = ckpt.load(path)
    assert next_sample == 6 and int(acc.count) == 6


def test_port_checkpoint_resume_is_exact(port_scene, tmp_path):
    cfg = RenderConfig(width=12, height=8, bounces=2)
    path = str(tmp_path / "port.npz")
    driver.render_progressive(port_scene, cfg, 2, samples_per_step=2, backend="pallas",
                              checkpoint_path=path)
    resumed = driver.render_progressive(port_scene, cfg, 4, samples_per_step=2,
                                        backend="pallas", checkpoint_path=path)
    straight = driver.render_progressive(port_scene, cfg, 4, samples_per_step=2,
                                         backend="pallas")
    assert torch.equal(resumed, straight)


def test_auto_deep_bounces_matches_jax(scene, port_scene):
    """9 bounces: both packages' auto picks the wavefront kernel with the tp scan;
    only the summation order differs (JAX's streams vs the port's k=1)."""
    img_j = jdriver.render_progressive(scene, JCfg(width=32, height=32, bounces=9), 2,
                                       samples_per_step=2, backend="auto")
    img_t = driver.render_progressive(port_scene, RenderConfig(width=32, height=32, bounces=9),
                                      2, samples_per_step=2, backend="auto")
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["jnp", "bvh", "widebvh"])
def test_unported_backends_raise(scene, port_scene, backend):
    """Each of these backends raised until it was ported: "bvh" and "widebvh" with
    the BVH kernels, "jnp" with the threefry streams. Each case now renders the
    Cornell box and matches JAX's render through the same backend (the BVH kernels
    in interpret mode; "jnp" the batched integrator, the JAX default), allclose at
    rtol = atol = 1e-4 (the JAX package's contract for the BVH kernels)."""
    img_j = jdriver.render_progressive(scene, JCfg(width=8, height=8, bounces=2), 2,
                                       samples_per_step=2, backend=backend)
    img_t = driver.render_progressive(port_scene, RenderConfig(8, 8, bounces=2), 2,
                                      samples_per_step=2, backend=backend)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)


def test_unknown_backend_raises(port_scene):
    with pytest.raises(ValueError):
        driver.render_progressive(port_scene, RenderConfig(8, 8, bounces=1), 1,
                                  backend="nope")


def test_cli_render_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "r.png")
    rc = cli.main(["render", "--device", "cpu", "--width", "8", "--height", "6",
                   "--spp", "2", "--bounces", "2", "--integrator", "wavefront",
                   "--interleave", "2", "-o", out])
    assert rc == 0 and os.path.getsize(out) > 0
    ppm = str(tmp_path / "r.ppm")
    assert cli.main(["render", "--device", "cpu", "--width", "8", "--height", "6",
                     "--spp", "1", "--bounces", "1", "--reference-quirk", "-o", ppm]) == 0
    with open(ppm) as f:
        assert f.read(2) == "P3"
    assert cli.main(["info"]) == 0
    assert "rendered 8x6" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--integrator", "bvh"], ["--integrator", "widebvh"],
                                  ["--integrator", "pallas", "--scan", "fast"],
                                  ["--integrator", "widebvh", "--scan", "fast"]])
def test_cli_renders_bvh_integrators_and_fast_scan(tmp_path, capsys, argv):
    out = str(tmp_path / "r.png")
    rc = cli.main(["render", "--device", "cpu", "--width", "8", "--height", "6",
                   "--spp", "2", "--bounces", "2", *argv, "-o", out])
    assert rc == 0 and os.path.getsize(out) > 0
    assert f"integrator={argv[1]}" in capsys.readouterr().out


def test_cli_profile_writes_trace_and_summary(tmp_path, capsys):
    prof = str(tmp_path / "prof")
    assert cli.main(["render", "--device", "cpu", "--width", "4", "--height", "4",
                     "--spp", "1", "--bounces", "1", "--profile", prof,
                     "-o", str(tmp_path / "p.png")]) == 0
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    with open(os.path.join(prof, "summary.txt")) as f:
        assert "Self CPU" in f.read()


@pytest.mark.parametrize("argv", [["render", "--integrator", "ao", "--scan-chunks", "1",
                                   "--device", "cpu"],
                                  ["render", "--scan-chunks", "2", "--device", "cpu"]])
def test_cli_unported_commands_exit_2(argv, capsys):
    assert cli.main(argv) == 2
    assert "not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("n_frames", [1, 2, 5])
def test_reference_average_matches_jax(n_frames):
    """The reference's gamma-space recurrence (frame 0 discarded at frame 1) against
    JAX's, and against the mean of frames 1.. in gamma space (tests/test_render.py)."""
    frames = np.random.RandomState(0).uniform(0.1, 1.0, (n_frames, 7, 3)).astype(np.float32)
    got = accumulate.reference_average(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, np.asarray(jaccumulate.reference_average(frames)),
                               rtol=1e-6, atol=1e-6)
    lin = frames[1:].mean(0) if n_frames > 1 else frames[0]
    np.testing.assert_allclose(got, np.power(lin, 1 / 2.2), atol=2e-3)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import oclpathtracer_tpu_torch, oclpathtracer_tpu_torch.render.driver\n"
            "import oclpathtracer_tpu_torch.cli, oclpathtracer_tpu_torch.kernels.wavefront\n"
            "import oclpathtracer_tpu_torch.kernels.selfcheck\n"
            "import oclpathtracer_tpu_torch.kernels.bvh_megakernel\n"
            "import oclpathtracer_tpu_torch.kernels.wide_bvh, oclpathtracer_tpu_torch.core.bvh\n"
            "import oclpathtracer_tpu_torch.scene.procgen\n"
            "import oclpathtracer_tpu_torch.integrators, oclpathtracer_tpu_torch.core\n"
            "import oclpathtracer_tpu_torch.diff, oclpathtracer_tpu_torch.diff.fast\n"
            "import oclpathtracer_tpu_torch.kernels.grad_megakernel\n"
            "import oclpathtracer_tpu_torch.convert\n"
            "import oclpathtracer_tpu_torch.diff.edge, oclpathtracer_tpu_torch.diff.secondary\n"
            "import oclpathtracer_tpu_torch.diff.vertex\n"
            "import oclpathtracer_tpu_torch.kernels.fast_integrators\n"
            "import oclpathtracer_tpu_torch.kernels.sorted_wavefront\n"
            "import oclpathtracer_tpu_torch.integrators.ao, oclpathtracer_tpu_torch.integrators.direct\n"
            "import oclpathtracer_tpu_torch.integrators.primary\n"
            "import oclpathtracer_tpu_torch.bench, oclpathtracer_tpu_torch.bench_train\n"
            "import oclpathtracer_tpu_torch.runtime, oclpathtracer_tpu_torch.runtime.buffers\n"
            "import oclpathtracer_tpu_torch.runtime.cache, oclpathtracer_tpu_torch.runtime.devices\n"
            "import oclpathtracer_tpu_torch.runtime.native, oclpathtracer_tpu_torch.runtime.profiling\n"
            "import oclpathtracer_tpu_torch.runtime.replay\n"
            "import oclpathtracer_tpu_torch.utils, oclpathtracer_tpu_torch.utils.errors\n"
            "import oclpathtracer_tpu_torch.utils.metrics\n"
            "import oclpathtracer_tpu_torch.parallel, oclpathtracer_tpu_torch.parallel.mesh\n"
            "import oclpathtracer_tpu_torch.parallel.sharded\n"
            "import oclpathtracer_tpu_torch.parallel.sharded_pallas\n"
            "import oclpathtracer_tpu_torch.parallel.multihost\n"
            "import oclpathtracer_tpu_torch.parallel.dryrun, oclpathtracer_tpu_torch.bench_scaling\n"
            "import oclpathtracer_tpu_torch.examples\n"
            "import oclpathtracer_tpu_torch.examples.multi_device\n"
            "import oclpathtracer_tpu_torch.examples.inverse_albedo\n"
            "import oclpathtracer_tpu_torch.examples.train_kernel\n"
            "import oclpathtracer_tpu_torch.examples.train_vertices\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'oclpathtracer_tpu' or m.startswith('oclpathtracer_tpu.')]\n"
            "assert not bad, bad\n"
            "from oclpathtracer_tpu_torch.kernels import cuda_build\n"
            "from oclpathtracer_tpu_torch.runtime import native\n"
            "loaded = (cuda_build._load_library.cache_info().currsize,\n"
            "          native._load_library.cache_info().currsize)\n"
            "assert loaded == (0, 0), 'a library was built or loaded at import'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
