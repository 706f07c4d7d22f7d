"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device (marker `cuda`) and skip without one; on a machine with a
card run them with `python -m pytest --noconftest tests/test_torch_cuda.py -q` (this
file needs no fixture of tests/conftest.py, which imports jax). They are
chip_smoke.py's phase-3 checks at 64×64 (kernels/selfcheck.py holds the cases and
the pass rule), for the linear and the BVH kernels (with the megakernel's and the
wavefront's work splits and table routes, the wide kernel on a 14-level tree and
split into launches, the skip-link kernel bit for bit in each leaf form, split into
launches and on the driver's route for trees deeper than the wide kernel's stack),
the adjoint kernel (on a ragged pixel range too) and the arbitrary-ray kernel (at
runs of 1, 2 and all samples a lane); the AO kernel (at 1, 2 and 32 lanes a pixel,
and at the CLI's shape) and the direct kernel (at 1, 2, 8 and 32 lanes a pixel and
n = 3 and 5 on both table routes, and at the CLI's shape), neither taking a table
off a 16-byte boundary; the sorted wavefront's live-list
launches (on a ray count no multiple of the block, and on a call whose rays all die
in the first launch); the vertex step's launches; and the bench
(`oclpathtracer_tpu_torch/bench.py`) at 64², its segments and images those of the
plain versions. Whether there is a card is decided inside the fixture, never at
import.
"""

import pytest
import torch

from oclpathtracer_tpu_torch.kernels import selfcheck
from oclpathtracer_tpu_torch.runtime import profiling

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SIZE = 64


def _launches(*kernels):
    """Each kernel's launches so far: runtime.profiling's `launch.<kernel>` counters."""
    now = profiling.counts()
    return tuple(now.get("launch." + k, 0) for k in kernels)


@pytest.fixture(scope="module")
def cuda_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return selfcheck.Tables("cuda")


@pytest.mark.parametrize("case", selfcheck.cases(SIZE, SIZE), ids=lambda c: c.name)
def test_kernel_matches_plain(cuda_tables, case):
    result = selfcheck.check_case(case, cuda_tables)
    assert result["ok"], result


@pytest.mark.parametrize("case", selfcheck.bvh_cases(SIZE, SIZE), ids=lambda c: c.name)
def test_bvh_kernel_matches_plain(cuda_tables, case):
    result = selfcheck.check_case(case, cuda_tables)
    assert result["ok"], result


def test_wavefront_k1_equals_megakernel_bitwise(cuda_tables):
    assert all(selfcheck.wavefront_k1_equals_megakernel(cuda_tables, SIZE, SIZE).values())


def test_kernel_tp_meets_parity_contract(cuda_tables):
    result = selfcheck.matches_parity(cuda_tables, "tp")
    assert result["ok"], result


def test_kernel_fast_meets_parity_contract(cuda_tables):
    result = selfcheck.matches_parity(cuda_tables, "fast")
    assert result["ok"], result


def test_table_in_global_memory_renders_as_in_shared(cuda_tables):
    assert all(selfcheck.global_table_matches_shared(cuda_tables, SIZE, SIZE).values())


@pytest.fixture(scope="module")
def linear_runs(cuda_tables):
    return selfcheck.linear_runs_agree(cuda_tables, SIZE, SIZE)


@pytest.mark.parametrize("name", [c.name for c in selfcheck.cases(SIZE, SIZE)
                                  if c.kernel == "megakernel"]
                         + ["megakernel tp tp0=1 pid_base 1000 n_rays 2001",
                            "megakernel parity tp0=0 pid_base 1000 n_rays 2001"])
def test_megakernel_at_runs_1_2_all_is_plain_bitwise(linear_runs, name):
    assert linear_runs[name], linear_runs


@pytest.mark.parametrize("case", [c for c in selfcheck.bvh_cases(SIZE, SIZE) if c.kernel == "bvh"],
                         ids=lambda c: c.name)
def test_skip_kernel_is_its_plain_version_bitwise(cuda_tables, case):
    result = selfcheck.check_case(case, cuda_tables)
    assert result["bitwise"], result


def test_skip_kernel_renders_a_tree_deeper_than_the_wide_stack(cuda_tables, monkeypatch):
    """render/driver.py's route: with the wide kernel's stack cut to 13 levels, the
    14-level deep_scene goes to the skip-link kernel, which gives the wide kernel's
    image bit for bit."""
    from oclpathtracer_tpu_torch.kernels import wide_bvh as wb
    from oclpathtracer_tpu_torch.render import driver

    deep = cuda_tables.scene("deep")
    cfg = selfcheck.scene_cfg("deep", SIZE, SIZE, 4)

    def render():
        return driver.render_progressive(deep, cfg, total_spp=4, samples_per_step=2,
                                         backend="auto")

    wide = render()
    monkeypatch.setattr(wb, "WIDE_MAX_DEPTH", 13)
    before = _launches("bvh", "wide_bvh")
    img = render()
    after = _launches("bvh", "wide_bvh")
    assert (after[0] - before[0], after[1] - before[1]) == (2, 0)
    assert torch.equal(img, wide)


def test_wide_kernel_is_the_skip_kernel_bitwise(cuda_tables):
    assert all(selfcheck.wide_equals_skip_walk(cuda_tables, SIZE, SIZE).values())


def test_wide_kernel_split_into_launches_or_with_the_largest_stack_gives_the_same_bits(
        cuda_tables):
    assert all(selfcheck.wide_chunks_agree(cuda_tables, SIZE, SIZE).values())


def test_wavefront_runs_and_routes_give_the_same_bits(cuda_tables):
    assert all(selfcheck.wavefront_splits_agree(cuda_tables, SIZE, SIZE).values())


def test_bvh_kernels_match_the_linear_kernel(cuda_tables):
    result = selfcheck.bvh_matches_linear(cuda_tables, SIZE, SIZE)
    assert all(r["ok"] for r in result.values()), result


def test_kernel_with_render_made_tp0_table_is_bitwise_the_same(cuda_tables):
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import megakernel as mk

    table, _, classes = cuda_tables.linear("cornell", "tp")
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=4)
    own = mk.render_samples_pallas_stats(table, cfg, 3, 4, scan="tp", classes=classes)
    given = mk.render_samples_pallas_stats(table, cfg, 3, 4, scan="tp", classes=classes,
                                           tp0_table=mk.tp0_table_for(table, cfg, "tp"))
    assert torch.equal(own[0], given[0]) and int(own[1]) == int(given[1])


# ---- the adjoint kernel: chip_smoke.py's phase-3 grad checks at 64×64 ----------

@pytest.fixture(scope="module")
def grad_results(cuda_tables):
    return selfcheck.grad_checks(cuda_tables, SIZE, SIZE)


def test_grad_kernel_forward_is_plain_and_tp_megakernel_bitwise(grad_results):
    assert grad_results["forward vs plain"]["ok"], grad_results["forward vs plain"]
    assert grad_results["forward vs tp megakernel (tp0 off)"]["ok"]


@pytest.mark.parametrize("point", ["true", "interior", "clamp binds"])
def test_grad_kernel_adjoint_matches_plain(grad_results, point):
    result = grad_results[f"adjoint vs plain at the {point} point"]
    assert result["ok"], result


def test_grad_kernel_rerun_gives_the_same_bits(grad_results):
    assert grad_results["adjoint rerun, same bits"]["ok"]


def test_grad_kernel_table_in_global_memory_gives_the_same_bits(grad_results):
    assert grad_results["table in global memory, same bits"]["ok"]


def test_grad_kernel_on_a_ragged_pixel_range_matches_plain(grad_results):
    result = grad_results["adjoint on pixels [1000, 3001) vs plain and the whole image's rows"]
    assert result["ok"], result


def test_kernel_train_step_launches_the_grad_kernel_four_times(cuda_tables):
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast

    scene = cuda_tables.scene("cornell")
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=4)
    step = fast.make_kernel_train_step(scene, cfg, spp=2, lr=1e-3)
    params = fast.extract_class_params(scene)
    before, = _launches("grad")
    params, loss = step(params, torch.zeros((cfg.n_pixels, 3), device="cuda"), 0)
    assert _launches("grad")[0] - before == 4
    assert bool(torch.isfinite(loss)) and params.albedo.device.type == "cuda"


def test_hybrid_forward_matches_the_plain_megakernel_on_a_card_packed_table(cuda_tables):
    result = selfcheck.hybrid_forward_check(cuda_tables, SIZE, SIZE, bounces=4, n_samples=2)
    assert result["ok"], result


def test_hybrid_loss_launches_the_megakernel_twice_a_step(cuda_tables):
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast, inverse

    scene = cuda_tables.scene("cornell")
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=4)
    loss_fn = fast.make_fast_loss_fn(scene, cfg, spp=2)
    params = inverse.extract_params(scene, albedo=True, emissive=True)
    before, = _launches("megakernel")
    loss, grads = inverse.value_and_grad(loss_fn, params,
                                         torch.zeros((cfg.n_pixels, 3), device="cuda"), 0)
    assert _launches("megakernel")[0] - before == 2
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in inverse.params_leaves(grads))


# ---- the arbitrary-ray kernel and the vertex path ---------------------------------

@pytest.fixture(scope="module")
def trace_rays_results(cuda_tables):
    return selfcheck.trace_rays_checks(cuda_tables, 8192, bounces=4, n_samples=2)


@pytest.mark.parametrize("scan", ["parity", "fast", "tp"])
def test_trace_rays_kernel_matches_plain_bitwise(trace_rays_results, scan):
    result = trace_rays_results[f"kernel vs plain, {scan}"]
    assert result["ok"] and result["bitwise"], result


@pytest.mark.parametrize("check", ["rerun, same bits", "table in global memory, same bits"])
def test_trace_rays_kernel_gives_the_same_bits(trace_rays_results, check):
    assert trace_rays_results[check]["ok"]


def test_constructors_default_to_the_card(cuda_tables):
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.scene import load_cornell_box
    from oclpathtracer_tpu_torch.scene.procgen import random_triangles, sphere_field

    assert load_cornell_box().geometry.p1.device.type == "cuda"
    assert sphere_field(1, 0).materials.albedo.device.type == "cuda"
    assert random_triangles(4).p1.device.type == "cuda"
    assert rng.make_key(0).device.type == "cuda"


def test_vertex_step_launches_the_megakernel_twice_and_trace_rays_four_times(cuda_tables):
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.diff import extract_params, make_vertex_train_step

    scene = cuda_tables.scene("cornell")
    cfg = RenderConfig(width=32, height=32, bounces=2)
    step, init = make_vertex_train_step(scene, cfg, 2, lambda ts: torch.optim.SGD(ts, lr=1e-4),
                                        interior_spp=0, samples_per_edge=8, edge_spp=2,
                                        secondary_samples_per_edge=4)
    params = extract_params(scene, albedo=False, vertices=True)
    state = init(params)
    before = _launches("megakernel", "trace_rays")
    params, state, loss = step(params, state, torch.zeros((cfg.n_pixels, 3), device="cuda"), 0,
                               rng.make_key(1))
    after = _launches("megakernel", "trace_rays")
    assert (after[0] - before[0], after[1] - before[1]) == (2, 4)
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v).all())
                                              for v in params.vertices)


# ---- the AO, direct-NEE and sorted-wavefront kernels ------------------------------

@pytest.fixture(scope="module")
def fast_results(cuda_tables):
    return selfcheck.fast_integrator_checks(cuda_tables, 96, 80, n_samples=2)


@pytest.mark.parametrize("check", ["kernel vs plain", "pid_base 1000 n_rays 5001 vs plain and "
                                   "vs the image's rows", "table in global memory, same bits"])
@pytest.mark.parametrize("kind", ["ao", "direct"])
def test_fast_integrator_kernels_are_their_plain_versions_bitwise(fast_results, kind, check):
    result = fast_results[f"{kind} {check}"]
    assert result["ok"], result


def test_ao_kernel_at_1_2_and_32_lanes_gives_the_same_bits(fast_results):
    result = fast_results["ao at 1, 2 and 32 lanes a pixel, same bits"]
    assert result["ok"], result


def test_direct_kernel_at_1_2_8_and_32_lanes_and_n_3_and_5_gives_the_same_bits(fast_results):
    """Lanes past n trace samples they drop; each round adds the group's radiances in
    lane order, on the shared route (eye rows) and the global one (every row)."""
    result = fast_results["direct at 1, 2, 8 and 32 lanes a pixel, n = 3 and 5, both routes, "
                          "same bits"]
    assert result["ok"], result


def test_ao_kernel_is_its_plain_version_at_the_cli_shape(cuda_tables):
    """512², 64 spp in one launch (the CLI's ao-pallas): the split and the eye rows
    at the shape the main path runs."""
    from oclpathtracer_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=512, height=512)
    got = selfcheck.run_fast("ao", cuda_tables, cfg, 0, 64)
    want = selfcheck.run_fast("ao", cuda_tables, cfg, 0, 64, plain=True)
    assert torch.equal(got, want) and 10.0 < float(got.mean()) < 64.0


def test_direct_kernel_is_its_plain_version_at_the_cli_shape(cuda_tables):
    """512², 64 spp in one launch (the CLI's direct-pallas): 8 lanes a pixel, 8
    rounds, the eye rows and the staged lights at the shape the main path runs."""
    from oclpathtracer_tpu_torch.config import RenderConfig

    cfg = RenderConfig(width=512, height=512)
    got = selfcheck.run_fast("direct", cuda_tables, cfg, 0, 64)
    want = selfcheck.run_fast("direct", cuda_tables, cfg, 0, 64, plain=True)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert float(got.mean()) > 64 * 0.1  # lit


@pytest.mark.parametrize("kind", ["ao", "direct"])
def test_fast_integrator_wrappers_refuse_a_table_off_16_bytes(cuda_tables, kind):
    """The kernels read table rows (and light rows) as float4s."""
    from oclpathtracer_tpu_torch.config import RenderConfig

    table = cuda_tables.linear("cornell", "parity")[0]
    off = torch.empty(table.numel() + 1, device="cuda")[1:].view(table.shape)
    off.copy_(table)
    with pytest.raises(ValueError, match="16-byte"):
        selfcheck.run_fast(kind, cuda_tables, RenderConfig(width=8, height=8), 0, 1, table=off)


@pytest.fixture(scope="module")
def sorted_results(cuda_tables):
    return selfcheck.sorted_checks(cuda_tables, SIZE, SIZE, bounces=4, n_samples=2)


@pytest.mark.parametrize("check", ["kernel vs plain", "vs the skip-link kernel"])
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("scene", ["cornell", "spheres5k", "cornell 13x11 3spp",
                                   "cornell looking away"])
def test_sorted_wavefront_kernel_is_bitwise(sorted_results, scene, sort, check):
    result = sorted_results[f"{scene} sort={sort} {check}"]
    assert result["ok"], result


def test_sorted_wavefront_when_every_ray_dies_in_the_first_launch(sorted_results):
    result = sorted_results["cornell looking away: one segment a ray"]
    assert result["ok"], result


def test_integrator_wrappers_launch_their_kernels_once(cuda_tables):
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw

    cfg = RenderConfig(width=32, height=32, bounces=3)
    before = _launches("ao", "direct", "sorted")
    for kind in ("ao", "direct"):
        img = selfcheck.run_fast(kind, cuda_tables, cfg, 0, 4)
        assert img.shape == (cfg.n_pixels, 3) and bool(torch.isfinite(img).all())
    img = sw.render_sorted(cuda_tables.scene("cornell"), cfg, 4)
    assert bool(torch.isfinite(img).all()) and img.device.type == "cuda"
    after = _launches("ao", "direct", "sorted")
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (1, 1, 3)


def test_bench_on_the_card_counts_the_plain_segments(cuda_tables, capsys):
    """bench.run at 64², 2 bounces (3 for the deep pair), 2 frames: the line's rates
    finite and > 0; each configuration's segment count on the card that of its plain
    version on the CPU, and the image within rtol = atol = 1e-4 of it (torch's CPU
    and CUDA math functions round differently: the kernels are bit for bit their
    plain versions on the card, kernels/selfcheck.py)."""
    import json
    import math

    from oclpathtracer_tpu_torch import bench
    from oclpathtracer_tpu_torch.scene import load_cornell_box

    shape = (64, 64, 2, 3, 1, 2, 2)
    line = bench.run(*shape, pairs=1, device="cuda")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert all(math.isfinite(v) and v > 0 for k, v in line.items()
               if k not in ("metric", "unit"))
    card = bench.make_runs(load_cornell_box(device="cuda"), *shape)
    host = bench.make_runs(load_cornell_box(device="cpu"), *shape)
    for name in card:
        img, segs = card[name]()
        want, want_segs = host[name]()
        assert int(segs) == int(want_segs) > 0, name
        torch.testing.assert_close(img.cpu(), want, rtol=1e-4, atol=1e-4, msg=name)


def _card_mesh(n):
    from oclpathtracer_tpu_torch.parallel.mesh import Mesh

    return Mesh(("cuda:0",) * n)


@pytest.mark.parametrize("kernel", ["megakernel", "wavefront"])
@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_kernel_step_is_one_call_bitwise(cuda_tables, kernel, n_dev):
    """make_sharded_kernel_step on n × cuda:0 (tp, 64², 4 bounces, 4 spp): the image and
    segments bit for bit one call's, the launches n."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import megakernel as mk
    from oclpathtracer_tpu_torch.kernels import wavefront as wf
    from oclpathtracer_tpu_torch.parallel.sharded_pallas import make_sharded_kernel_step

    cfg = RenderConfig(SIZE, SIZE, bounces=4)
    table, emi, classes = cuda_tables.linear("cornell", "tp")
    kw = dict(scan="tp", emi_const=emi, classes=classes)
    single = (mk.render_samples_pallas_stats if kernel == "megakernel"
              else wf.render_samples_wavefront_stats)
    want, want_segs = single(table, cfg, 3, 4, **kw)
    before, = _launches(kernel)
    img, segs = make_sharded_kernel_step(cfg, _card_mesh(n_dev), 4, kernel=kernel,
                                         **kw)(table, 3)
    assert _launches(kernel)[0] - before == n_dev
    assert torch.equal(img, want) and int(segs) == int(want_segs) > 0


def test_sharded_twin_render_is_the_single_render_bitwise(cuda_tables):
    """render_progressive_sharded at 33×9 on 8 × cuda:0 against render_progressive."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.parallel import render_progressive_sharded
    from oclpathtracer_tpu_torch.render.driver import render_progressive

    cfg = RenderConfig(33, 9, bounces=2)
    scene = cuda_tables.scene("cornell")
    img = render_progressive_sharded(scene, cfg, _card_mesh(8), 2, samples_per_step=2)
    assert torch.equal(img, render_progressive(scene, cfg, 2, samples_per_step=2))


def test_sharded_kernel_train_step_forwards_are_bitwise(cuda_tables):
    """make_sharded_kernel_train_step on 8 × cuda:0 against 1 entry (64², 4 bounces,
    2 spp): 32 adjoint launches against 4, the loss within 1e-6, the new params
    within 1e-6, and a rerun bit for bit."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast
    from oclpathtracer_tpu_torch.examples import train_kernel

    scene = cuda_tables.scene("cornell")
    cfg = RenderConfig(SIZE, SIZE, bounces=4)
    target = train_kernel.target_image(scene, cfg, 4)
    params = train_kernel.perturbed(fast.extract_class_params(scene))
    out = {}
    for n in (8, 1, 8):
        before, = _launches("grad")
        step = fast.make_sharded_kernel_train_step(scene, cfg, _card_mesh(n), 2, 3e-2)
        new, loss = step(params, target, 0)
        assert _launches("grad")[0] - before == 4 * n
        if n in out:
            assert torch.equal(out[n][1], loss) and all(torch.equal(a, b)
                                                        for a, b in zip(out[n][0], new))
        out[n] = (new, loss)
    torch.testing.assert_close(out[8][1], out[1][1], rtol=1e-6, atol=0)
    for a, b in zip(out[8][0], out[1][0]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_dryrun_multichip_on_the_card(cuda_tables, capsys):
    from oclpathtracer_tpu_torch.parallel.dryrun import dryrun_multichip

    line = dryrun_multichip(8)
    assert line.startswith("dryrun_multichip(8): ok, loss=") and "scan=tp" in line
    assert capsys.readouterr().out.strip() == line
