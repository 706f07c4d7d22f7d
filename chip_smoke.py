#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`oclpathtracer_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi);
  2. build: compile the five CUDA kernels from kernels/csrc with nvcc, one process
     per source, all at once;
  3. kernel vs plain PyTorch version on the card (kernels/selfcheck.py): the
     linear kernels on the Cornell box in parity, fast and tp form, wavefront k=1
     vs megakernel bit for bit, fast and tp vs parity under the JAX contract, a
     table past shared memory (read from global memory) bit for bit as in shared
     memory; the skip-link and 8-wide BVH kernels in each leaf form on
     sphere_field(3, 1), sphere_field() and the Cornell box, wide vs skip-link bit
     for bit, and both against the linear kernel reading sphere_field()'s table
     from global memory (an independent brute-force search); the adjoint kernel
     (kernels/selfcheck.py grad_checks) at 128², 4 bounces, 2 spp: its forward bit
     for bit against its plain version and against the tp megakernel with tp0 off,
     the adjoint against its plain version (image and segments bit for bit, the
     (C, 6) gradients within 1e-4·max|g|) at the true, an interior and a
     clamp-binding point, and two launches of the adjoint giving the same bits;
     the hybrid renderer's forward (diff/fast.make_fast_renderer) at 256², 4
     bounces, 8 spp: pack_scene on the card bit for bit as on the host, and the
     forward against the megakernel's plain version on that table;
  4. main path, with every launch counter set to 0 first:
     render_progressive(backend="auto") at 512², 16 bounces on the Cornell box
     (16384 spp, wavefront kernel), on sphere_field() (5,124 tris) and on
     sphere_field(80, 3) (102,404 tris), both through the 8-wide BVH kernel;
     the Cornell box through backend="widebvh" at 16384 spp; render_pallas at
     512², 4 bounces (megakernel); the CLI `render` with the megakernel, `widebvh`
     and `bvh`. Every kernel's launch counter must go up, the images must be finite
     and ≥ 0, and both 16384-spp Cornell images must match the checked-in render
     of the same reference-stream samples
     (artifacts/cornell_512_16b_16384spp_tpu.png) to a downsampled rel-L2 < 1e-3
     (at 256 spp sample noise alone gives 0.056 against it, at 1024 spp 0.017:
     measured on an H100, so the check renders all 16384 samples; with the same
     streams it reads about 2e-5, quantisation to 8 bits);
  4b. training path on the Cornell box, with every launch counter set to 0 first:
     examples/train_kernel.py's recovery run through make_kernel_train_step (128²,
     4 bounces, 8 spp, 80 steps, lr 3e-2, target at the true classes from frame
     1,000,000 at 64 spp, albedo + 0.25): the class-albedo error must fall, the
     losses stay finite, and each step launch the adjoint kernel exactly 4 times;
     10 steps of make_kernel_optax_step (torch.optim.Adam, 5e-2) at 256², 4
     bounces, 8 spp, on fixed frames, whose loss must drop; 3 steps each of the hybrid
     (make_fast_loss_fn: megakernel forward, twin backward; exactly 2 megakernel
     launches a step) and of make_train_step (the twin, none) at that size, the
     megakernel's launches in this phase being those 6; render_progressive(backend="jnp")
     at 128², 4 bounces, 16 spp, whose mean must agree with the megakernel's
     render of as many samples within 5 % (other streams, same estimator);
  5. timing with CUDA events (warm-up, median of 5 for kernels; one run for plain
     versions) of each kernel and its plain version at the main path's launch
     shape (512², 64 samples per launch; the BVH kernels' plain versions at 1
     sample, against the kernel at 1 sample), as Mrays/s = traced segments per
     second; the two results of each pair are held against each other by phase
     3's rule. Then the linear-vs-BVH crossover: the megakernel against the 8-wide
     BVH kernel, fast scan, on sphere_field(n, 2) for n = 1..16 at 256², 4 bounces.
     The adjoint kernel forward-only and with gradients against its plain version
     at 256², 4 bounces, 8 spp (bench_train.py's shape), and the three train steps
     (kernel, hybrid, twin) in ms/step (host clock around synchronize, median) and
     Mrays/s counted as bench_train.py:12-18 counts: 4 × the segments of one spp
     window for the kernel and hybrid steps, 2 × for the twin; one more step of each
     under torch.profiler gives its device time and busy share.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels as JSON.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ARTIFACT = os.path.join(ROOT, "artifacts", "cornell_512_16b_16384spp_tpu.png")
REL_L2_MAX = 1e-3
MAIN_SPP = 16384  # the artifact's own sample count
MAIN_STEP = 64    # samples per launch on the main path
BVH_MAIN_SPP = 256  # the procedural scenes' main-path renders
TIME_START = 64   # the main path's second launch
DOWNSAMPLE = 16
SMOKE_SIZE = 128
CROSSOVER_SPHERES = (1, 2, 4, 8, 16)  # sphere_field(n, 2): 324 to 5,124 tris
CROSSOVER_SIZE = 256
TRAIN_SIZE = 256     # bench_train.py's shape: 256², 4 bounces, 8 spp per render
TRAIN_SPP = 8
RECOVERY_SIZE = 128  # examples/train_kernel.py's recovery run
RECOVERY_STEPS = 80
TARGET_START = 1_000_000
TARGET_SPP = 64
JNP_MEAN_REL_MAX = 0.05
GRAD_TIME_CALLS = 20  # launches per timed run of the adjoint kernel (about 0.5 ms each)
RENDER_KERNELS = ("megakernel", "wavefront", "bvh_megakernel", "wide_bvh")


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def read_png_rgb8(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG whose rows all use filter 0 (what write_png writes)."""
    with open(path, "rb") as f:
        data = f.read()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    off, idat, width, height = 8, b"", 0, 0
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        tag, payload = data[off + 4:off + 8], data[off + 8:off + 8 + n]
        off += 12 + n
        if tag == b"IHDR":
            width, height, depth, ctype = struct.unpack(">IIBB", payload[:10])
            require(depth == 8 and ctype == 2, f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += payload
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(height, 1 + 3 * width)
    require(bool((rows[:, 0] == 0).all()), f"{path}: a row uses a PNG filter other than 0")
    return rows[:, 1:].reshape(height, width, 3)


def downsampled_rel_l2(img: np.ndarray, ref_u8: np.ndarray) -> float:
    from oclpathtracer_tpu_torch.render.image import to_u8

    h, w, _ = ref_u8.shape
    mine = to_u8(np.power(np.maximum(img.reshape(h, w, 3), 0.0), 1.0 / 2.2))

    def box(x):
        x = x.astype(np.float64)
        return x.reshape(h // DOWNSAMPLE, DOWNSAMPLE, w // DOWNSAMPLE, DOWNSAMPLE, 3).mean((1, 3))

    a, b = box(mine), box(ref_u8)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def cuda_time_ms(fn, warmup, reps: int = 5, calls: int = 1):
    """Median ms of `fn()` over `reps` runs (CUDA events), after one `warmup()`;
    returns (ms, the last result). With calls > 1 each run makes that many calls
    back to back and counts their mean, so that a short kernel's time is not its
    host-side launch work."""
    import torch

    warmup()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"name {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    from oclpathtracer_tpu_torch.kernels import cuda_build

    lib, info = cuda_build.load_library()
    log(f"[build] {'built' if info.built else 'loaded'} {os.path.relpath(info.path, ROOT)} "
        f"in {info.seconds:.2f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] {line.strip()}")


def report(name, r, failed):
    log(f"[check] {name}: pixels {r['pixel_fraction']:.6f} max|diff| {r['max_abs_err']:.3g} "
        f"segments {r['segments_kernel']} vs {r['segments_plain']} bitwise {r['bitwise']} "
        f"{'ok' if r['ok'] else 'FAIL'}")
    if not r["ok"]:
        failed.append(name)


def phase_checks(tables):
    from oclpathtracer_tpu_torch.kernels import selfcheck

    failed = []
    for case in selfcheck.cases(SMOKE_SIZE, SMOKE_SIZE) + selfcheck.bvh_cases(SMOKE_SIZE,
                                                                                SMOKE_SIZE):
        report(f"{case.name} {case.n_samples}spp", selfcheck.check_case(case, tables), failed)
    for name, fn in (("wavefront k=1 == megakernel (tp0 off), bit for bit",
                      selfcheck.wavefront_k1_equals_megakernel),
                     ("table in global memory == in shared memory, bit for bit",
                      selfcheck.global_table_matches_shared),
                     ("wide BVH kernel == skip-link kernel, bit for bit",
                      selfcheck.wide_equals_skip_walk)):
        eq = fn(tables, SMOKE_SIZE, SMOKE_SIZE)
        log(f"[check] {name}: {eq}")
        if not all(eq.values()):
            failed.append(name)
    for scan in ("tp", "fast"):
        r = selfcheck.matches_parity(tables, scan)
        log(f"[check] kernel {scan} vs parity (JAX contract, 64x32 b6 2spp): {r}")
        if not r["ok"]:
            failed.append(f"{scan} vs parity")
    for kernel, r in selfcheck.bvh_matches_linear(tables, SMOKE_SIZE, SMOKE_SIZE).items():
        report(f"{kernel} vs megakernel reading sphere_field()'s table from global memory, "
               f"fast, {SMOKE_SIZE}x{SMOKE_SIZE} b4", r, failed)
    for name, r in selfcheck.grad_checks(tables, SMOKE_SIZE, SMOKE_SIZE, bounces=4).items():
        log(f"[check] grad_megakernel {SMOKE_SIZE}x{SMOKE_SIZE} b4 2spp, {name}: {r}")
        if not r["ok"]:
            failed.append(f"grad_megakernel {name}")
    r = selfcheck.hybrid_forward_check(tables, TRAIN_SIZE, TRAIN_SIZE, bounces=4,
                                       n_samples=TRAIN_SPP)
    log(f"[check] hybrid make_fast_renderer forward, Cornell {TRAIN_SIZE}x{TRAIN_SIZE} b4 "
        f"{TRAIN_SPP}spp, vs the megakernel's plain version on its card-packed table: {r}")
    if not r["ok"]:
        failed.append("hybrid forward")
    require(not failed, f"kernel checks failed: {failed}")


def counters():
    from oclpathtracer_tpu_torch.kernels import (
        bvh_megakernel,
        grad_megakernel,
        megakernel,
        wavefront,
        wide_bvh,
    )

    return {"megakernel": megakernel, "wavefront": wavefront, "bvh_megakernel": bvh_megakernel,
            "wide_bvh": wide_bvh, "grad_megakernel": grad_megakernel}


def check_image(name, img):
    a = img.cpu().numpy()
    require(a.shape == (512 * 512, 3), f"{name}: shape {a.shape}")
    require(bool(np.isfinite(a).all() and (a >= 0).all()), f"{name}: non-finite or < 0")
    log(f"[main] {name} image mean {a.mean():.6f} max {a.max():.6f}")
    return a


def phase_main_path(tables):
    import torch

    from oclpathtracer_tpu_torch import cli
    from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from oclpathtracer_tpu_torch.kernels import megakernel
    from oclpathtracer_tpu_torch.kernels.selfcheck import PROCGEN_EYE
    from oclpathtracer_tpu_torch.render.driver import render_progressive

    mods = counters()
    for m in mods.values():
        m.LAUNCHES = 0
    cornell = tables.scene("cornell")
    b16 = RenderConfig(512, 512, bounces=16)
    reference = read_png_rgb8(ARTIFACT)
    images = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        img = fn()
        torch.cuda.synchronize()
        log(f"[main] {name}: {time.perf_counter() - t0:.2f} s")
        images[name] = check_image(name, img)

    timed(f"Cornell 512x512 b16 {MAIN_SPP}spp auto (wavefront)",
          lambda: render_progressive(cornell, b16, total_spp=MAIN_SPP,
                                     samples_per_step=MAIN_STEP, backend="auto"))
    timed(f"Cornell 512x512 b16 {MAIN_SPP}spp widebvh",
          lambda: render_progressive(cornell, b16, total_spp=MAIN_SPP,
                                     samples_per_step=MAIN_STEP, backend="widebvh"))
    timed("Cornell render_pallas 512x512 b4 64spp",
          lambda: megakernel.render_pallas(cornell, RenderConfig(512, 512, bounces=4),
                                           MAIN_STEP))
    procgen_cfg = b16.with_(camera=CameraConfig(eye=PROCGEN_EYE))
    for label, scene in (("sphere_field() 5124 tris", tables.scene("spheres5k")),
                         ("sphere_field(80, 3) 102404 tris", tables.scene("spheres102k"))):
        before = mods["wide_bvh"].LAUNCHES
        timed(f"{label} 512x512 b16 {BVH_MAIN_SPP}spp auto",
              lambda: render_progressive(scene, procgen_cfg, total_spp=BVH_MAIN_SPP,
                                         samples_per_step=MAIN_STEP, backend="auto"))
        require(mods["wide_bvh"].LAUNCHES > before, f"{label}: auto did not launch wide_bvh")
    with tempfile.TemporaryDirectory() as tmp:
        for argv in ([], ["--integrator", "widebvh"], ["--integrator", "bvh"]):
            png = os.path.join(tmp, "cli.png")
            rc = cli.main(["render", "--spp", "16", "--bounces", "16", *argv, "-o", png])
            require(rc == 0 and os.path.getsize(png) > 0, f"CLI render {argv} failed (rc {rc})")
            os.remove(png)
    launches = {name: m.LAUNCHES for name, m in mods.items()}
    log(f"[main] launches {launches}")
    require(all(launches[n] > 0 for n in RENDER_KERNELS), f"a kernel was not launched: {launches}")
    for name in (f"Cornell 512x512 b16 {MAIN_SPP}spp auto (wavefront)",
                 f"Cornell 512x512 b16 {MAIN_SPP}spp widebvh"):
        rel = downsampled_rel_l2(images[name], reference)
        log(f"[main] {name} vs {os.path.relpath(ARTIFACT, ROOT)}: "
            f"{DOWNSAMPLE}x{DOWNSAMPLE}-box rel-L2 {rel:.6f} (limit {REL_L2_MAX})")
        require(rel < REL_L2_MAX, f"{name}: rel-L2 {rel} >= {REL_L2_MAX}")
    return launches


def class_albedo_error(params, true) -> float:
    return float((params.albedo - true.albedo).abs().mean())


def perturbed_class_params(true):
    """examples/train_kernel.py's start: class albedo + 0.25 (clipped), emissive true."""
    import torch

    from oclpathtracer_tpu_torch.diff.fast import ClassParams

    return ClassParams(albedo=torch.clamp(true.albedo + 0.25, 0.0, 1.0),
                       emissive=true.emissive.clone())


def phase_train(tables):
    """The training path, driven through the diff/ entry points on the Cornell box."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast, inverse
    from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk
    from oclpathtracer_tpu_torch.kernels import megakernel
    from oclpathtracer_tpu_torch.render.driver import render_progressive

    cornell = tables.scene("cornell")
    jnp_cfg = RenderConfig(RECOVERY_SIZE, RECOVERY_SIZE, bounces=4)
    jnp_ref = megakernel.render_pallas(cornell, jnp_cfg, 16)  # a comparison: not counted
    mods = counters()
    for m in mods.values():
        m.LAUNCHES = 0
    table, ct, n_classes, _ = gk.prepare_grad_scene(cornell)
    true = fast.extract_class_params(cornell)

    def target_for(cfg):
        img, _ = gk.render_grads_pallas(table, ct, cfg, TARGET_START, TARGET_SPP, n_classes,
                                        with_grads=False)
        return img / TARGET_SPP

    # examples/train_kernel.py: recover the class albedos with the adjoint kernel.
    cfg = RenderConfig(RECOVERY_SIZE, RECOVERY_SIZE, bounces=4)
    target = target_for(cfg)
    params = perturbed_class_params(true)
    err0 = class_albedo_error(params, true)
    step = fast.make_kernel_train_step(cornell, cfg, TRAIN_SPP, lr=3e-2)
    losses, per_step = [], set()
    t0 = time.perf_counter()
    for i in range(RECOVERY_STEPS):
        before = gk.LAUNCHES
        params, loss = step(params, target, i)
        per_step.add(gk.LAUNCHES - before)
        losses.append(loss)
    losses = torch.stack(losses).cpu().numpy()
    err1 = class_albedo_error(params, true)
    log(f"[train] recovery {RECOVERY_SIZE}x{RECOVERY_SIZE} b4 {TRAIN_SPP}spp {RECOVERY_STEPS} "
        f"steps lr 3e-2: {time.perf_counter() - t0:.2f} s, loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, class-albedo error: {err0:.4f} -> {err1:.4f}, "
        f"emissive error {float((params.emissive - true.emissive).abs().mean()):.4f}")
    require(per_step == {4}, f"grad_megakernel launches per kernel step: {per_step}, not 4")
    require(bool(np.isfinite(losses).all()), "recovery run: a loss is not finite")
    require(err1 < err0, f"recovery run: class-albedo error did not fall ({err0} -> {err1})")

    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=4)
    target = target_for(cfg)
    ostep, opt_init = fast.make_kernel_optax_step(
        cornell, cfg, TRAIN_SPP, functools.partial(torch.optim.Adam, lr=5e-2))
    params = perturbed_class_params(true)
    state = opt_init(params)
    losses = []
    for _ in range(10):  # on fixed frames, as tests/test_grad_kernel.py steps
        params, state, loss = ostep(params, state, target, 0)
        losses.append(float(loss))
    log(f"[train] make_kernel_optax_step Adam 5e-2 {TRAIN_SIZE}x{TRAIN_SIZE} b4 {TRAIN_SPP}spp, "
        f"10 steps on frames 0-{2 * TRAIN_SPP - 1}: losses {[round(x, 6) for x in losses]}, "
        f"class-albedo error {class_albedo_error(params, true):.4f}")
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"kernel optax step: the loss did not drop: {losses}")

    # The hybrid's forwards are the parity megakernel, 2 a step; its backward and the
    # twin launch no kernel. Nothing else in this phase launches the megakernel.
    for name, run, mk_per_step in (("hybrid make_fast_loss_fn", hybrid_step(cornell, cfg), 2),
                                   ("twin make_train_step", twin_step(cornell, cfg), 0)):
        params = inverse.extract_params(cornell, albedo=True, emissive=True)
        losses, per_step = [], set()
        for i in range(3):
            before = megakernel.LAUNCHES
            params, loss = run(params, target, i)
            per_step.add(megakernel.LAUNCHES - before)
            losses.append(float(loss))
        log(f"[train] {name} {TRAIN_SIZE}x{TRAIN_SIZE} b4 {TRAIN_SPP}spp, 3 steps: "
            f"losses {[round(x, 6) for x in losses]}, megakernel launches a step {per_step}")
        require(per_step == {mk_per_step},
                f"{name}: megakernel launches a step {per_step}, not {mk_per_step}")
        require(bool(np.isfinite(losses).all())
                and all(bool(torch.isfinite(x).all()) for x in inverse.params_leaves(params)),
                f"{name}: a loss or a parameter is not finite")

    img = render_progressive(cornell, jnp_cfg, 16, samples_per_step=16)  # backend="jnp"
    a = img.cpu().numpy()
    rel = abs(float(a.mean()) / float(jnp_ref.mean()) - 1.0)
    log(f"[train] render_progressive(backend='jnp') {RECOVERY_SIZE}x{RECOVERY_SIZE} b4 16spp: "
        f"mean {a.mean():.6f} vs megakernel {float(jnp_ref.mean()):.6f} (rel {rel:.4f})")
    require(a.shape == (jnp_cfg.n_pixels, 3) and bool(np.isfinite(a).all() and (a >= 0).all()),
            "render_progressive(backend='jnp'): shape, or non-finite or < 0 values")
    require(rel < JNP_MEAN_REL_MAX, f"jnp render mean off the megakernel's by {rel}")

    launches = {name: m.LAUNCHES for name, m in mods.items()}
    log(f"[train] launches {launches}")
    require(launches["grad_megakernel"] > 0 and launches["megakernel"] == 2 * 3,
            f"the training path did not launch its kernels as counted: {launches}")
    return launches


def hybrid_step(scene, cfg, lr=1e-3):
    """bench_train.py's hybrid step: value_and_grad of make_fast_loss_fn, plain SGD."""
    from oclpathtracer_tpu_torch.diff import fast, inverse

    loss_fn = fast.make_fast_loss_fn(scene, cfg, TRAIN_SPP)

    def step(params, target, i):
        loss, g = inverse.value_and_grad(loss_fn, params, target, i)
        return inverse.params_from_leaves(params, [
            p - lr * d for p, d in zip(inverse.params_leaves(params), inverse.params_leaves(g))
        ]), loss

    return step


def twin_step(scene, cfg, lr=1e-3):
    """bench_train.py's jnp step: make_train_step on threefry key 0."""
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.diff import inverse

    step = inverse.make_train_step(scene, cfg, TRAIN_SPP, lr=lr)
    key = rng.make_key(0, scene.geometry.p1.device)
    return lambda params, target, i: step(params, target, i, key)


def time_pair(label, kern, plain, n_kernel, n_plain, rows, failed, **info):
    """Time kern(n_kernel) (warm-up, median of 5) and plain(n_plain) (one run), and
    hold kern(n_plain) against plain(n_plain) by phase 3's rule."""
    from oclpathtracer_tpu_torch.kernels import selfcheck

    ms, (img_k, segs) = cuda_time_ms(lambda: kern(n_kernel), lambda: kern(n_kernel))
    plain_ms, (img_p, segs_p) = cuda_time_ms(lambda: plain(n_plain), lambda: None, reps=1)
    segs_k = segs
    if n_plain != n_kernel:
        img_k, segs_k = kern(n_plain)
    r = selfcheck.compare(img_k, segs_k, img_p, segs_p)
    row = {"name": label, **info, "spp": n_kernel, "ms": ms, "segments": int(segs),
           "mrays": int(segs) / (ms * 1e3), "plain_spp": n_plain, "plain_ms": plain_ms,
           "plain_mrays": int(segs_p) / (plain_ms * 1e3),
           "pixel_fraction": r["pixel_fraction"], "max_abs_err": r["max_abs_err"],
           "bitwise": r["bitwise"]}
    rows.append(row)
    log(f"[time] {label}: kernel {ms:.3f} ms at {n_kernel}spp ({row['mrays']:.1f} Mrays/s, "
        f"{int(segs)} segments), plain {plain_ms:.1f} ms at {n_plain}spp "
        f"({row['plain_mrays']:.3f} Mrays/s); kernel vs plain at {n_plain}spp: pixels "
        f"{r['pixel_fraction']:.6f} max|diff| {r['max_abs_err']:.3g} segments "
        f"{r['segments_kernel']} vs {r['segments_plain']} bitwise {r['bitwise']} "
        f"{'ok' if r['ok'] else 'FAIL'}")
    if not r["ok"]:
        failed.append(label)
    return row


def phase_timing(tables):
    """Time each kernel and its plain version at the main path's launch shape, and
    hold the two results against each other."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import megakernel as mk
    from oclpathtracer_tpu_torch.kernels.selfcheck import Case, run

    rows, failed = [], []
    for kernel, scan, bounces in (("megakernel", "parity", 4), ("megakernel", "tp", 4),
                                  ("megakernel", "fast", 4), ("wavefront", "tp", 16),
                                  ("wavefront", "fast", 16)):
        cfg = RenderConfig(512, 512, bounces=bounces)
        table, emi, classes = tables.linear("cornell", scan)
        if kernel == "megakernel":  # with the render's tp0 table, as a render step runs it
            tp0_table = mk.tp0_table_for(table, cfg, scan)
            kw = dict(scan=scan, classes=classes, emi_const=emi, tp0_table=tp0_table)

            def kern(n, kw=kw, cfg=cfg, table=table):
                return mk.render_samples_pallas_stats(table, cfg, TIME_START, n, **kw)

            def plain(n, kw=kw, cfg=cfg, table=table):
                return mk._render_samples_stats_plain(table, cfg, TIME_START, n, **kw)
        else:
            case = Case(kernel, scan, 512, 512, bounces)

            def kern(n, c=case):
                return run(c, tables, start=TIME_START, n=n)

            def plain(n, c=case):
                return run(c, tables, plain=True, start=TIME_START, n=n)
        time_pair(f"{kernel} {scan} Cornell 512x512 b{bounces}", kern, plain, MAIN_STEP,
                  MAIN_STEP, rows, failed, kernel=kernel, scan=scan, bounces=bounces,
                  scene="cornell")
    for scene, leaf in (("spheres5k", 32), ("spheres102k", 64)):
        for kernel in ("bvh", "widebvh"):
            case = Case(kernel, "fast", 512, 512, 16, scene=scene, leaf=leaf)
            time_pair(f"{kernel} fast leaf {leaf} {scene} 512x512 b16",
                      lambda n, c=case: run(c, tables, start=TIME_START, n=n),
                      lambda n, c=case: run(c, tables, plain=True, start=TIME_START, n=n),
                      MAIN_STEP, 1, rows, failed, kernel=kernel, scan="fast", bounces=16,
                      scene=scene)
    require(not failed, f"kernel vs plain at the main path's shapes failed: {failed}")
    return rows


def phase_grad_timing(tables):
    """The adjoint kernel, forward only and with gradients, against its plain version
    at bench_train.py's shape (256², 4 bounces, 8 spp), held by grad_checks' rule."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import selfcheck

    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=4)
    ct = selfcheck.grad_points(tables)["interior"]
    rows, failed = {}, []
    for mode, w in (("forward", None), ("adjoint", selfcheck.grad_weight(cfg.n_pixels, "cuda"))):
        def kern(w=w):
            return selfcheck.run_grad(tables, cfg, ct, w, start=0, n=TRAIN_SPP)

        def plain(w=w):
            return selfcheck.run_grad(tables, cfg, ct, w, plain=True, start=0, n=TRAIN_SPP)

        ms, got = cuda_time_ms(kern, kern, calls=GRAD_TIME_CALLS)
        plain_ms, want = cuda_time_ms(plain, lambda: None, reps=1)
        r = selfcheck.compare_grads(got, want)
        segs = r["segments"]
        rows[mode] = {"ms": ms, "plain_ms": plain_ms, "segments": segs,
                      "mrays": segs / (ms * 1e3), "plain_mrays": segs / (plain_ms * 1e3), **r}
        log(f"[time] grad_megakernel {mode} Cornell {TRAIN_SIZE}x{TRAIN_SIZE} b4 {TRAIN_SPP}spp: "
            f"kernel {ms:.3f} ms ({rows[mode]['mrays']:.1f} Mrays/s, {segs} segments), plain "
            f"{plain_ms:.1f} ms ({rows[mode]['plain_mrays']:.3f} Mrays/s); {r}")
        if not r["ok"]:
            failed.append(mode)
    require(not failed, f"grad kernel vs plain at {TRAIN_SIZE}x{TRAIN_SIZE} failed: {failed}")
    return rows


def profile_device_ms(fn, top: int = 3):
    """Device time of one fn() under torch.profiler: (the sum of the kernels' time
    in ms, the `top` kernels by that time as (name, ms, calls)). Only the kernels'
    own entries count: the host ops that launched them carry the same time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in events) / 1e3
    return total, [(e.key[:48], round(e.self_device_time_total / 1e3, 3), e.count)
                   for e in events[:top]]


def phase_train_timing(tables):
    """ms per train step and Mrays/s (bench_train.py's count) of the kernel, hybrid
    and twin steps at 256², 4 bounces, 8 spp, target zeros; then one more step of
    each under torch.profiler for its device time and busy share."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast, inverse
    from oclpathtracer_tpu_torch.kernels import megakernel as mk

    cornell = tables.scene("cornell")
    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=4)
    scan, table, emi, classes = mk.prepare_scan(cornell, "auto")
    _, segs = mk.render_samples_pallas_stats(table, cfg, 0, TRAIN_SPP, scan=scan, classes=classes,
                                             emi_const=emi)
    segs = int(segs)
    target = torch.zeros((cfg.n_pixels, 3), device="cuda")
    kstep = fast.make_kernel_train_step(cornell, cfg, TRAIN_SPP, lr=1e-3)
    variants = (("kernel", kstep, fast.extract_class_params(cornell), 4, 7),
                ("hybrid", hybrid_step(cornell, cfg),
                 inverse.extract_params(cornell, albedo=True, emissive=True), 4, 3),
                ("twin", twin_step(cornell, cfg),
                 inverse.extract_params(cornell, albedo=True, emissive=True), 2, 3))
    rows = {}
    for name, step, params, sweeps, reps in variants:
        params, loss = step(params, target, 0)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            params, loss = step(params, target, 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        device_ms, top = profile_device_ms(lambda: step(params, target, 0))
        rows[name] = {"ms_per_step": ms, "mrays": sweeps * segs / (ms * 1e3),
                      "segments_per_window": segs, "sweeps": sweeps, "loss": float(loss),
                      "reps": reps, "device_ms": device_ms, "device_busy": device_ms / ms,
                      "top_device_ops": top}
        log(f"[time] train step {name} Cornell {TRAIN_SIZE}x{TRAIN_SIZE} b4 {TRAIN_SPP}spp: "
            f"{ms:.3f} ms/step (median of {reps}), {rows[name]['mrays']:.1f} Mrays/s "
            f"({sweeps} x {segs} segments), loss {float(loss):.6f}; profiled step: device "
            f"{device_ms:.3f} ms, busy share {device_ms / ms:.4f}, top {top}")
    return rows


def phase_crossover(tables):
    """Linear megakernel vs 8-wide BVH kernel (leaf 32), fast scan, 256², 4 bounces,
    64 spp per launch, on sphere_field(n, 2): Mrays/s of each and their ratio."""
    from oclpathtracer_tpu_torch.kernels.selfcheck import Case, run

    rows = []
    for n in CROSSOVER_SPHERES:
        name = f"spheres{n}x2"
        times = {}
        for kernel in ("megakernel", "widebvh"):
            case = Case(kernel, "fast", CROSSOVER_SIZE, CROSSOVER_SIZE, 4, tp0=False,
                        scene=name, leaf=32)
            ms, (_, segs) = cuda_time_ms(lambda c=case: run(c, tables, start=0, n=MAIN_STEP),
                                         lambda c=case: run(c, tables, start=0, n=MAIN_STEP))
            times[kernel] = (ms, int(segs) / (ms * 1e3))
        n_tris = int(tables.scene(name).num_triangles)
        rows.append({"n_spheres": n, "n_tris": n_tris, "linear_ms": times["megakernel"][0],
                     "linear_mrays": times["megakernel"][1], "widebvh_ms": times["widebvh"][0],
                     "widebvh_mrays": times["widebvh"][1],
                     "widebvh_over_linear": times["widebvh"][1] / times["megakernel"][1]})
        log(f"[crossover] {n_tris} tris: linear fast {times['megakernel'][0]:.3f} ms "
            f"({times['megakernel'][1]:.1f} Mrays/s), widebvh fast {times['widebvh'][0]:.3f} ms "
            f"({times['widebvh'][1]:.1f} Mrays/s), widebvh/linear "
            f"{rows[-1]['widebvh_over_linear']:.3f}")
    return rows


def main() -> int:
    import torch

    card = phase_device()
    t0 = time.perf_counter()
    phase_build()
    from oclpathtracer_tpu_torch.kernels import selfcheck
    from oclpathtracer_tpu_torch.scene.procgen import sphere_field

    tables = selfcheck.Tables("cuda", {f"spheres{n}x2": functools.partial(sphere_field, n, 2)
                                       for n in CROSSOVER_SPHERES})
    phase_checks(tables)
    log(f"[done] checks at {time.perf_counter() - t0:.1f} s")
    launches = phase_main_path(tables)
    log(f"[done] main path at {time.perf_counter() - t0:.1f} s")
    train_launches = phase_train(tables)
    log(f"[done] training path at {time.perf_counter() - t0:.1f} s")
    rows = phase_timing(tables)
    grad_rows = phase_grad_timing(tables)
    train_rows = phase_train_timing(tables)
    crossover = phase_crossover(tables)
    by_name = {r["name"]: r for r in rows}
    # What the main path runs: the tp megakernel at 4 bounces, the tp wavefront at 16,
    # and sphere_field()'s fast BVH kernels.
    main_rows = {"megakernel": by_name["megakernel tp Cornell 512x512 b4"],
                 "wavefront": by_name["wavefront tp Cornell 512x512 b16"],
                 "bvh_megakernel": by_name["bvh fast leaf 32 spheres5k 512x512 b16"],
                 "wide_bvh": by_name["widebvh fast leaf 32 spheres5k 512x512 b16"]}
    sources = {"megakernel": ("megakernel.cu", "oclpathtracer_tpu/kernels/megakernel.py:1052"),
               "wavefront": ("wavefront.cu", "oclpathtracer_tpu/kernels/wavefront.py:489"),
               "bvh_megakernel": ("bvh_megakernel.cu",
                                  "oclpathtracer_tpu/kernels/bvh_megakernel.py:746"),
               "wide_bvh": ("wide_bvh.cu", "oclpathtracer_tpu/kernels/wide_bvh.py:335")}
    # Each path is counted in its own window (counts set to 0 just before it):
    # `launches` sums the render path's and the training path's counts.
    kernels = [{"name": name, "route": "cuda",
                "source": f"oclpathtracer_tpu_torch/kernels/csrc/{src}", "replaces": tpu,
                "launches": launches[name] + train_launches[name],
                "launches_by_path": {"render": launches[name], "train": train_launches[name]},
                "max_abs_err": main_rows[name]["max_abs_err"],
                "ms": main_rows[name]["ms"], "plain_ms": main_rows[name]["plain_ms"],
                "spp": main_rows[name]["spp"], "plain_spp": main_rows[name]["plain_spp"]}
               for name, (src, tpu) in sources.items()]
    adj, fwd = grad_rows["adjoint"], grad_rows["forward"]
    kernels.append({"name": "grad_megakernel", "route": "cuda",
                    "source": "oclpathtracer_tpu_torch/kernels/csrc/grad_megakernel.cu",
                    "replaces": "oclpathtracer_tpu/kernels/grad_megakernel.py:455",
                    "launches": launches["grad_megakernel"] + train_launches["grad_megakernel"],
                    "launches_by_path": {"render": launches["grad_megakernel"],
                                         "train": train_launches["grad_megakernel"]},
                    "max_abs_err": max(adj["max_abs_err"], adj["grad_max_abs_err"]),
                    "ms": adj["ms"], "plain_ms": adj["plain_ms"], "spp": TRAIN_SPP,
                    "plain_spp": TRAIN_SPP, "forward_ms": fwd["ms"],
                    "forward_plain_ms": fwd["plain_ms"]})
    log(f"[done] {card}; all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"timing": rows, "grad_timing": grad_rows, "train_timing": train_rows,
                      "crossover": crossover}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
