#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`oclpathtracer_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from kernels/csrc with nvcc, one process per
     source, all at once;
  3. kernel vs plain PyTorch version on the card (kernels/selfcheck.py): the
     linear kernels on the Cornell box in parity, fast and tp form, wavefront k=1
     vs megakernel bit for bit, fast and tp vs parity under the JAX contract, a
     table past shared memory (read from global memory) bit for bit as in shared
     memory; the skip-link and 8-wide BVH kernels in each leaf form on
     sphere_field(3, 1), sphere_field() and the Cornell box, wide vs skip-link bit
     for bit, and both against the linear kernel reading sphere_field()'s table
     from global memory (an independent brute-force search);
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
  5. timing with CUDA events (warm-up, median of 5 for kernels; one run for plain
     versions) of each kernel and its plain version at the main path's launch
     shape (512², 64 samples per launch; the BVH kernels' plain versions at 1
     sample, against the kernel at 1 sample), as Mrays/s = traced segments per
     second; the two results of each pair are held against each other by phase
     3's rule. Then the linear-vs-BVH crossover: the megakernel against the 8-wide
     BVH kernel, fast scan, on sphere_field(n, 2) for n = 1..16 at 256², 4 bounces.

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


def cuda_time_ms(fn, warmup, reps: int = 5):
    """Median ms of `fn()` over `reps` runs (CUDA events), after one `warmup()`;
    returns (ms, the last result)."""
    import torch

    warmup()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
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
    require(not failed, f"kernel checks failed: {failed}")


def counters():
    from oclpathtracer_tpu_torch.kernels import bvh_megakernel, megakernel, wavefront, wide_bvh

    return {"megakernel": megakernel, "wavefront": wavefront, "bvh_megakernel": bvh_megakernel,
            "wide_bvh": wide_bvh}


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
    require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    for name in (f"Cornell 512x512 b16 {MAIN_SPP}spp auto (wavefront)",
                 f"Cornell 512x512 b16 {MAIN_SPP}spp widebvh"):
        rel = downsampled_rel_l2(images[name], reference)
        log(f"[main] {name} vs {os.path.relpath(ARTIFACT, ROOT)}: "
            f"{DOWNSAMPLE}x{DOWNSAMPLE}-box rel-L2 {rel:.6f} (limit {REL_L2_MAX})")
        require(rel < REL_L2_MAX, f"{name}: rel-L2 {rel} >= {REL_L2_MAX}")
    return launches


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
    rows = phase_timing(tables)
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
    kernels = [{"name": name, "route": "cuda",
                "source": f"oclpathtracer_tpu_torch/kernels/csrc/{src}", "replaces": tpu,
                "launches": launches[name], "max_abs_err": main_rows[name]["max_abs_err"],
                "ms": main_rows[name]["ms"], "plain_ms": main_rows[name]["plain_ms"],
                "spp": main_rows[name]["spp"], "plain_spp": main_rows[name]["plain_spp"]}
               for name, (src, tpu) in sources.items()]
    log(f"[done] {card}; all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"timing": rows, "crossover": crossover}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
