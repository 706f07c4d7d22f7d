#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`oclpathtracer_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi);
  2. build: compile the CUDA kernels from kernels/csrc with nvcc;
  3. kernel vs plain PyTorch version on the card (kernels/selfcheck.py), wavefront
     k=1 vs megakernel bit for bit, and tp vs parity under the JAX contract;
  4. main path: render_progressive(backend="auto") at 512², 16 bounces and
     16384 spp (wavefront kernel), render_pallas at 512², 4 bounces (megakernel),
     and the CLI `render` command; the kernels' launch counters must go up, the
     images must be finite and ≥ 0, and the 16-bounce image must match the
     checked-in render of the same 16384 reference-stream samples
     (artifacts/cornell_512_16b_16384spp_tpu.png) to a downsampled rel-L2 < 1e-3.
     (At 256 spp sample noise alone gives 0.056 against it, at 1024 spp 0.017:
     measured on an H100, so the check renders all 16384 samples; with the same
     streams it reads about 2e-5, quantisation to 8 bits.);
  5. timing with CUDA events (warm-up, median of 5) of each kernel and its plain
     version at the main path's launch shape (512², 64 samples per launch), as
     Mrays/s = traced segments per second; the two results of each pair are held
     against each other by phase 3's rule.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels as JSON.
"""

from __future__ import annotations

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
TIME_START = 64   # the main path's second launch
DOWNSAMPLE = 16
SMOKE_SIZE = 128


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


def phase_checks(scene):
    from oclpathtracer_tpu_torch.kernels import selfcheck

    tbls = selfcheck.tables(scene, "cuda")
    failed = []
    for case in selfcheck.cases(SMOKE_SIZE, SMOKE_SIZE):
        r = selfcheck.check_case(case, tbls)
        log(f"[check] {case.name} {selfcheck.N_SAMPLES}spp: pixels "
            f"{r['pixel_fraction']:.6f} max|diff| {r['max_abs_err']:.3g} segments "
            f"{r['segments_kernel']} vs {r['segments_plain']} bitwise {r['bitwise']} "
            f"{'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failed.append(case.name)
    eq = selfcheck.wavefront_k1_equals_megakernel(tbls, SMOKE_SIZE, SMOKE_SIZE)
    log(f"[check] wavefront k=1 == megakernel (tp0 off), bit for bit: {eq}")
    if not all(eq.values()):
        failed.append("wavefront k=1 bitwise")
    tp = selfcheck.tp_matches_parity(tbls)
    log(f"[check] kernel tp vs parity (JAX contract, 64x32 b6 2spp): {tp}")
    if not tp["ok"]:
        failed.append("tp vs parity")
    require(not failed, f"kernel checks failed: {failed}")


def phase_main_path(scene_cpu):
    import torch

    from oclpathtracer_tpu_torch import cli
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import megakernel, wavefront
    from oclpathtracer_tpu_torch.render.driver import render_progressive

    scene = scene_cpu.to("cuda")
    megakernel.LAUNCHES = 0
    wavefront.LAUNCHES = 0
    t0 = time.perf_counter()
    img16 = render_progressive(scene, RenderConfig(512, 512, bounces=16),
                               total_spp=MAIN_SPP, samples_per_step=MAIN_STEP,
                               backend="auto")
    torch.cuda.synchronize()
    t_prog = time.perf_counter() - t0
    t0 = time.perf_counter()
    img4 = megakernel.render_pallas(scene, RenderConfig(512, 512, bounces=4), MAIN_STEP)
    torch.cuda.synchronize()
    t_pallas = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "cli.png")
        rc = cli.main(["render", "--spp", "16", "--bounces", "16", "-o", png])
        require(rc == 0 and os.path.getsize(png) > 0, f"CLI render failed (rc {rc})")
    launches = {"megakernel": megakernel.LAUNCHES, "wavefront": wavefront.LAUNCHES}
    log(f"[main] render_progressive 512x512 b16 {MAIN_SPP}spp auto: {t_prog:.2f} s; "
        f"render_pallas 512x512 b4 64spp: {t_pallas:.2f} s; launches {launches}")
    require(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    for name, img in (("b16", img16), ("b4", img4)):
        a = img.cpu().numpy()
        require(a.shape == (512 * 512, 3), f"{name}: shape {a.shape}")
        require(bool(np.isfinite(a).all() and (a >= 0).all()), f"{name}: non-finite or < 0")
        log(f"[main] {name} image mean {a.mean():.6f} max {a.max():.6f}")
    rel = downsampled_rel_l2(img16.cpu().numpy(), read_png_rgb8(ARTIFACT))
    log(f"[main] 16-bounce {MAIN_SPP}spp vs {os.path.relpath(ARTIFACT, ROOT)}: "
        f"{DOWNSAMPLE}x{DOWNSAMPLE}-box rel-L2 {rel:.6f} (limit {REL_L2_MAX})")
    require(rel < REL_L2_MAX, f"rel-L2 {rel} >= {REL_L2_MAX}")
    return launches


def launchers(name, scan, cfg, table, classes):
    """(kernel, plain version) of one main-path launch: samples TIME_START onwards, as
    a render step launches them (the megakernel with the render's tp0 table)."""
    from oclpathtracer_tpu_torch.kernels import megakernel as mk
    from oclpathtracer_tpu_torch.kernels import wavefront as wf

    if name == "megakernel":
        tp0_table = mk.tp0_table_for(table, cfg, scan)

        def kern(n=MAIN_STEP):
            return mk.render_samples_pallas_stats(table, cfg, TIME_START, n, scan=scan,
                                                  classes=classes, tp0_table=tp0_table)

        def plain(n=MAIN_STEP):
            return mk._render_samples_stats_plain(table, cfg, TIME_START, n, 0, cfg.n_pixels,
                                                  scan, classes, True, tp0_table)
    else:
        def kern(n=MAIN_STEP):
            return wf.render_samples_wavefront_stats(table, cfg, TIME_START, n, scan=scan,
                                                     classes=classes)

        def plain(n=MAIN_STEP):
            return wf._render_samples_wavefront_plain(table, cfg, TIME_START, n, 1, scan,
                                                      classes, 0, cfg.n_pixels)
    return kern, plain


def phase_timing(scene):
    """Time each kernel and its plain version at the main path's launch shape
    (512², 64 samples per launch), and hold the two results against each other."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import selfcheck

    tbls = selfcheck.tables(scene, "cuda")
    rows, failed = [], []
    for name, scan, bounces in (("megakernel", "parity", 4), ("megakernel", "tp", 4),
                                ("wavefront", "tp", 16)):
        cfg = RenderConfig(512, 512, bounces=bounces)
        kern, plain = launchers(name, scan, cfg, *tbls[scan])
        ms, (img_k, segs_k) = cuda_time_ms(kern, kern)
        plain_ms, (img_p, segs_p) = cuda_time_ms(plain, lambda: plain(1))
        r = selfcheck.compare(img_k, segs_k, img_p, segs_p)
        segs, plain_segs = r["segments_kernel"], r["segments_plain"]
        rows.append({"name": name, "scan": scan, "bounces": bounces, "spp": MAIN_STEP,
                     "ms": ms, "plain_ms": plain_ms, "segments": segs,
                     "mrays": segs / (ms * 1e3), "plain_mrays": plain_segs / (plain_ms * 1e3),
                     "pixel_fraction": r["pixel_fraction"], "max_abs_err": r["max_abs_err"],
                     "bitwise": r["bitwise"]})
        log(f"[time] {name} {scan} 512x512 b{bounces} {MAIN_STEP}spp: kernel {ms:.3f} ms "
            f"({segs / (ms * 1e3):.1f} Mrays/s), plain {plain_ms:.1f} ms "
            f"({plain_segs / (plain_ms * 1e3):.2f} Mrays/s), segments {segs}")
        log(f"[time] {name} {scan} 512x512 b{bounces} {MAIN_STEP}spp kernel vs plain: "
            f"pixels {r['pixel_fraction']:.6f} max|diff| {r['max_abs_err']:.3g} "
            f"segments {segs} vs {plain_segs} bitwise {r['bitwise']} "
            f"{'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failed.append(f"{name} {scan} b{bounces}")
    require(not failed, f"kernel vs plain at the main path's shapes failed: {failed}")
    return rows


def main() -> int:
    import torch

    card = phase_device()
    t0 = time.perf_counter()
    phase_build()
    from oclpathtracer_tpu_torch.scene import load_cornell_box

    scene = load_cornell_box()
    phase_checks(scene)
    launches = phase_main_path(scene)
    rows = phase_timing(scene)
    main_row = {"megakernel": rows[1], "wavefront": rows[2]}  # what the main path runs
    kernels = [
        {"name": "megakernel", "route": "cuda",
         "source": "oclpathtracer_tpu_torch/kernels/csrc/megakernel.cu",
         "replaces": "oclpathtracer_tpu/kernels/megakernel.py:1052",
         "launches": launches["megakernel"],
         "max_abs_err": main_row["megakernel"]["max_abs_err"],
         "ms": main_row["megakernel"]["ms"], "plain_ms": main_row["megakernel"]["plain_ms"]},
        {"name": "wavefront", "route": "cuda",
         "source": "oclpathtracer_tpu_torch/kernels/csrc/wavefront.cu",
         "replaces": "oclpathtracer_tpu/kernels/wavefront.py:489",
         "launches": launches["wavefront"],
         "max_abs_err": main_row["wavefront"]["max_abs_err"],
         "ms": main_row["wavefront"]["ms"], "plain_ms": main_row["wavefront"]["plain_ms"]},
    ]
    log(f"[done] {card}; all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"timing": rows}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
