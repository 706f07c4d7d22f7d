#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`oclpathtracer_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. device: require CUDA; print the card's name and power limit (nvidia-smi);
  2. build: compile the nine CUDA sources from kernels/csrc with nvcc, one process
     per source, all at once; print every kernel's ptxas lines (registers, stack,
     spills) and its SASS opcode counts (cuobjdump -sass: loads by memory space,
     FP32 arithmetic and compares, branches);
  3. kernel vs plain PyTorch version on the card (kernels/selfcheck.py): the
     linear kernels on the Cornell box in parity, fast and tp form, wavefront k=1
     vs megakernel bit for bit, fast and tp vs parity under the JAX contract, a
     table past shared memory (read from global memory) bit for bit as in shared
     memory (the megakernel at runs of 1, 2 and all 3 samples a lane); every
     megakernel case (parity, fast, tp with the tp0 peel on and off, 4 and 16
     bounces, a ragged image) at runs of 1, 2 and all samples a lane, and a ragged
     pixel range (pid_base 1000, 2,001 pixels; also the whole image's rows), bit for
     bit against the plain version
     (selfcheck.linear_runs_agree); the wavefront with runs of 1, 2 and all
     samples a lane, k = 1 and 3,
     scan table in shared memory (also padded past 48 KB) and, padded past 227 KB,
     in global memory, the same bits; the skip-link and
     8-wide BVH kernels in each leaf form on sphere_field(3, 1), sphere_field() and
     the Cornell box, wide vs skip-link bit for bit there and on
     selfcheck.deep_scene (a 14-level tree), the wide and skip-link kernels split
     into one-sample launches and the wide kernel with a 454-level stack (227 KB of
     shared memory) the same bits as one launch, and both BVH kernels against the
     linear
     kernel reading sphere_field()'s table from global memory (an independent
     brute-force search); the adjoint kernel
     (kernels/selfcheck.py grad_checks) at 128², 4 bounces, 2 spp: its forward bit
     for bit against its plain version and against the tp megakernel with tp0 off,
     the adjoint against its plain version (image and segments bit for bit, the
     (C, 6) gradients within 1e-4·max|g|) at the true, an interior and a
     clamp-binding point, two launches of the adjoint giving the same bits, the
     table read from global memory the same bits, and a ragged pixel range (pid_base
     1000, 2,001 pixels) against its plain version and the whole image's rows;
     the hybrid renderer's forward (diff/fast.make_fast_renderer) at 256², 4
     bounces, 8 spp: pack_scene on the card bit for bit as on the host, and the
     forward against the megakernel's plain version on that table; the
     arbitrary-ray kernel (trace_rays.cu, kernels/selfcheck.py trace_rays_checks)
     on 65,536 rows (half camera rays through diff/edge.rays_at, half from inside the
     box), rows from 7, samples from 2^20, 4 bounces, 4 spp: bit for bit against its
     plain version in parity, fast and tp at its default run and at runs of 1, 2 and
     all samples a lane, a rerun the same bits, and a table past shared memory the
     same bits at each run. Every linear and BVH kernel case must be bit for
     bit against its plain version (the device code they share with the newer
     kernels was factored into helpers; no bit of theirs may move). The AO and
     direct-NEE kernels (fast_integrators.cu, kernels/selfcheck.py
     fast_integrator_checks) on the Cornell box at 128², 4 spp: bit for bit against
     their plain versions on the whole image, on a ragged range (pid_base 1000,
     5,001 pixels; also the whole image's rows) and with the table in global memory;
     AO at 1, 2 and 32 lanes a pixel, the same bits; direct at 1, 2, 8 and 32 lanes
     a pixel and 3 and 5 spp, with the tables in shared and in global memory and (8
     lanes) on the ragged range, the plain version's bits.
     The sorted wavefront's bounce kernel (sorted_wavefront.cu, sorted_checks) on the
     Cornell box and sphere_field(), leaf 32, 4 bounces, 2 spp, sort off and on: bit
     for bit against its plain version and against the skip-link kernel; also on
     the Cornell box at 13x11, 3 spp (429 rays, no multiple of the block) and looking
     out of its open side (every ray dies in the first launch);
  4. main path, with every launch counter set to 0 first:
     render_progressive(backend="auto") at 512², 16 bounces on the Cornell box
     (16384 spp, wavefront kernel), on sphere_field() (5,124 tris) and on
     sphere_field(80, 3) (102,404 tris), both through the 8-wide BVH kernel, and
     deep_scene() (488 tris, a 14-level tree) through it too; the Cornell box
     through backend="widebvh" at 16384 spp; render_pallas at
     512², 4 bounces (megakernel); the CLI `render` with the megakernel, `widebvh`
     and `bvh`. Every kernel's launch counter must go up, the images must be finite
     and ≥ 0, and both 16384-spp Cornell images must match the checked-in render
     of the same reference-stream samples
     (artifacts/cornell_512_16b_16384spp_tpu.png) to a downsampled rel-L2 < 1e-3
     (at 256 spp sample noise alone gives 0.056 against it, at 1024 spp 0.017:
     measured on an H100, so the check renders all 16384 samples; with the same
     streams it reads about 2e-5, quantisation to 8 bits);
  4b. training path on the Cornell box, with every launch counter set to 0 first:
     the train_kernel example's recovery run (oclpathtracer_tpu_torch/examples/,
     after the root examples/train_kernel.py) through make_kernel_train_step (128²,
     4 bounces, 8 spp, 80 steps, lr 3e-2, target at the true classes from frame
     1,000,000 at 64 spp, albedo + 0.25): the class-albedo error must fall, the
     losses stay finite, and each step launch the adjoint kernel exactly 4 times;
     10 steps of make_kernel_optax_step (torch.optim.Adam, 5e-2) at 256², 4
     bounces, 8 spp, on fixed frames, whose loss must drop; 3 steps each of the hybrid
     (make_fast_loss_fn: megakernel forward, twin backward; exactly 2 megakernel
     launches a step) and of make_train_step (the twin, none) at that size, their
     backwards calling the material gathers' kernel, gather_grad.cu, once for each
     gather of the twin they reach (8 samples' 7 a render; the hybrid's backward
     renders twice), the
     megakernel's launches in this phase being those 6; render_progressive(backend="jnp")
     at 128², 4 bounces, 16 spp, whose mean must agree with the megakernel's
     render of as many samples within 5 % (other streams, same estimator);
  4c. vertex training on the Cornell box and the occluder scene (tests/test_diff.py),
     with every launch counter set to 0 first: the train_vertices example's
     recovery run through make_vertex_train_step (64², 2 bounces, 8 spp, 100 steps,
     the light moved +0.3 in x), once with the root example's Adam 1e-2 (reported: its
     error ends above where it started, in the JAX package's step too,
     tests/vertex_recovery_vs_jax.py) and once with SGD 2e-4,
     whose light-vertex error must fall below 0.6× the initial; each step must
     launch the megakernel exactly 2 times and trace_rays 4 times, and the losses
     stay finite; on the occluder, the edge-aware
     gradient (make_edge_aware_loss_fn, 32², 2 bounces, 64 spp, 256 samples per
     edge) of the 3 largest silhouette movers against central differences of the
     loss (eps 0.08, rtol 0.1), and the primary boundary term with kernel probes
     against twin probes (128 samples per edge, 8 spp, rtol 0.1), a smoke test
     there, and on the Cornell box, whose probe radiance depends on the draws (the
     3 largest entries of every vertex's term, with the twin's own spread between
     two keys, which must be below the rtol too, in the log); 3 steps each of
     make_vertex_train_step and of make_edge_aware_loss_fn with SGD 1e-4 at
     bench_train.py's vertex shape (256², 4 bounces, 8 spp, 64 samples per edge,
     rim 16 per edge at pixel stride 4), whose losses must be finite;
  4d. the integrator ladder's lower rungs and the sorted wavefront, with every
     launch counter set to 0 first: the CLI `render` (Cornell 512², its default 64
     spp and 16 bounces) with primary, ao, ao-pallas, direct, direct-pallas and
     sorted, and render_sorted on sphere_field() at 512², 16 bounces, 64 spp. Each
     must exit 0 with a finite positive mean (a NaN or inf pixel makes the mean so);
     the AO and direct kernels must launch once each (one launch of 64 spp), the
     bounce kernel 16 times a call of 8 spp, and no other kernel at all; the CLI
     means are logged; then the AO and direct kernels per pixel against their
     reference-stream twins (integrators/ao.render_ao_sample_ref,
     integrators/direct.render_direct_sample_ref) summed over the same frames (512²,
     0-63), within 1e-5 (AO) and 1e-4 (direct) at all but 1e-4 of the pixels (an
     ulp can flip a decision of the twin's torch intersection: a whole sample);
  5. timing with CUDA events (warm-up, median of 5 for kernels; one run for plain
     versions; each run queued behind a 0.1 s spin kernel, so that the events time
     the device's work and not the host's launch work between kernels) of each
     kernel and its plain version at the main path's launch
     shape (512², 64 samples per launch; the BVH kernels' plain versions at 1
     sample, against the kernel at 1 sample), as Mrays/s = traced segments per
     second; the two results of each pair are held against each other by phase
     3's rule (the skip-link kernel bit for bit); the wavefront (tp) also with runs
     of 1, 4 and 64 samples a lane, the megakernel (tp with the tp0 peel, and parity) with runs of 1, 2, 4, 8 and 64,
     and the SM clock and power draw (nvidia-smi, every 100 ms)
     over 200 back-to-back megakernel launches. Then the linear-vs-BVH crossover:
     the megakernel against the 8-wide BVH kernel, fast scan, on sphere_field(n, 2)
     for n = 1..16 at 256², 4 bounces.
     The adjoint kernel forward-only and with gradients against its plain version
     at 256², 4 bounces, 8 spp (bench_train.py's shape); the material gathers'
     backward (gather_grad.cu, the port's own kernel) at the twin step's shape (the
     Cornell box's 65,536 primary-hit mat_ids at 256² onto its (18, 3) albedo table)
     bit for bit against its plain version and a rerun, against autograd's index_put_
     backward of the same gather (its `library_ms`); and the three train steps
     (kernel, hybrid, twin) in ms/step (host clock around synchronize, median) and
     Mrays/s counted as bench_train.py:12-18 counts: 4 × the segments of one spp
     window for the kernel and hybrid steps, 2 × for the twin; one more step of each
     under torch.profiler gives its device time and busy share. trace_rays against
     its plain version at the rim probes' full-width shape (1,572,864 rows, 3
     bounces, 2 spp, parity; also at runs of 1 and 2 samples a lane); the megakernel
     and trace_rays at the launches of one step of phase 4c's SGD recovery run
     (recorded through diff/vertex.py: 2 megakernel launches at 64², 2 bounces, 8
     spp, 4 trace_rays launches), each at its defaults and at every run, against its
     plain version bit for bit, with its bound; and the two vertex steps of phase 4c
     (kernel probes, twin probes) in ms/step with one profiled step each. The AO and direct kernels
     against their plain versions at the CLI's shape (Cornell 512², 64 spp in one
     launch), bit for bit, as Mrays/s of the rays they cast (camera rays, and the
     second rays where cast, counted by the plain versions), and each at 1, 2, 4, 8,
     16 and 32 lanes a pixel, the same bits (`ms_by_lanes`). The sorted wavefront at
     render_sorted's shape (512², 16 bounces, 8 spp a call, leaf 32) on sphere_field()
     and the Cornell box: its 16 bounce launches, whole calls with the sort off and
     on (and the bounce kernels' own device time in each, from events around each
     launch, which says whether the sort buys kernel time; each launch's device time
     and traced rays are logged), and the skip-link kernel
     at the same samples (whose image it must equal bit for bit); the plain version at 1 spp
     against the kernel at 1 spp, bit for bit;
  6. the bench path, with every launch counter set to 0 first: `cli.main(["bench"])`
     (bench.py at its full shape: Cornell 512², the parity anchor against tp + tp0
     at 4 bounces 64 spp and against the tp wavefront at 16 bounces 32 spp, 6
     alternating pairs), whose JSON line must hold every key, each rate finite and
     > 0 and both ratios > 0, logged beside the card's name and power limit; then
     bench_train.main() at its shape (256², 4 bounces, 8 spp, best of 6 steps), whose
     five train_step_* lines must have finite values. The megakernel, wavefront,
     adjoint and trace_rays kernels must each launch in this window. Then
     load_cornell_box on the card must go through the native C++ parser
     (runtime/native.py, built by g++ at first use) and its Scene must equal the
     Python parser's bit for bit; and the compile listener registered before the
     build (runtime/cache.register_compile_listener) must have fired once for each
     library built in this process (nvcc's kernels, g++'s native runtime);
  7. the sharded path (parallel/, the two sharded train steps, the dry run and
     bench_scaling), every mesh n × cuda:0, each sharded call with the launch counts
     set to 0 just before it and read just after (the single calls it is held
     against are not counted): make_sharded_kernel_step with the tp megakernel at
     512², 4 bounces, 64 spp on 1, 2, 4 and 8 entries and with the tp wavefront at
     16 bounces on 2 and 8, each image and segment count bit for bit one call's;
     render_pallas_sharded over 40 spp in calls of 16 (a short last chunk) bit for
     bit render_pallas's; render_progressive_sharded at 64², 2 bounces, 4 spp and
     at 33x9 (297 pixels padded to 304) on 8 entries bit for bit
     render_progressive(backend="jnp"); make_sharded_kernel_train_step at
     bench_train's shape (256², 4 bounces, 8 spp) from the train_kernel example's
     start, 3 steps on 8 entries, each step's params also through the 1-entry step
     and make_kernel_train_step: the forward images (recorded at the adjoint
     wrapper) bit for bit, the loss within 1e-6 relative, the gradients (the
     entries' ga + gb added in mesh order) by phase 3's adjoint rule, the params
     within lr × that rule, and a rerun of the 3 steps bit for bit;
     make_sharded_train_step at 64², 2 bounces, 2 spp, 2 steps, 8 entries against
     1 (losses and params rtol 1e-5); dryrun_multichip(8) (its line logged) and
     bench_scaling's line (one row on one card). The megakernel, wavefront and
     adjoint kernels must each launch in this window. Then the sharded megakernel
     step on 1 and 8 entries against one call, timed as phase 5 times (CUDA events,
     each run queued behind a spin), in ms and Mrays/s: the cost of n launches on
     one card.

The last line is {"ok": true, "device": {...}}; the line before it lists the
kernels as JSON (`launches` summed over the render, train, vertex, integrator, bench
and sharded paths, each counted in its own window, `launches_by_path` split), each with its
bound (kernels/bounds.py: the larger of its FP32
operations over 67 TFLOP/s and its bytes over 3.35 TB/s, from this run's segment
counts and, for the BVH walks (the sorted wavefront's too), the boxes and leaf
triangles their plain versions tested, per segment, at the timed shape, and for AO
and direct the rays, eye rows and any-hit triangles theirs counted), `library_ms` null (no
PyTorch call computes a path trace, AO or NEE) and its launches on each path; the
BVH kernels also their time and bound at sphere_field(80, 3) (`ms_102k`,
`bound_ms_102k`), the adjoint kernel its forward-only launch's bound
(`forward_bound_ms`), the megakernel and trace_rays theirs at the vertex recovery
step's launches (`ms_vertex_step`, `plain_ms_vertex_step`, `bound_ms_vertex_step`:
sums over its `launches_vertex_step` launches).
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
TARGET_SPP = 64
JNP_MEAN_REL_MAX = 0.05
TWIN_FLIP_FRACTION = 1e-4  # phase 4d: pixels a decision flip may move (fast_kernels_vs_twins)
# The spin ahead of each timed run, about 0.1 s at the H100's 1.98 GHz boost clock:
# longer than the host takes to enqueue the run.
QUEUE_CYCLES = 200_000_000
NEW_INTEGRATORS = ("primary", "ao", "ao-pallas", "direct", "direct-pallas", "sorted")
FULL_SIZE = 512      # the CLI's default width and height
CLI_SPP = 64         # the CLI's default --spp
SORTED_CALL_SPP = 8  # render_sorted's samples a call
SORTED_MAIN_SPP = 64
WAVEFRONT_TIMED_RUNS = (1, 4, 64)  # phase 5: samples a lane takes at a time
MEGAKERNEL_TIMED_RUNS = (1, 2, 4, 8, 64)
TRACE_RAYS_TIMED_RUNS = (1, 2)
VERTEX_LAUNCH_RUNS = {"megakernel": (1, 2, 4, 8), "trace_rays": (1, 2, 4)}
GRAD_TIME_CALLS = 20  # launches per timed run of the adjoint kernel (about 0.5 ms each)
RENDER_KERNELS = ("megakernel", "wavefront", "bvh_megakernel", "wide_bvh")
BENCH_KEYS = ("metric", "value", "unit", "anchor_value", "ratio_vs_anchor", "value_16b",
              "anchor_16b", "ratio_vs_anchor_16b")
BENCH_TRAIN_METRICS = ("train_step_kernel", "train_step_hybrid", "train_step_jnp",
                       "train_step_vertex_jnp", "train_step_vertex_kernel")
BENCH_KERNELS = ("megakernel", "wavefront", "grad_megakernel", "trace_rays")
COMPILE_EVENTS = []  # (event, seconds) of each build in this process (main's listener)
VERTEX_SIZE = 64           # examples/train_vertices.py's recovery run
VERTEX_STEPS = 100
VERTEX_SHIFT = 0.3
VERTEX_RECOVERY_RATIO = 0.6  # the examples' own threshold (examples/train_vertices.py:94)
FD_RTOL = 0.1                # tests/test_diff.py:171, tests/test_diff_fast.py:83
PROBE_EDGE_SAMPLES = 128     # phase 4c's probe check, per edge
PROBE_SPP = 8
PROBE_ROWS = 65_536
RIM_PIXEL_STRIDE = 4         # bench_train.py's vertex shape
SHARD_MESHES = (1, 2, 4, 8)  # the sharded phase's megakernel meshes, n × cuda:0
SHARD_WAVEFRONT_MESHES = (2, 8)
SHARD_TRAIN_STEPS = 3
SHARD_LR = 3e-2              # the train_kernel example's
SHARD_TWIN_SIZE = 64
SHARD_TRAILING = (40, 16)    # render_pallas_sharded: total spp, samples a call
SHARDED_KERNELS = ("megakernel", "wavefront", "grad_megakernel")


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


def queue_behind_spin() -> None:
    """Keep the stream busy for QUEUE_CYCLES (a spin kernel) so that the host enqueues
    the work that follows while the card waits: events recorded around that work then
    time it on the device, back to back, without the host's launch work between the
    kernels (work that synchronises inside, as the plain versions do, is timed end to
    end)."""
    import torch

    torch.cuda._sleep(QUEUE_CYCLES)


def cuda_time_ms(fn, warmup, reps: int = 5, calls: int = 1):
    """Median device ms of `fn()` over `reps` runs (CUDA events, each run queued
    behind a spin kernel: queue_behind_spin), after one `warmup()`; returns (ms, the
    last result). With calls > 1 each run makes that many calls back to back and
    counts their mean."""
    import torch

    warmup()
    torch.cuda.synchronize()
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        queue_behind_spin()
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
        if any(w in line for w in ("Compiling entry", "registers", "spill", "error")):
            log(f"[build] {line.strip()}")
    for name, counts in sass_counts(info.path).items():
        log(f"[sass] {name}: {sum(counts.values())} instructions; "
            + ", ".join(f"{op} {counts[op]}" for op in SASS_OPS if counts[op]))


# The SASS opcodes phase 2 counts per kernel: loads by memory space, the FP32
# arithmetic and compares, and branches.
SASS_OPS = ("LDS", "LDS.128", "LDG.E.CONSTANT", "LDG.E.128.CONSTANT", "LDG.E", "LDC", "LDC.64",
            "ULDC", "ULDC.64", "LDL", "STL", "FMUL", "FADD", "FSETP", "FMNMX", "BRA")


def sass_counts(path: str) -> dict:
    """Opcode counts per kernel of the built library (cuobjdump -sass): kernel name →
    Counter of opcodes, FSETP counted over its compare modes."""
    import collections
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)((?:\.[A-Z0-9_]+)*)",
                     line)
        if m and cur is not None:
            op, mods = m.group(1), m.group(2)
            cur[op if op in ("FSETP", "FMUL", "FADD", "BRA") else op + mods] += 1
    return out


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
        r = selfcheck.check_case(case, tables)
        r["ok"] = r["ok"] and r["bitwise"]
        report(f"{case.name} {case.n_samples}spp", r, failed)
    for name, fn in (("wavefront k=1 == megakernel (tp0 off), bit for bit",
                      selfcheck.wavefront_k1_equals_megakernel),
                     ("table in global memory == in shared memory, bit for bit",
                      selfcheck.global_table_matches_shared),
                     ("megakernel at runs 1, 2 and all, and a ragged pixel range, bit for bit "
                      "against the plain version", selfcheck.linear_runs_agree),
                     ("wide BVH kernel == skip-link kernel, bit for bit (deep: a 14-level tree)",
                      selfcheck.wide_equals_skip_walk),
                     (f"wavefront runs {selfcheck.WAVEFRONT_RUNS}, scan table in shared "
                      f"and in global memory, same bits", selfcheck.wavefront_splits_agree),
                     ("wide BVH kernel in one-sample launches, and with the largest stack, "
                      "== one launch, bit for bit", selfcheck.wide_chunks_agree)):
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
    for name, r in selfcheck.trace_rays_checks(tables, PROBE_ROWS, bounces=4,
                                               n_samples=4).items():
        log(f"[check] trace_rays {PROBE_ROWS} rows b4 4spp, {name}: {r}")
        if not r["ok"]:
            failed.append(f"trace_rays {name}")
    for name, r in selfcheck.fast_integrator_checks(tables, SMOKE_SIZE, SMOKE_SIZE).items():
        log(f"[check] {name}, Cornell {SMOKE_SIZE}x{SMOKE_SIZE} 4spp: {r}")
        if not r["ok"]:
            failed.append(name)
    for name, r in selfcheck.sorted_checks(tables, SMOKE_SIZE, SMOKE_SIZE).items():
        log(f"[check] sorted wavefront {name}, leaf {selfcheck.SORTED_LEAF} "
            f"{SMOKE_SIZE}x{SMOKE_SIZE} b4 2spp: {r}")
        if not r["ok"]:
            failed.append(f"sorted {name}")
    r = selfcheck.hybrid_forward_check(tables, TRAIN_SIZE, TRAIN_SIZE, bounces=4,
                                       n_samples=TRAIN_SPP)
    log(f"[check] hybrid make_fast_renderer forward, Cornell {TRAIN_SIZE}x{TRAIN_SIZE} b4 "
        f"{TRAIN_SPP}spp, vs the megakernel's plain version on its card-packed table: {r}")
    if not r["ok"]:
        failed.append("hybrid forward")
    require(not failed, f"kernel checks failed: {failed}")


# Each kernel's launch counter: the name reported here -> runtime.profiling's counter.
COUNTERS = {"megakernel": "launch.megakernel", "wavefront": "launch.wavefront",
            "bvh_megakernel": "launch.bvh", "wide_bvh": "launch.wide_bvh",
            "grad_megakernel": "launch.grad", "trace_rays": "launch.trace_rays",
            "ao": "launch.ao", "direct": "launch.direct", "sorted_bounce": "launch.sorted",
            "gather_grad": "launch.gather_grad"}
_counts_base: dict = {}


def reset_counts() -> None:
    from oclpathtracer_tpu_torch.runtime import profiling

    _counts_base.clear()
    _counts_base.update(profiling.counts())


def read_counts() -> dict:
    """Launches of each kernel since the last reset_counts()."""
    from oclpathtracer_tpu_torch.runtime import profiling

    now = profiling.counts()
    return {name: now.get(c, 0) - _counts_base.get(c, 0) for name, c in COUNTERS.items()}


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
    from oclpathtracer_tpu_torch.kernels.selfcheck import PROCGEN_EYE, scene_cfg
    from oclpathtracer_tpu_torch.render.driver import render_progressive

    reset_counts()
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
        before = read_counts()["wide_bvh"]
        timed(f"{label} 512x512 b16 {BVH_MAIN_SPP}spp auto",
              lambda: render_progressive(scene, procgen_cfg, total_spp=BVH_MAIN_SPP,
                                         samples_per_step=MAIN_STEP, backend="auto"))
        require(read_counts()["wide_bvh"] > before, f"{label}: auto did not launch wide_bvh")
    deep = tables.scene("deep")
    depth = tables.wide("deep", "tp", 32)[3]
    before = read_counts()["wide_bvh"]
    timed(f"deep_scene() {deep.num_triangles} tris ({depth}-level tree) 512x512 b16 "
          f"{MAIN_STEP}spp auto",
          lambda: render_progressive(deep, scene_cfg("deep", 512, 512, 16), total_spp=MAIN_STEP,
                                     samples_per_step=MAIN_STEP, backend="auto"))
    require(depth > 12 and read_counts()["wide_bvh"] > before,
            f"deep_scene(): depth {depth}, auto did not launch wide_bvh")
    with tempfile.TemporaryDirectory() as tmp:
        for argv in ([], ["--integrator", "widebvh"], ["--integrator", "bvh"]):
            png = os.path.join(tmp, "cli.png")
            rc = cli.main(["render", "--spp", "16", "--bounces", "16", *argv, "-o", png])
            require(rc == 0 and os.path.getsize(png) > 0, f"CLI render {argv} failed (rc {rc})")
            os.remove(png)
    launches = read_counts()
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


def phase_train(tables):
    """The training path, driven through the diff/ entry points on the Cornell box."""
    import torch

    from oclpathtracer_tpu_torch import bench_train
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast, inverse
    from oclpathtracer_tpu_torch.examples import train_kernel
    from oclpathtracer_tpu_torch.kernels import megakernel
    from oclpathtracer_tpu_torch.render.driver import render_progressive

    cornell = tables.scene("cornell")
    jnp_cfg = RenderConfig(RECOVERY_SIZE, RECOVERY_SIZE, bounces=4)
    jnp_ref = megakernel.render_pallas(cornell, jnp_cfg, 16)  # a comparison: not counted
    reset_counts()
    true = fast.extract_class_params(cornell)

    # The train_kernel example's run: recover the class albedos with the adjoint kernel.
    cfg = RenderConfig(RECOVERY_SIZE, RECOVERY_SIZE, bounces=4)
    target = train_kernel.target_image(cornell, cfg, TARGET_SPP)
    params = train_kernel.perturbed(true)
    err0 = class_albedo_error(params, true)
    step = fast.make_kernel_train_step(cornell, cfg, TRAIN_SPP, lr=3e-2)
    losses, per_step = [], set()
    t0 = time.perf_counter()
    for i in range(RECOVERY_STEPS):
        before = read_counts()["grad_megakernel"]
        params, loss = step(params, target, i)
        per_step.add(read_counts()["grad_megakernel"] - before)
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
    target = train_kernel.target_image(cornell, cfg, TARGET_SPP)
    ostep, opt_init = fast.make_kernel_optax_step(
        cornell, cfg, TRAIN_SPP, functools.partial(torch.optim.Adam, lr=5e-2))
    params = train_kernel.perturbed(true)
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

    # The hybrid's forwards are the parity megakernel, 2 a step, and its backward renders
    # both through the twin; the twin step renders once. Each backward calls gather_grad
    # once for each gather of the twin it reaches: a sample's 4 emissive and 3 albedo
    # gathers (the last bounce's albedo feeds only the mask, which nothing reads after
    # it). Nothing else in this phase launches the megakernel or gather_grad.
    gathers = TRAIN_SPP * (2 * cfg.bounces - 1)
    for name, run, per_step_want in (
            ("hybrid make_fast_loss_fn", bench_train.hybrid_step(cornell, cfg, TRAIN_SPP),
             (2, 2 * gathers)),
            ("twin make_train_step", bench_train.twin_step(cornell, cfg, TRAIN_SPP),
             (0, gathers))):
        params = inverse.extract_params(cornell, albedo=True, emissive=True)
        losses, per_step = [], set()
        for i in range(3):
            before = read_counts()
            params, loss = run(params, target, i)
            after = read_counts()
            per_step.add(tuple(after[k] - before[k] for k in ("megakernel", "gather_grad")))
            losses.append(float(loss))
        log(f"[train] {name} {TRAIN_SIZE}x{TRAIN_SIZE} b4 {TRAIN_SPP}spp, 3 steps: "
            f"losses {[round(x, 6) for x in losses]}, (megakernel, gather_grad) launches a "
            f"step {per_step}")
        require(per_step == {per_step_want},
                f"{name}: (megakernel, gather_grad) launches a step {per_step}, not "
                f"{per_step_want}")
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

    launches = read_counts()
    log(f"[train] launches {launches}")
    require(launches["grad_megakernel"] > 0 and launches["megakernel"] == 2 * 3,
            f"the training path did not launch its kernels as counted: {launches}")
    return launches


def vertex_steps(cornell, cfg):
    """bench_train's two vertex steps at `cfg` (8 spp, target zeros, key 0, step index
    0, SGD 1e-4): {name: (run(params) → (params, loss), params)}. "kernel" is
    make_vertex_train_step (interior_spp 2); "twin" is autograd of
    make_edge_aware_loss_fn, all of it through the twin (bench_train's "jnp")."""
    import torch

    from oclpathtracer_tpu_torch import bench_train
    from oclpathtracer_tpu_torch.diff import extract_params

    target = torch.zeros((cfg.n_pixels, 3), device=cornell.geometry.p1.device)
    params = extract_params(cornell, albedo=False, vertices=True)
    steps = bench_train.vertex_steps(cornell, cfg, TRAIN_SPP)
    return {name: (functools.partial(lambda step, p: step(p, target, 0), steps[key]), params)
            for name, key in (("kernel", "kernel"), ("twin", "jnp"))}


def recovery_setup(cornell, factory):
    """The train_vertices example's run with the optimizer `factory` makes: (step,
    opt_init, the moved light's params, the target, the key, the true vertices)."""
    from oclpathtracer_tpu_torch.examples import train_vertices

    return train_vertices.setup(cornell, VERTEX_SIZE, TRAIN_SPP, factory, VERTEX_SHIFT)


def recovery_run(cornell, factory):
    """The train_vertices example's run with the optimizer `factory` makes: (initial
    and final light-vertex error, losses, the set of (megakernel, trace_rays)
    launches a step, seconds)."""
    import torch

    from oclpathtracer_tpu_torch.examples.train_vertices import light_error

    step, init, params, target, key, true_v = recovery_setup(cornell, factory)
    err0 = light_error(params, true_v)
    state = init(params)
    losses, per_step, errs = [], set(), []
    t0 = time.perf_counter()
    for i in range(VERTEX_STEPS):
        before = read_counts()
        params, state, loss = step(params, state, target, i, key)
        after = read_counts()
        per_step.add((after["megakernel"] - before["megakernel"],
                      after["trace_rays"] - before["trace_rays"]))
        losses.append(loss)
        if (i + 1) % 10 == 0:
            errs.append(light_error(params, true_v))
    secs = time.perf_counter() - t0
    return err0, errs, torch.stack(losses).cpu().numpy(), per_step, secs


def recovery_launches(cornell):
    """The megakernel and trace_rays launches of one step of the SGD 2e-4 recovery
    run, as (kind, args, kwargs) in launch order: the step's calls of the two
    wrappers, recorded on their way through diff/vertex.py."""
    import torch

    from oclpathtracer_tpu_torch.diff import vertex

    step, init, params, target, key, _ = recovery_setup(
        cornell, functools.partial(torch.optim.SGD, lr=2e-4))
    calls = []
    originals = {"megakernel": vertex.render_samples_pallas_stats,
                 "trace_rays": vertex.trace_rays_pallas_stats}

    def recorder(kind):
        def call(*args, **kw):
            calls.append((kind, args, kw))
            return originals[kind](*args, **kw)
        return call

    vertex.render_samples_pallas_stats = recorder("megakernel")
    vertex.trace_rays_pallas_stats = recorder("trace_rays")
    try:
        step(params, init(params), target, 0, key)
    finally:
        vertex.render_samples_pallas_stats = originals["megakernel"]
        vertex.trace_rays_pallas_stats = originals["trace_rays"]
    return calls


def phase_vertex(tables):
    """Vertex training through diff/vertex.py and diff/edge.py, its own counters."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.convert import scene_from_numpy
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.diff import (
        boundary_vertex_grads,
        extract_params,
        inverse,
        make_edge_aware_loss_fn,
    )
    from oclpathtracer_tpu_torch.diff.edge import rays_at
    from oclpathtracer_tpu_torch.kernels import megakernel as mk
    from oclpathtracer_tpu_torch.kernels.selfcheck import occluder_arrays

    reset_counts()
    cornell = tables.scene("cornell")
    # The train_vertices example's run: recover the moved light. With Adam 1e-2 (the
    # root examples/train_vertices.py's optimizer) the error falls to about 0.064 by step 40 and then drifts back above 0.1,
    # here and in the JAX package's own step (tests/vertex_recovery_vs_jax.py), so
    # that run is reported and held to its launches and finite losses; the same run
    # with SGD 2e-4 must bring the error below VERTEX_RECOVERY_RATIO×.
    device = cornell.geometry.p1.device
    for name, factory, required in (
            ("Adam 1e-2", functools.partial(torch.optim.Adam, lr=1e-2), False),
            ("SGD 2e-4", functools.partial(torch.optim.SGD, lr=2e-4), True)):
        err0, errs, losses, per_step, secs = recovery_run(cornell, factory)
        err1 = errs[-1]
        log(f"[vertex] recovery {VERTEX_SIZE}x{VERTEX_SIZE} b2 {TRAIN_SPP}spp {VERTEX_STEPS} "
            f"{name} steps: {secs:.2f} s, loss {losses[0]:.6f} -> {losses[-1]:.6f}, light-vertex "
            f"error {err0:.4f} -> {err1:.4f} (limit {VERTEX_RECOVERY_RATIO * err0:.4f}, "
            f"{'required' if required else 'reported'}), every 10 steps {[round(e, 4) for e in errs]}, "
            f"(megakernel, trace_rays) launches a step {per_step}")
        require(per_step == {(2, 4)},
                f"vertex step launches {per_step}, not 2 megakernel + 4 trace_rays")
        require(bool(np.isfinite(losses).all()), f"recovery run {name}: a loss is not finite")
        require(not required or err1 < VERTEX_RECOVERY_RATIO * err0,
                f"recovery run {name}: light-vertex error {err0} -> {err1}, not below "
                f"{VERTEX_RECOVERY_RATIO}x")

    # The occluder: edge-aware gradients against central differences (tests/test_diff.py).
    occ = scene_from_numpy(*occluder_arrays(), device=device)
    cfg = RenderConfig(32, 32, bounces=2)
    key = rng.make_key(3, device)
    zeros = torch.zeros((cfg.n_pixels, 3), device=device)
    loss_plain = inverse.make_loss_fn(occ, cfg, 64)
    params = extract_params(occ, albedo=False, vertices=True)
    _, grads = inverse.value_and_grad(
        make_edge_aware_loss_fn(occ, cfg, 64, samples_per_edge=256, edge_spp=8, delta=0.03),
        params, zeros, key)

    def fd(leaf, comp, eps=0.08):
        def moved(h):
            vs = list(params.vertices)
            vs[leaf] = vs[leaf].clone()
            vs[leaf][2, comp] += h
            return float(loss_plain(params._replace(vertices=tuple(vs)), zeros, key))
        return (moved(eps) - moved(-eps)) / (2 * eps)

    movers = sorted(((leaf, comp) for leaf in range(3) for comp in range(2)),
                    key=lambda lc: -abs(float(grads.vertices[lc[0]][2, lc[1]])))[:3]
    fd_rows = []
    for leaf, comp in movers:
        g, f = float(grads.vertices[leaf][2, comp]), fd(leaf, comp)
        fd_rows.append((f"p{leaf + 1}[2,{comp}]", g, f))
        require(bool(np.isclose(g, f, rtol=FD_RTOL)), f"occluder p{leaf + 1}[2,{comp}]: "
                f"edge-aware {g} vs FD {f}")
    log(f"[vertex] occluder 32x32 b2 64spp, edge-aware vs central FD (eps 0.08, rtol "
        f"{FD_RTOL}): {fd_rows}")

    # Kernel probes against twin probes (tests/test_diff_fast.py).
    img = inverse.render_spp(occ, cfg, 16, key)
    weight = 2.0 * img / cfg.n_pixels
    g_twin = boundary_vertex_grads(occ, cfg, weight, key, samples_per_edge=128, spp=8,
                                   delta=0.03)
    table = mk.pack_scene(occ)

    def probe(coords):
        o, d = rays_at(coords, cfg)
        out, _ = mk.trace_rays_pallas_stats(table, o.contiguous(), d, cfg, 8, scan="parity")
        return out / 8

    g_ker = boundary_vertex_grads(occ, cfg, weight, key, samples_per_edge=128, spp=8,
                                  delta=0.03, probe_fn=probe)
    top = torch.argsort(g_twin[0].abs().flatten(), descending=True)[:3].tolist()
    pairs = [(float(g_twin[0].flatten()[i]), float(g_ker[0].flatten()[i])) for i in top]
    log(f"[vertex] occluder boundary term p1, 3 largest, twin vs kernel probes (a smoke "
        f"test: the occluder's probe radiance does not depend on the draws): {pairs}")
    require(all(bool(np.isclose(a, b, rtol=FD_RTOL)) for a, b in pairs),
            f"kernel probes vs twin probes: {pairs}")
    cornell_probe_check(cornell)

    # bench_train.py's vertex shape: 3 steps of each.
    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=4)
    for name, (run, params) in vertex_steps(cornell, cfg).items():
        losses = []
        t0 = time.perf_counter()
        for _ in range(3):
            params, loss = run(params)
            losses.append(float(loss))
        log(f"[vertex] full width {name} step {TRAIN_SIZE}x{TRAIN_SIZE} b4 {TRAIN_SPP}spp, 3 "
            f"steps in {time.perf_counter() - t0:.2f} s: losses {losses}")
        require(bool(np.isfinite(losses).all()) and
                all(bool(torch.isfinite(v).all()) for v in params.vertices),
                f"full-width {name} vertex step: a loss or a vertex is not finite")

    launches = read_counts()
    log(f"[vertex] launches {launches}")
    require(launches["trace_rays"] > 0 and launches["megakernel"] > 0,
            f"the vertex path did not launch its kernels: {launches}")
    return launches


def cornell_probe_check(cornell):
    """Phase 4c's kernel-probe vs twin-probe check on the Cornell box, whose probe
    radiance depends on the paths' draws (2 bounces: the light seen through a
    bounce): the primary boundary term of every vertex (32², weight 2·img/n,
    PROBE_EDGE_SAMPLES samples per edge, PROBE_SPP paths per probe), its 3 largest
    entries with kernel probes (trace_rays, reference streams) against twin probes
    (threefry key 3) within FD_RTOL. The noise is the twin's own spread at those
    entries between keys 3 and 4: it must be below FD_RTOL too, or the check could
    not tell probes apart from noise."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.diff import boundary_vertex_grads, inverse
    from oclpathtracer_tpu_torch.diff.edge import rays_at
    from oclpathtracer_tpu_torch.kernels import megakernel as mk

    device = cornell.geometry.p1.device
    cfg = RenderConfig(32, 32, bounces=2)
    weight = 2.0 * inverse.render_spp(cornell, cfg, 16, rng.make_key(3, device)) / cfg.n_pixels
    table = mk.pack_scene(cornell)

    def probe(coords):
        o, d = rays_at(coords, cfg)
        out, _ = mk.trace_rays_pallas_stats(table, o.contiguous(), d, cfg, PROBE_SPP,
                                            scan="parity")
        return out / PROBE_SPP

    kw = dict(samples_per_edge=PROBE_EDGE_SAMPLES, spp=PROBE_SPP, delta=0.03)
    flat = [torch.cat([g.flatten() for g in boundary_vertex_grads(cornell, cfg, weight, key,
                                                                  probe_fn=fn, **kw)])
            for key, fn in ((rng.make_key(3, device), None), (rng.make_key(4, device), None),
                            (rng.make_key(3, device), probe))]
    twin, other, kern = flat
    top = torch.argsort(twin.abs(), descending=True)[:3]
    noise = float(((twin[top] - other[top]).abs() / twin[top].abs()).max())
    pairs = [(float(a), float(b)) for a, b in zip(twin[top], kern[top])]
    log(f"[vertex] Cornell 32x32 b2 boundary term, {PROBE_EDGE_SAMPLES} samples per edge, "
        f"{PROBE_SPP} spp a probe, 3 largest entries, twin vs kernel probes: {pairs}; noise "
        f"(twin, key 3 vs key 4) {noise:.3g}, rtol {FD_RTOL}")
    require(noise < FD_RTOL, f"Cornell probe check: noise {noise} is not below {FD_RTOL}")
    require(all(bool(np.isclose(a, b, rtol=FD_RTOL)) for a, b in pairs),
            f"Cornell kernel probes vs twin probes: {pairs}")


def captured(tag: str, fn, *args):
    """fn(*args) with its standard output captured and logged under [tag]: (its
    result, the output's lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"[{tag}] {line}")
    return result, lines


def run_cli(argv):
    """cli.main(argv) with its standard output captured and logged: (rc, the image
    mean it printed)."""
    from oclpathtracer_tpu_torch import cli

    rc, lines = captured("cli", cli.main, argv)
    text = "\n".join(lines)
    mean = float(text.split("mean=")[1].split()[0]) if "mean=" in text else float("nan")
    return rc, mean


def phase_integrators(tables):
    """The CLI's lower integrator rungs and the sorted wavefront, their own counters."""
    import torch

    from oclpathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from oclpathtracer_tpu_torch.kernels.selfcheck import PROCGEN_EYE
    from oclpathtracer_tpu_torch.kernels.sorted_wavefront import render_sorted

    reset_counts()
    means = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in NEW_INTEGRATORS:
            png = os.path.join(tmp, "cli.png")
            t0 = time.perf_counter()
            rc, mean = run_cli(["render", "--integrator", name, "--width", str(FULL_SIZE),
                                "--height", str(FULL_SIZE), "--spp", str(CLI_SPP),
                                "--bounces", "16", "-o", png])
            log(f"[integrators] CLI {name} {FULL_SIZE}x{FULL_SIZE} {CLI_SPP}spp b16: "
                f"{time.perf_counter() - t0:.2f} s, rc {rc}, mean {mean}")
            require(rc == 0 and os.path.getsize(png) > 0, f"CLI render {name} failed (rc {rc})")
            require(bool(np.isfinite(mean) and mean > 0.0), f"CLI {name}: mean {mean}")
            means[name] = mean
            os.remove(png)
    cfg = RenderConfig(FULL_SIZE, FULL_SIZE, bounces=16, camera=CameraConfig(eye=PROCGEN_EYE))
    t0 = time.perf_counter()
    img = render_sorted(tables.scene("spheres5k"), cfg, SORTED_MAIN_SPP)
    torch.cuda.synchronize()
    log(f"[integrators] render_sorted sphere_field() {FULL_SIZE}x{FULL_SIZE} b16 "
        f"{SORTED_MAIN_SPP}spp: "
        f"{time.perf_counter() - t0:.2f} s")
    check_image("render_sorted sphere_field()", img)
    for kernel, twin in (("ao-pallas", "ao"), ("direct-pallas", "direct")):
        log(f"[integrators] CLI means: {kernel} {means[kernel]}, {twin} {means[twin]} (other "
            f"streams: reported, not compared)")
    launches = read_counts()
    log(f"[integrators] launches {launches}")
    # 16 bounce launches a call of 8 spp: the CLI's 64 spp and render_sorted's.
    calls = -(-CLI_SPP // SORTED_CALL_SPP) - (-SORTED_MAIN_SPP // SORTED_CALL_SPP)
    want = {"ao": 1, "direct": 1, "sorted_bounce": 16 * calls}
    require(all(launches[n] == want.get(n, 0) for n in launches),
            f"the integrator path's launches {launches}, not {want} and no other")
    fast_kernels_vs_twins(tables)
    return launches


def fast_kernels_vs_twins(tables):
    """The AO and direct kernels per pixel against their reference-stream twins
    (integrators/ao.render_ao_sample_ref, integrators/direct.render_direct_sample_ref)
    summed over the same frames, the CLI's (512², frames 0-63), within the tolerances
    of tests/test_torch_fast_integrators.py: AO 1e-5, direct 1e-4 (its kernel clamps
    the BRDF denominator after the x4, its twin before). The twins intersect with
    torch's batched ops, whose rounding is not the kernels', so over 16.7 M samples
    a hit or visibility decision can flip at an ulp and move a pixel by a whole
    sample: at most TWIN_FLIP_FRACTION of the pixels may lie outside the tolerance
    (the log gives the count). Comparisons: not counted."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.integrators import ao, direct
    from oclpathtracer_tpu_torch.kernels import selfcheck

    cornell = tables.scene("cornell")
    cfg = RenderConfig(FULL_SIZE, FULL_SIZE)
    for kind, twin, tol in (("ao", ao.render_ao_sample_ref, 1e-5),
                            ("direct", direct.render_direct_sample_ref, 1e-4)):
        got = selfcheck.run_fast(kind, tables, cfg, 0, CLI_SPP)
        want = torch.zeros_like(got)
        for frame in range(CLI_SPP):
            want = want + twin(cornell, cfg, frame)
        close = torch.isclose(got, want, rtol=tol, atol=tol).all(dim=1)
        off = int((~close).sum())
        err = float((got - want).abs().max())
        inside = float((got - want).abs().amax(dim=1)[close].max())
        log(f"[integrators] {kind} kernel vs {twin.__name__} summed over frames 0-{CLI_SPP - 1}, "
            f"{FULL_SIZE}x{FULL_SIZE}: pixels outside rtol=atol={tol}: {off} of {cfg.n_pixels} "
            f"(limit {TWIN_FLIP_FRACTION * cfg.n_pixels:.0f}), max|diff| {err:.3g} there and "
            f"{inside:.3g} on the rest; means {float(got.mean()) / CLI_SPP:.6f} vs "
            f"{float(want.mean()) / CLI_SPP:.6f}")
        require(off <= TWIN_FLIP_FRACTION * cfg.n_pixels,
                f"{kind} kernel vs its twin: {off} pixels outside {tol}")


def time_pair(label, kern, plain, n_kernel, n_plain, rows, failed, **info):
    """Time kern(n_kernel) (warm-up, median of 5) and plain(n_plain) (one run), and
    hold kern(n_plain) against plain(n_plain) by phase 3's rule."""
    from oclpathtracer_tpu_torch.kernels import bvh_megakernel, selfcheck

    ms, (img_k, segs) = cuda_time_ms(lambda: kern(n_kernel), lambda: kern(n_kernel))
    bvh_megakernel.WALK_COUNTS.update(boxes=0, tris=0)
    plain_ms, (img_p, segs_p) = cuda_time_ms(lambda: plain(n_plain), lambda: None, reps=1)
    walk = dict(bvh_megakernel.WALK_COUNTS)
    segs_k = segs
    if n_plain != n_kernel:
        img_k, segs_k = kern(n_plain)
    r = selfcheck.compare(img_k, segs_k, img_p, segs_p)
    row = {"name": label, **info, "spp": n_kernel, "ms": ms, "segments": int(segs),
           "mrays": int(segs) / (ms * 1e3), "plain_spp": n_plain, "plain_ms": plain_ms,
           "plain_mrays": int(segs_p) / (plain_ms * 1e3), "plain_segments": int(segs_p),
           "walk": walk,
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
    variants = {}
    for run_len in WAVEFRONT_TIMED_RUNS:
        case = Case("wavefront", "tp", 512, 512, 16, run=run_len)
        ms, (_, segs) = cuda_time_ms(lambda c=case: run(c, tables, start=TIME_START, n=MAIN_STEP),
                                     lambda c=case: run(c, tables, start=TIME_START, n=MAIN_STEP))
        variants[f"run {run_len}"] = ms
        log(f"[time] wavefront tp Cornell 512x512 b16 {MAIN_STEP}spp, run {run_len}: {ms:.3f} ms "
            f"({int(segs)} segments)")
    rows.append({"name": "wavefront runs", "ms": variants})
    variants = {}
    for scan in ("tp", "parity"):
        cfg = RenderConfig(512, 512, bounces=4)
        table, emi, classes = tables.linear("cornell", scan)
        tp0_table = mk.tp0_table_for(table, cfg, scan)
        for run_len in MEGAKERNEL_TIMED_RUNS:
            def launch(scan=scan, cfg=cfg, table=table, emi=emi, classes=classes,
                       tp0_table=tp0_table, run_len=run_len):
                return mk.render_samples_pallas_stats(
                    table, cfg, TIME_START, MAIN_STEP, scan=scan, classes=classes,
                    emi_const=emi, tp0_table=tp0_table, run=run_len)

            ms, (_, segs) = cuda_time_ms(launch, launch)
            variants[f"{scan} run {run_len}"] = ms
            log(f"[time] megakernel {scan} Cornell 512x512 b4 {MAIN_STEP}spp, run {run_len}: "
                f"{ms:.3f} ms ({int(segs)} segments)")
    rows.append({"name": "megakernel runs", "ms": variants})
    clock = clock_under_load(launch)
    log(f"[time] SM clock and power over {clock['launches']} back-to-back launches of the last "
        f"megakernel case: {clock}")
    rows.append({"name": "megakernel clock", **clock})
    for scene, leaf in (("spheres5k", 32), ("spheres102k", 64)):
        for kernel in ("bvh", "widebvh"):
            case = Case(kernel, "fast", 512, 512, 16, scene=scene, leaf=leaf)
            row = time_pair(f"{kernel} fast leaf {leaf} {scene} 512x512 b16",
                            lambda n, c=case: run(c, tables, start=TIME_START, n=n),
                            lambda n, c=case: run(c, tables, plain=True, start=TIME_START, n=n),
                            MAIN_STEP, 1, rows, failed, kernel=kernel, scan="fast", bounces=16,
                            scene=scene)
            if kernel == "bvh" and not row["bitwise"]:  # the skip-link kernel: bit for bit
                failed.append(f"{row['name']}: not bit for bit")
    require(not failed, f"kernel vs plain at the main path's shapes failed: {failed}")
    return rows


def clock_under_load(fn, launches: int = 200) -> dict:
    """The SM clock (MHz) and power draw (W) that nvidia-smi samples every 100 ms
    while `launches` calls of fn run back to back: their median and maximum."""
    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate(timeout=60)[0]
    samples = [[float(x) for x in line.split(",")] for line in text.strip().splitlines()
               if line.count(",") == 1]
    mhz = [m for m, _ in samples]
    watts = [w for _, w in samples]
    return {"launches": launches, "samples": len(samples),
            "sm_mhz_median": statistics.median(mhz), "sm_mhz_min": min(mhz),
            "power_w_median": statistics.median(watts), "power_w_max": max(watts)}


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


def phase_gather_grad_timing(tables):
    """The material gathers' backward at the twin step's shape: the Cornell box's
    primary-hit mat_ids at 256² (65,536 rows) onto its (18, 3) albedo table. The kernel
    (two launches) bit for bit against its plain version and a rerun; its time against
    the plain version's and against autograd's backward of the same gather
    (index_put_(accumulate=True): a sort, then the duplicates of each index added in
    series), which it replaces."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import gather_grad as gg
    from oclpathtracer_tpu_torch.kernels import selfcheck

    cornell = tables.scene("cornell")
    idx = selfcheck.primary_mat_ids(cornell, RenderConfig(TRAIN_SIZE, TRAIN_SIZE))
    table = cornell.materials.albedo.detach().clone().requires_grad_()
    m, c = table.shape
    grad = torch.randn((idx.shape[0], c), generator=torch.Generator("cuda").manual_seed(0),
                       device="cuda")
    out = table[idx]  # autograd's gather, its graph kept for the timed backwards

    def autograd_backward():
        return torch.autograd.grad(out, table, grad, retain_graph=True)[0]

    ms, got = cuda_time_ms(lambda: gg.gather_grad(idx, grad, m),
                           lambda: gg.gather_grad(idx, grad, m), calls=GRAD_TIME_CALLS)
    again = gg.gather_grad(idx, grad, m)
    plain_ms, want = cuda_time_ms(lambda: gg.gather_grad_plain(idx, grad, m), lambda: None,
                                  reps=1)
    library_ms, lib = cuda_time_ms(autograd_backward, autograd_backward, calls=GRAD_TIME_CALLS)
    exact = torch.zeros((m, c), dtype=torch.float64, device="cuda").index_add_(
        0, idx.long(), grad.double())

    def gap(x):
        return float((x.double() - exact).norm() / exact.norm())

    row = {"name": f"gather_grad Cornell {TRAIN_SIZE}x{TRAIN_SIZE} mat_id -> ({m}, {c})",
           "rows": idx.shape[0], "table": [m, c], "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bitwise": bool(torch.equal(got, want)),
           "rerun_bitwise": bool(torch.equal(got, again)),
           "max_abs_err": float((got - want).abs().max()), "gap_f64": gap(got),
           "library_gap_f64": gap(lib)}
    log(f"[time] {row['name']}: kernel {ms:.4f} ms (2 launches), plain {plain_ms:.1f} ms, "
        f"autograd index_put_ backward {library_ms:.4f} ms; bitwise {row['bitwise']}, rerun "
        f"{row['rerun_bitwise']}; off the float64 sum: kernel {row['gap_f64']:.3g}, "
        f"index_put_ {row['library_gap_f64']:.3g}")
    require(row["bitwise"] and row["rerun_bitwise"],
            f"gather_grad vs its plain version or its rerun: not bit for bit: {row}")
    return row


def phase_trace_rays_timing(tables):
    """trace_rays against its plain version at the rim probes' full-width shape: one
    row per (strided prefix pixel, rim sample) of bench_train.py's vertex step,
    65,536 / 4 × 96 = 1,572,864 rows, 3 bounces, 2 spp, parity; held bit for bit."""
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import selfcheck

    from oclpathtracer_tpu_torch.examples.train_vertices import LIGHT_TRIS

    n = (TRAIN_SIZE * TRAIN_SIZE // RIM_PIXEL_STRIDE) * 3 * len(LIGHT_TRIS) * 16
    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=3)
    o, d = selfcheck.probe_rays(tables.scene("cornell"), n, cfg, seed=1)

    def run(plain=False):
        return selfcheck.run_trace_rays(tables, "parity", o, d, cfg, 2, plain=plain)

    ms, got = cuda_time_ms(run, run)
    plain_ms, want = cuda_time_ms(lambda: run(plain=True), lambda: None, reps=1)
    r = selfcheck.compare(*got, *want)
    segs = int(got[1])
    by_run = {}
    for run_len in TRACE_RAYS_TIMED_RUNS:
        def launch(run_len=run_len):
            return selfcheck.run_trace_rays(tables, "parity", o, d, cfg, 2, run=run_len)

        by_run[run_len] = cuda_time_ms(launch, launch)[0]
    row = {"rows": n, "bounces": 3, "spp": 2, "ms": ms, "segments": segs,
           "mrays": segs / (ms * 1e3), "plain_ms": plain_ms, "plain_mrays": segs / (plain_ms * 1e3),
           "max_abs_err": r["max_abs_err"], "bitwise": r["bitwise"], "ms_by_run": by_run}
    log(f"[time] trace_rays parity {n} rows b3 2spp: kernel {ms:.3f} ms ({row['mrays']:.1f} "
        f"Mrays/s, {segs} segments), plain {plain_ms:.1f} ms ({row['plain_mrays']:.3f} "
        f"Mrays/s); by run {by_run}; {r}")
    require(r["ok"] and r["bitwise"], f"trace_rays vs plain at the rim shape: {r}")
    return row


def phase_vertex_launch_timing(tables):
    """The megakernel and trace_rays at the vertex recovery run's launch shapes: the
    launches of one step of phase 4c's SGD run (recovery_launches: 2 megakernel
    launches at 64², 2 bounces, 8 spp, and 4 trace_rays launches, all parity), each
    timed at its defaults and at every run of VERTEX_LAUNCH_RUNS (median of 5), its
    plain version once and held bit for bit, with its bound; then for each kernel
    the step's sums over its launches. name → {"launches": [...], "ms", "plain_ms",
    "bound_ms", "ms_by_run", "segments"}."""
    from oclpathtracer_tpu_torch.kernels import bounds, selfcheck
    from oclpathtracer_tpu_torch.kernels import megakernel as mk

    fns = {"megakernel": (mk.render_samples_pallas_stats, mk._render_samples_stats_plain),
           "trace_rays": (mk.trace_rays_pallas_stats, mk._trace_rays_stats_plain)}
    out = {kind: {"launches": []} for kind in fns}
    failed = []
    for kind, args, kw in recovery_launches(tables.scene("cornell")):
        fn, plain = fns[kind]
        if kind == "megakernel":
            table, cfg, _, n_samples = args[:4]
            n, in_bytes = cfg.n_pixels, 0
        else:
            table, o, _, cfg, n_samples = args[:5]
            n, in_bytes = o.shape[0], 24 * o.shape[0]
        ms, got = cuda_time_ms(lambda: fn(*args, **kw), lambda: fn(*args, **kw))
        by_run = {}
        for run_len in VERTEX_LAUNCH_RUNS[kind]:
            if run_len <= n_samples:
                def launch(run_len=run_len):
                    return fn(*args, **kw, run=run_len)

                by_run[run_len] = cuda_time_ms(launch, launch)[0]
        plain_ms, want = cuda_time_ms(lambda: plain(*args, **kw), lambda: None, reps=1)
        r = selfcheck.compare(*got, *want)
        segs = int(got[1])
        bound = bounds.bound_ms(bounds.linear_ops(kw["scan"], table.shape[0], segs),
                                table.numel() * 4 + in_bytes + 12 * n)
        out[kind]["launches"].append({
            "rays": n, "bounces": cfg.bounces, "spp": n_samples, "ms": ms, "plain_ms": plain_ms,
            "segments": segs, "bound_ms": bound[0], "bound_by": bound[1], "ms_by_run": by_run,
            "bitwise": r["bitwise"]})
        log(f"[time] vertex recovery launch: {kind} {kw['scan']} {n} rays b{cfg.bounces} "
            f"{n_samples}spp: kernel {ms:.4f} ms ({segs} segments), by run {by_run}, plain "
            f"{plain_ms:.1f} ms, bound {bound[0]:.4f} ms, bitwise {r['bitwise']}")
        if not r["bitwise"]:
            failed.append(f"{kind} at {n} rays")
    for kind, row in out.items():
        launches = row["launches"]
        runs = set.intersection(*(set(x["ms_by_run"]) for x in launches))
        row.update({k: sum(x[k] for x in launches) for k in ("ms", "plain_ms", "bound_ms",
                                                             "segments")},
                   ms_by_run={r: sum(x["ms_by_run"][r] for x in launches) for r in sorted(runs)})
        log(f"[time] vertex recovery step, {kind}'s {len(launches)} launches: {row['ms']:.4f} ms "
            f"(by run {row['ms_by_run']}), plain {row['plain_ms']:.1f} ms, bound "
            f"{row['bound_ms']:.4f} ms")
    require(len(out["megakernel"]["launches"]) == 2 and len(out["trace_rays"]["launches"]) == 4,
            f"a recovery step's launches: {[(k, len(v['launches'])) for k, v in out.items()]}")
    require(not failed, f"kernel vs plain at the vertex recovery's launches: {failed}")
    return out


def phase_vertex_timing(tables):
    """ms per vertex step (host clock around synchronize, median of 3 after a
    warm-up) at bench_train.py's vertex shape, kernel probes and twin probes, and one
    profiled step each for device time and busy share."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig

    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=4)
    rows = {}
    for name, (run, params) in vertex_steps(tables.scene("cornell"), cfg).items():
        params, loss = run(params)  # warm-up
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            params, loss = run(params)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        device_ms, top = profile_device_ms(lambda: run(params))
        rows[name] = {"ms_per_step": ms, "loss": float(loss), "reps": 3, "device_ms": device_ms,
                      "device_busy": device_ms / ms, "top_device_ops": top}
        log(f"[time] vertex step {name} probes Cornell {TRAIN_SIZE}x{TRAIN_SIZE} b4 "
            f"{TRAIN_SPP}spp: {ms:.3f} ms/step (median of 3), loss {float(loss):.6f}; profiled "
            f"step: device {device_ms:.3f} ms, busy share {device_ms / ms:.4f}, top {top}")
    return rows


def phase_fast_timing(tables):
    """The AO and direct kernels against their plain versions at the CLI's shape
    (Cornell 512², 64 spp in one launch, from sample TIME_START), held bit for bit;
    Mrays/s of the rays they cast, counted by the plain version; each kernel's time
    at every lane count a pixel (`ms_by_lanes`), each held bit for bit too."""
    import torch

    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.kernels import fast_integrators as fi
    from oclpathtracer_tpu_torch.kernels import selfcheck

    cfg = RenderConfig(FULL_SIZE, FULL_SIZE)
    rows = {}
    for kind in ("ao", "direct"):
        counts = fi._new_counts()

        def kern(kind=kind):
            return selfcheck.run_fast(kind, tables, cfg, TIME_START, MAIN_STEP)

        def plain(kind=kind, counts=counts):
            return selfcheck.run_fast(kind, tables, cfg, TIME_START, MAIN_STEP, plain=True,
                                      counts=counts)

        ms, got = cuda_time_ms(kern, kern)
        plain_ms, want = cuda_time_ms(plain, lambda: None, reps=1)
        rays = counts["camera"] + counts["rays"]
        rows[kind] = {"ms": ms, "plain_ms": plain_ms, "spp": MAIN_STEP, "plain_spp": MAIN_STEP,
                      "rays": rays, "mrays": rays / (ms * 1e3),
                      "plain_mrays": rays / (plain_ms * 1e3), "counts": counts,
                      "mean": float(got.mean()) / MAIN_STEP,
                      "max_abs_err": float((got - want).abs().max()),
                      "bitwise": bool(torch.equal(got, want))}
        log(f"[time] {kind} Cornell {FULL_SIZE}x{FULL_SIZE} {MAIN_STEP}spp: kernel {ms:.3f} ms "
            f"({rows[kind]['mrays']:.1f} Mrays/s of {rays} rays cast, {counts}), plain "
            f"{plain_ms:.1f} ms ({rows[kind]['plain_mrays']:.3f} Mrays/s); bitwise "
            f"{rows[kind]['bitwise']} max|diff| {rows[kind]['max_abs_err']:.3g}")
        require(rows[kind]["bitwise"], f"{kind} kernel vs plain at the CLI's shape: not bitwise")
        by_lanes = {}
        for lanes in (1, 2, 4, 8, 16, 32):
            def at(kind=kind, lanes=lanes):
                return selfcheck.run_fast(kind, tables, cfg, TIME_START, MAIN_STEP, lanes=lanes)
            by_lanes[lanes], img = cuda_time_ms(at, at)
            require(bool(torch.equal(img, got)), f"{kind} kernel at {lanes} lanes: not bitwise")
        rows[kind]["ms_by_lanes"] = by_lanes
        log(f"[time] {kind} Cornell {FULL_SIZE}x{FULL_SIZE} {MAIN_STEP}spp by lanes a pixel "
            f"(default {fi.ao_lanes(MAIN_STEP) if kind == 'ao' else fi.direct_lanes(MAIN_STEP)}), "
            f"ms, each bitwise: {by_lanes}")
    return rows


def phase_sorted_timing(tables):
    """The sorted wavefront at render_sorted's shape (512², 16 bounces, 8 spp a call,
    leaf 32) on sphere_field() and the Cornell box: its 16 bounce launches alone
    (median of 5 after a warm-up), whole calls with the sort off and on, and the
    skip-link kernel at the same samples, whose image and segments it must equal bit
    for bit; the plain version at 1 spp held bit for bit against the kernel at 1 spp,
    its walk counted for the bound."""
    from oclpathtracer_tpu_torch.kernels import bvh_megakernel as bk
    from oclpathtracer_tpu_torch.kernels import selfcheck
    from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw

    leaf, n = selfcheck.SORTED_LEAF, SORTED_CALL_SPP
    rows = {}
    for scene in ("spheres5k", "cornell"):
        cfg = selfcheck.scene_cfg(scene, FULL_SIZE, FULL_SIZE, 16)
        tb, nf, ni, _, _ = tables.bvh(scene, "parity", leaf)

        def launches(tb=tb, nf=nf, ni=ni, cfg=cfg):
            return sw._trace_sorted(sw._bounce_step, tb, nf, ni, cfg, TIME_START, n, False)

        def call(sort, scene=scene, cfg=cfg):
            return selfcheck.run_sorted(tables, scene, cfg, TIME_START, n, sort)

        def skip(tb=tb, nf=nf, ni=ni, cfg=cfg):
            return bk.render_samples_bvh_stats(tb, nf, ni, cfg, TIME_START, n, max_leaf=leaf)

        def plain(scene=scene, cfg=cfg):
            return selfcheck.run_sorted(tables, scene, cfg, TIME_START, 1, plain=True)

        ms, (_, segs) = cuda_time_ms(launches, launches)
        off_ms, got = cuda_time_ms(lambda: call(False), lambda: call(False))
        on_ms, got_on = cuda_time_ms(lambda: call(True), lambda: call(True))
        bounce = {f"sort {'on' if sort else 'off'}": bounce_device_ms(tb, nf, ni, cfg, sort)
                  for sort in (False, True)}
        bounce_ms = {k: v["ms"] for k, v in bounce.items()}
        skip_ms, ref = cuda_time_ms(skip, skip)
        same = {"sort off": selfcheck._same(got, ref), "sort on": selfcheck._same(got_on, ref)}
        bk.WALK_COUNTS.update(boxes=0, tris=0)
        plain_ms, want = cuda_time_ms(plain, lambda: None, reps=1)
        walk = dict(bk.WALK_COUNTS)
        one = selfcheck.run_sorted(tables, scene, cfg, TIME_START, 1)
        r = selfcheck.compare(*one, *want)
        segs = int(segs)
        rows[scene] = {"ms": ms, "launches": cfg.bounces, "segments": segs,
                       "mrays": segs / (ms * 1e3), "call_ms_sort_off": off_ms,
                       "call_ms_sort_on": on_ms, "bounce_device_ms": bounce_ms,
                       "bounce_launches": bounce,
                       "skip_link_ms": skip_ms,
                       "sorted_over_skip_link": ms / skip_ms, "spp": n, "plain_spp": 1,
                       "plain_ms": plain_ms, "plain_segments": int(want[1]), "walk": walk,
                       "rays": cfg.n_pixels * n, "max_abs_err": r["max_abs_err"],
                       "bitwise": r["bitwise"], "equals_skip_link": same}
        log(f"[time] sorted wavefront {scene} {FULL_SIZE}x{FULL_SIZE} b16 {n}spp leaf {leaf}: "
            f"16 bounce launches {ms:.3f} ms ({rows[scene]['mrays']:.1f} Mrays/s, {segs} segments); "
            f"call sort off {off_ms:.3f} ms, sort on {on_ms:.3f} ms (the bounce kernels' own "
            f"time in a call {bounce_ms}); skip-link kernel "
            f"{skip_ms:.3f} ms (launches / skip-link {ms / skip_ms:.3f}); image == skip-link "
            f"{same}; plain {plain_ms:.1f} ms at 1spp, kernel vs plain at 1spp bitwise "
            f"{r['bitwise']}")
        for key, v in bounce.items():
            log(f"[time] sorted wavefront {scene} {key}, each launch: device ms "
                f"{[round(x, 4) for x in v['ms_by_launch']]}, rays traced "
                f"{v['traced_by_launch']}")
        require(all(same.values()) and r["bitwise"],
                f"sorted wavefront {scene}: not bit for bit ({same}, plain {r})")
    return rows


def bounce_device_ms(tb, nf, ni, cfg, sort: bool) -> dict:
    """The bounce kernels' own device time in one render_samples_sorted_stats call of
    SORTED_CALL_SPP samples from TIME_START: events around each launch, the call
    queued behind a spin, so the sort between launches is left out. "ms": the
    median of 3 calls' sums after a warm-up; "ms_by_launch" and "traced_by_launch":
    that call's time and traced rays of each launch."""
    import torch

    from oclpathtracer_tpu_torch.kernels import selfcheck
    from oclpathtracer_tpu_torch.kernels import sorted_wavefront as sw

    def run():
        marks, segs = [], []

        def step(ctx, state, lists, seg, mode, dst):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sw._bounce_step(ctx, state, lists, seg, mode, dst)
            b.record()
            marks.append((a, b))
            segs.append(seg.clone())

        queue_behind_spin()
        sw._render_sorted_stats(step, tb, nf, ni, cfg, TIME_START, SORTED_CALL_SPP,
                                selfcheck.SORTED_LEAF, sort)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in marks]
        total = [int(x) for x in segs]
        return sum(ms), ms, [n - m for n, m in zip(total, [0] + total[:-1])]

    run()
    runs = sorted((run() for _ in range(3)), key=lambda r: r[0])
    ms, by_launch, traced = runs[1]
    return {"ms": ms, "ms_by_launch": by_launch, "traced_by_launch": traced}


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

    from oclpathtracer_tpu_torch import bench_train
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.diff import fast, inverse

    cornell = tables.scene("cornell")
    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=4)
    segs = bench_train.segments_per_window(cornell, cfg, TRAIN_SPP)
    target = torch.zeros((cfg.n_pixels, 3), device="cuda")
    kstep = fast.make_kernel_train_step(cornell, cfg, TRAIN_SPP, lr=1e-3)
    variants = (("kernel", kstep, fast.extract_class_params(cornell), 4, 7),
                ("hybrid", bench_train.hybrid_step(cornell, cfg, TRAIN_SPP),
                 inverse.extract_params(cornell, albedo=True, emissive=True), 4, 3),
                ("twin", bench_train.twin_step(cornell, cfg, TRAIN_SPP),
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


def finite_numbers(line: dict, skip=("metric", "unit")) -> bool:
    return all(isinstance(v, float) and np.isfinite(v) for k, v in line.items()
               if k not in skip)


def phase_bench(card: str):
    """The slice's entry points, with every launch counter set to 0 first: `python -m
    oclpathtracer_tpu_torch bench` (cli.main) and bench_train.main at their shapes,
    then the native scene parse on the card's path and the compile listener."""
    import collections

    import torch

    from oclpathtracer_tpu_torch import bench_train, cli
    from oclpathtracer_tpu_torch.kernels import cuda_build
    from oclpathtracer_tpu_torch.runtime import native
    from oclpathtracer_tpu_torch.scene import loader

    reset_counts()
    rc, lines = captured("bench", cli.main, ["bench"])
    require(rc == 0 and lines, f"bench: exit {rc}")
    line = json.loads(lines[-1])
    require(tuple(line) == BENCH_KEYS, f"bench: keys {tuple(line)}")
    require(finite_numbers(line) and all(line[k] > 0 for k in BENCH_KEYS[1:] if k != "unit"),
            f"bench: a rate or ratio is not finite and > 0: {line}")
    log(f"[bench] {card}: {json.dumps(line)}")
    _, out = captured("bench_train", bench_train.main)
    train_lines = [json.loads(x) for x in out]
    require([x["metric"] for x in train_lines] == list(BENCH_TRAIN_METRICS),
            f"bench_train: metrics {[x['metric'] for x in train_lines]}")
    require(all(finite_numbers(x) for x in train_lines), f"bench_train: {train_lines}")
    counts = read_counts()
    log(f"[bench] launches {counts}")
    idle = [k for k in BENCH_KERNELS if counts[k] == 0]
    require(not idle, f"bench path: kernels never launched: {idle}")

    calls = []
    parse = native.parse_mesh_file
    native.parse_mesh_file = lambda path: calls.append(path) or parse(path)
    try:
        scene = loader.load_cornell_box(device="cuda")
    finally:
        native.parse_mesh_file = parse
    require(calls == [loader.DEFAULT_SCENE_PATH], f"load_cornell_box: native parses {calls}")
    python = loader.build_scene(loader.parse_mesh_file(loader.DEFAULT_SCENE_PATH), "cuda")
    require(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                for part, ppart in zip(scene, python) for x, y in zip(part, ppart)),
            "load_cornell_box: the native parse's Scene is not the Python parse's bit for bit")
    built = {"compile/nvcc": cuda_build.load_library()[1].built,
             "compile/g++": native.load_library()[1].built}
    fired = collections.Counter(event for event, _ in COMPILE_EVENTS)
    log(f"[bench] native scene parse on the card: bit for bit the Python parse's; compile "
        f"events {COMPILE_EVENTS}, built in this process {built}")
    require(fired == collections.Counter(e for e, b in built.items() if b),
            f"compile listener: fired {dict(fired)}, built {built}")
    return counts, {"bench": line, "bench_train": train_lines}


def card_mesh(n: int):
    from oclpathtracer_tpu_torch.parallel.mesh import Mesh

    return Mesh(("cuda:0",) * n)


def adjoint_calls(fn, *args):
    """fn(*args) with every call of the adjoint wrapper recorded: (fn's result, [(with
    grads, (img, grads)), ...] in call order)."""
    from oclpathtracer_tpu_torch.kernels import grad_megakernel as gk

    calls, real = [], gk.render_grads_pallas

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append((kw.get("with_grads", True), out))
        return out

    gk.render_grads_pallas = spy
    try:
        return fn(*args), calls
    finally:
        gk.render_grads_pallas = real


def pair_terms(calls):
    """A kernel step's recorded adjoint calls → (a, b, g): each entry makes two
    forwards then two adjoint launches; the images concatenate in mesh order and the
    gradients add in mesh order, as the step adds them."""
    import torch

    fwd = [out[0] for grads, out in calls if not grads]
    adj = [out[1] for grads, out in calls if grads]
    g = None
    for ga, gb in zip(adj[0::2], adj[1::2]):
        g = ga + gb if g is None else g + (ga + gb)
    return torch.cat(fwd[0::2]), torch.cat(fwd[1::2]), g


def phase_sharded(tables):
    """The distribution layer on the card (parallel/, the sharded train steps, the dry
    run, bench_scaling), every mesh n × cuda:0. Each sharded call runs with the
    counts set to 0 just before it and read just after, into this path's window; the
    single calls it is held against are not counted. Returns (counts, timing rows)."""
    import torch

    from oclpathtracer_tpu_torch import bench_scaling
    from oclpathtracer_tpu_torch.config import RenderConfig
    from oclpathtracer_tpu_torch.core import rng
    from oclpathtracer_tpu_torch.diff import fast, inverse, make_sharded_train_step
    from oclpathtracer_tpu_torch.examples import train_kernel
    from oclpathtracer_tpu_torch.kernels import megakernel as mk
    from oclpathtracer_tpu_torch.kernels import wavefront as wf
    from oclpathtracer_tpu_torch.kernels.selfcheck import compare_grads
    from oclpathtracer_tpu_torch.parallel import render_progressive_sharded, shard_pixels
    from oclpathtracer_tpu_torch.parallel.dryrun import dryrun_multichip
    from oclpathtracer_tpu_torch.parallel.sharded_pallas import (
        make_sharded_kernel_step,
        render_pallas_sharded,
    )
    from oclpathtracer_tpu_torch.render.driver import render_progressive

    cornell = tables.scene("cornell")
    window = {name: 0 for name in COUNTERS}

    def counted(fn, *args):
        reset_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        for name, n in read_counts().items():
            window[name] += n
        return out

    scan, table, emi, classes = mk.prepare_scan(cornell, "auto")
    kw = dict(scan=scan, emi_const=emi, classes=classes)
    b4, b16 = (RenderConfig(FULL_SIZE, FULL_SIZE, bounces=n) for n in (4, 16))
    one = mk.render_samples_pallas_stats(table, b4, 0, MAIN_STEP, **kw)
    for n in SHARD_MESHES:
        step = make_sharded_kernel_step(b4, card_mesh(n), MAIN_STEP, **kw)
        img, segs = counted(step, table, 0)
        log(f"[sharded] megakernel {scan} {FULL_SIZE}² b4 {MAIN_STEP}spp on {n} x cuda:0: "
            f"bit for bit one call {torch.equal(img, one[0])}, segments {int(segs)} "
            f"({int(one[1])} in one call)")
        require(torch.equal(img, one[0]) and int(segs) == int(one[1]),
                f"sharded megakernel on {n} entries: not the single call's bits")
    one16 = wf.render_samples_wavefront_stats(table, b16, 0, MAIN_STEP, **kw)
    for n in SHARD_WAVEFRONT_MESHES:
        step = make_sharded_kernel_step(b16, card_mesh(n), MAIN_STEP, kernel="wavefront", **kw)
        img, segs = counted(step, table, 0)
        log(f"[sharded] wavefront {scan} {FULL_SIZE}² b16 {MAIN_STEP}spp on {n} x cuda:0: "
            f"bit for bit one call {torch.equal(img, one16[0])}, segments {int(segs)}")
        require(torch.equal(img, one16[0]) and int(segs) == int(one16[1]),
                f"sharded wavefront on {n} entries: not the single call's bits")
    total, per_call = SHARD_TRAILING
    img = counted(render_pallas_sharded, cornell, b4, card_mesh(8), total, per_call)
    want = mk.render_pallas(cornell, b4, total, samples_per_call=per_call)
    log(f"[sharded] render_pallas_sharded {FULL_SIZE}² b4 {total}spp in calls of {per_call} on 8 "
        f"entries: bit for bit render_pallas {torch.equal(img, want)}")
    require(torch.equal(img, want), "render_pallas_sharded: the short trailing chunk")

    for w, h, spp in ((SHARD_TWIN_SIZE, SHARD_TWIN_SIZE, 4), (33, 9, 2)):
        cfg = RenderConfig(w, h, bounces=2)
        img = counted(render_progressive_sharded, cornell, cfg, card_mesh(8), spp, spp)
        want = render_progressive(cornell, cfg, spp, samples_per_step=spp)
        log(f"[sharded] render_progressive_sharded {w}x{h} b2 {spp}spp on 8 entries: bit for "
            f"bit render_progressive(backend='jnp') {torch.equal(img, want)}")
        require(img.shape == want.shape and torch.equal(img, want),
                f"sharded twin render {w}x{h}: not the single-device bits")

    # The kernel train step at bench_train's shape from the train_kernel example's
    # start, SHARD_TRAIN_STEPS steps on 8 entries; at each step's params the 1-entry
    # step and make_kernel_train_step run too. Forwards bit for bit, loss rtol 1e-6,
    # gradients by phase 3's adjoint rule, params within lr × that rule.
    cfg = RenderConfig(TRAIN_SIZE, TRAIN_SIZE, bounces=4)
    target = train_kernel.target_image(cornell, cfg, TARGET_SPP)
    start = train_kernel.perturbed(fast.extract_class_params(cornell))
    steps = {n: fast.make_sharded_kernel_train_step(cornell, cfg, card_mesh(n), TRAIN_SPP,
                                                    SHARD_LR) for n in (8, 1)}
    single = fast.make_kernel_train_step(cornell, cfg, TRAIN_SPP, SHARD_LR)

    def chain():
        params, out = start, []
        for i in range(SHARD_TRAIN_STEPS):
            (new, loss), calls = adjoint_calls(steps[8], params, target, i)
            out.append((params, new, loss, pair_terms(calls)))
            params = new
        return out

    run = counted(chain)
    for i, (params, new, loss, (a, b, g)) in enumerate(run):
        for name, fn in (("1 entry", steps[1]), ("make_kernel_train_step", single)):
            if name == "1 entry":
                (new_o, loss_o), calls = counted(adjoint_calls, fn, params, target, i)
            else:
                (new_o, loss_o), calls = adjoint_calls(fn, params, target, i)
            a_o, b_o, g_o = pair_terms(calls)
            grads = compare_grads((a, g, 0), (a_o, g_o, 0))
            bound = float((1e-4 * g_o.abs().amax(dim=1) + 1e-6 * g_o.abs().max()).max())
            dp = max(float((x - y).abs().max()) for x, y in zip(new, new_o))
            rel = abs(float(loss) / float(loss_o) - 1.0)
            log(f"[sharded] kernel step {i} 8 entries vs {name}: forwards bit for bit "
                f"{grads['image_bitwise'] and torch.equal(b, b_o)}, loss {float(loss):.9f} "
                f"vs {float(loss_o):.9f} (rel {rel:.2e}), gradient worst row "
                f"{grads['grad_worst_row']:.4f} of the rule, params max |d| {dp:.3e}")
            require(grads["image_bitwise"] and torch.equal(b, b_o),
                    f"sharded kernel step {i}: forwards not bit for bit ({name})")
            require(rel <= 1e-6, f"sharded kernel step {i}: loss off {name}'s by {rel}")
            require(grads["ok"],
                    f"sharded kernel step {i}: gradients off {name}'s: {grads}")
            require(dp <= SHARD_LR * bound * 1.01 + 1e-6,
                    f"sharded kernel step {i}: params off {name}'s by {dp}")
    again = counted(chain)
    same = all(torch.equal(x[2], y[2]) and all(torch.equal(p, q) for p, q in zip(x[1], y[1]))
               for x, y in zip(run, again))
    log(f"[sharded] kernel step rerun on 8 entries: bit for bit {same}; losses "
        f"{[round(float(x[2]), 6) for x in run]}")
    require(same, "sharded kernel step: a rerun moved a bit")

    cfg = RenderConfig(SHARD_TWIN_SIZE, SHARD_TWIN_SIZE, bounces=2)
    key = rng.make_key(0, "cuda")
    target = render_progressive(cornell, cfg, 2, samples_per_step=2)
    twin = {}
    for n in (8, 1):
        step = make_sharded_train_step(cornell, cfg, card_mesh(n), spp=2, lr=1e-2)
        params, losses = inverse.extract_params(cornell, albedo=True, emissive=True), []
        for i in range(2):
            params, loss = counted(step, params, target, shard_pixels(cfg, card_mesh(n)), i, key)
            losses.append(float(loss))
        twin[n] = (losses, params)
    ok = (np.allclose(twin[8][0], twin[1][0], rtol=1e-5, atol=0)
          and all(torch.allclose(x, y, rtol=1e-5, atol=1e-7) for x, y in
                  zip(inverse.params_leaves(twin[8][1]), inverse.params_leaves(twin[1][1]))))
    log(f"[sharded] make_sharded_train_step {SHARD_TWIN_SIZE}x{SHARD_TWIN_SIZE} b2 2spp, 2 "
        f"steps: 8 entries losses {twin[8][0]}, 1 entry {twin[1][0]}; within rtol 1e-5 {ok}")
    require(ok, "sharded twin train step: 8 entries off 1 entry")

    _, lines = counted(captured, "dryrun", dryrun_multichip, 8)
    require(len(lines) == 1 and lines[0].startswith("dryrun_multichip(8): ok, "),
            f"dryrun_multichip(8): {lines}")
    rc, lines = counted(captured, "bench_scaling", bench_scaling.main, [])
    rows = [json.loads(x) for x in lines]
    require(rc == 0 and [r["devices"] for r in rows] == [1]
            and finite_numbers(rows[0], skip=("devices",)),
            f"bench_scaling: exit {rc}, lines {lines}")

    log(f"[sharded] launches {window}")
    idle = [k for k in SHARDED_KERNELS if window[k] == 0]
    require(not idle, f"sharded path: kernels never launched: {idle}")

    timing = []
    calls = {"one call": lambda: mk.render_samples_pallas_stats(table, b4, TIME_START,
                                                                MAIN_STEP, **kw)}
    for n in (1, 8):
        step = make_sharded_kernel_step(b4, card_mesh(n), MAIN_STEP, **kw)
        calls[f"{n} entries"] = functools.partial(step, table, TIME_START)
    for name, fn in calls.items():
        ms, (_, segs) = cuda_time_ms(fn, fn)
        timing.append({"name": f"megakernel {scan} {FULL_SIZE}² b4 {MAIN_STEP}spp, {name}",
                       "ms": ms, "segments": int(segs), "mrays_per_s": int(segs) / (ms * 1e3)})
        log(f"[sharded] time {timing[-1]['name']}: {ms:.3f} ms, "
            f"{timing[-1]['mrays_per_s']:.1f} Mrays/s")
    return window, timing


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


def kernel_bounds(tables, main_rows) -> dict:
    """name → (bound_ms, "operations" | "bytes") of each kernel at its timed shape
    (kernels/bounds.py), from the segments of this run and, for the BVH walks, the
    boxes and leaf triangles per segment that their plain versions tested."""
    import torch

    from oclpathtracer_tpu_torch.kernels import bounds

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    table, _, classes = tables.linear("cornell", "tp")
    n_tris, n_cls = table.shape[0], len(classes)
    out = {}
    r = main_rows["megakernel"]  # tp with the tp0 peel, 512² b4
    n = 512 * 512
    out["megakernel"] = bounds.bound_ms(  # the tp0 table in, the image out
        bounds.linear_ops("tp", n_tris, r["segments"], paths=n * r["spp"], tp0=True,
                          n_classes=n_cls), nbytes(table) + 12 * n)
    r = main_rows["wavefront"]
    out["wavefront"] = bounds.bound_ms(bounds.linear_ops("tp", n_tris, r["segments"],
                                                         n_classes=n_cls),
                                       nbytes(table) + 16 * n)
    for name, key in (("bvh_megakernel", "bvh"), ("wide_bvh", "wide")):
        for suffix, scene, leaf in (("", "spheres5k", 32), ("_102k", "spheres102k", 64)):
            r = main_rows[name + suffix]
            per_seg = r["segments"] / r["plain_segments"]
            packed = getattr(tables, key)(scene, "fast", leaf)
            out[name + suffix] = bounds.bound_ms(  # the tables in, the image and counter out
                bounds.bvh_ops("fast", r["walk"]["boxes"] * per_seg, r["walk"]["tris"] * per_seg,
                               r["segments"]),
                nbytes(*(t for t in packed if isinstance(t, torch.Tensor))) + 12 * n + 8)
    n = TRAIN_SIZE * TRAIN_SIZE
    gtable, ct, _, _ = tables.grad("cornell")
    r = main_rows["grad_megakernel"]  # the tables and weight in, image, counter, grads out
    out["grad_megakernel"] = bounds.bound_ms(
        bounds.linear_ops("tp", n_tris, r["segments"], n_classes=n_cls)
        + bounds.adjoint_ops(n_cls, r["segments"]),
        nbytes(gtable, ct) + n * (12 + 12) + 8 + n_cls * 6 * 4)
    r = main_rows["grad_megakernel_forward"]  # the tables in, the image and counter out
    out["grad_megakernel_forward"] = bounds.bound_ms(
        bounds.linear_ops("tp", n_tris, r["segments"], n_classes=n_cls),
        nbytes(gtable, ct) + n * 12 + 8)
    r = main_rows["trace_rays"]
    ptable, _, _ = tables.linear("cornell", "parity")
    out["trace_rays"] = bounds.bound_ms(bounds.linear_ops("parity", n_tris, r["segments"]),
                                        nbytes(ptable) + r["rows"] * (24 + 12))
    for kind in ("ao", "direct"):
        r = main_rows[kind]
        lights = tables.lights("cornell")[0]
        out[kind] = bounds.bound_ms(
            bounds.fast_ops(kind, r["counts"], lights.shape[0]),
            nbytes(ptable) + (nbytes(lights) if kind == "direct" else 0)
            + 12 * FULL_SIZE * FULL_SIZE)
    r = main_rows["sorted_bounce"]
    per_seg = r["segments"] / r["plain_segments"]
    tb, nf, ni, _, _ = tables.bvh("spheres5k", "parity", 32)
    out["sorted_bounce"] = bounds.bound_ms(
        bounds.bvh_ops("parity", r["walk"]["boxes"] * per_seg, r["walk"]["tris"] * per_seg,
                       r["segments"]) + r["rays"] * bounds.CAMERA_OPS,
        nbytes(tb, nf, ni) + bounds.RAY_STATE_BYTES * (2 * r["segments"] - r["rays"]))
    r = main_rows["gather_grad"]  # idx (int32) and grad (N, C) in, the (M, C) table out
    m, c = r["table"]
    out["gather_grad"] = bounds.bound_ms(0.0, r["rows"] * (4 + 4 * c) + m * c * 4)
    for name, (ms, by) in out.items():
        log(f"[bound] {name}: {ms:.4f} ms ({by}); kernel {main_rows[name]['ms']:.3f} ms, "
            f"roofline share {ms / main_rows[name]['ms']:.3f}")
    return out


def main() -> int:
    import torch

    card = phase_device()
    t0 = time.perf_counter()
    from oclpathtracer_tpu_torch.runtime import cache

    cache.register_compile_listener(lambda event, secs: COMPILE_EVENTS.append((event, secs)))
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
    vertex_launches = phase_vertex(tables)
    log(f"[done] vertex path at {time.perf_counter() - t0:.1f} s")
    integrator_launches = phase_integrators(tables)
    log(f"[done] integrator path at {time.perf_counter() - t0:.1f} s")
    rows = phase_timing(tables)
    grad_rows = phase_grad_timing(tables)
    gather_row = phase_gather_grad_timing(tables)
    train_rows = phase_train_timing(tables)
    rays_row = phase_trace_rays_timing(tables)
    vertex_launch_rows = phase_vertex_launch_timing(tables)
    vertex_rows = phase_vertex_timing(tables)
    fast_rows = phase_fast_timing(tables)
    sorted_rows = phase_sorted_timing(tables)
    crossover = phase_crossover(tables)
    bench_launches, bench_rows = phase_bench(card)
    log(f"[done] bench path at {time.perf_counter() - t0:.1f} s")
    sharded_launches, sharded_rows = phase_sharded(tables)
    log(f"[done] sharded path at {time.perf_counter() - t0:.1f} s")
    by_name = {r["name"]: r for r in rows}
    # What the main path runs: the tp megakernel at 4 bounces, the tp wavefront at 16,
    # and sphere_field()'s fast BVH kernels.
    main_rows = {"megakernel": by_name["megakernel tp Cornell 512x512 b4"],
                 "wavefront": by_name["wavefront tp Cornell 512x512 b16"],
                 "bvh_megakernel": by_name["bvh fast leaf 32 spheres5k 512x512 b16"],
                 "wide_bvh": by_name["widebvh fast leaf 32 spheres5k 512x512 b16"],
                 "bvh_megakernel_102k": by_name["bvh fast leaf 64 spheres102k 512x512 b16"],
                 "wide_bvh_102k": by_name["widebvh fast leaf 64 spheres102k 512x512 b16"]}
    sources = {"megakernel": ("megakernel.cu", "oclpathtracer_tpu/kernels/megakernel.py:1052"),
               "wavefront": ("wavefront.cu", "oclpathtracer_tpu/kernels/wavefront.py:489"),
               "bvh_megakernel": ("bvh_megakernel.cu",
                                  "oclpathtracer_tpu/kernels/bvh_megakernel.py:746"),
               "wide_bvh": ("wide_bvh.cu", "oclpathtracer_tpu/kernels/wide_bvh.py:335")}
    adj, fwd = grad_rows["adjoint"], grad_rows["forward"]
    main_rows["grad_megakernel"] = {**adj, "max_abs_err": max(adj["max_abs_err"],
                                                              adj["grad_max_abs_err"]),
                                    "spp": TRAIN_SPP, "plain_spp": TRAIN_SPP,
                                    "forward_ms": fwd["ms"], "forward_plain_ms": fwd["plain_ms"]}
    main_rows["grad_megakernel_forward"] = fwd
    main_rows["trace_rays"] = rays_row
    sources["grad_megakernel"] = ("grad_megakernel.cu",
                                  "oclpathtracer_tpu/kernels/grad_megakernel.py:455")
    sources["trace_rays"] = ("trace_rays.cu", "oclpathtracer_tpu/kernels/megakernel.py:1139")
    main_rows.update(ao=fast_rows["ao"], direct=fast_rows["direct"],
                     sorted_bounce=sorted_rows["spheres5k"], gather_grad=gather_row)
    sources["ao"] = ("fast_integrators.cu", "oclpathtracer_tpu/kernels/fast_integrators.py:231")
    sources["direct"] = ("fast_integrators.cu",
                         "oclpathtracer_tpu/kernels/fast_integrators.py:351")
    sources["sorted_bounce"] = ("sorted_wavefront.cu",
                                "oclpathtracer_tpu/kernels/sorted_wavefront.py:154")
    sources["gather_grad"] = ("gather_grad.cu", None)  # the port's own: no TPU kernel
    bounds = kernel_bounds(tables, main_rows)
    # Each path is counted in its own window (counts set to 0 just before it):
    # `launches` sums the render, training, vertex, integrator, bench and sharded paths'
    # counts.
    paths = {"render": launches, "train": train_launches, "vertex": vertex_launches,
             "integrators": integrator_launches, "bench": bench_launches,
             "sharded": sharded_launches}
    kernels = []
    for name, (src, tpu) in sources.items():
        row = main_rows[name]
        second = {}  # each kernel's second shape
        if name + "_102k" in main_rows:  # the BVH kernels at sphere_field(80, 3) too
            second = {"ms_102k": main_rows[name + "_102k"]["ms"],
                       "bound_ms_102k": bounds[name + "_102k"][0]}
        if name == "grad_megakernel":  # the forward-only launch too
            second = {"forward_bound_ms": bounds["grad_megakernel_forward"][0],
                      "forward_bound_by": bounds["grad_megakernel_forward"][1]}
        if name in vertex_launch_rows:  # the vertex recovery step's launches too
            v = vertex_launch_rows[name]
            second = {"ms_vertex_step": v["ms"], "plain_ms_vertex_step": v["plain_ms"],
                       "bound_ms_vertex_step": v["bound_ms"],
                       "launches_vertex_step": len(v["launches"])}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"oclpathtracer_tpu_torch/kernels/csrc/{src}", "replaces": tpu,
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {path: c[name] for path, c in paths.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": row.get("library_ms"),
            **{k: row[k] for k in ("spp", "plain_spp", "forward_ms", "forward_plain_ms", "rows",
                                    "ms_by_lanes") if k in row}, **second})
    log(f"[done] {card}; all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)  # nvidia-smi's name and power limit, as it gives them
    print(json.dumps({"timing": rows, "grad_timing": grad_rows, "train_timing": train_rows,
                      "gather_grad_timing": gather_row,
                      "trace_rays_timing": rays_row, "vertex_launch_timing": vertex_launch_rows,
                      "vertex_timing": vertex_rows,
                      "fast_timing": fast_rows, "sorted_timing": sorted_rows,
                      "crossover": crossover, "bench": bench_rows,
                      "sharded": sharded_rows}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
